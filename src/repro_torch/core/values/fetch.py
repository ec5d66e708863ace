"""Coalesced value fetch planning for multi_get / scans (paper §III-B.1;
DESIGN.md §7).

Vectorized planning: one inheritance-chain resolution pass for the whole
locator column, one ``find`` per touched vSST (not per record), record
fetches coalesced into adjacent-position runs — one random I/O per run,
optionally capped at ``EngineConfig.coalesce_window`` records per run.
Per-record *state* (cache residency, LRU order) is inherently per-entry
and is handled by the cache layer's batched probe
(``BlockCache.probe_records``) — that loop is the one per-record step the
byte-parity contract keeps.

The keys are grouped by vSST once; eligible batches find their records
in every touched vSST with one routed call (``accel.table_find_segments``:
one ``rank_probe`` launch over all of them, which also brings back the
vids the locator check compares) in place of the per-file host loop, and
plan through the ``run_coalesce`` kernel (``core/accel.py``):
one device sort/dedup/run-mark pass over the whole (file-rank, position)
column in first-occurrence file order, replacing the per-file
``np.unique`` + ``np.split`` below with identical output.
"""

from __future__ import annotations

import numpy as np

from .. import accel
from ..engine.cache import BlockCache
from .resolve import resolve_value_fids


def split_runs(posu: np.ndarray, window: int | None) -> list[np.ndarray]:
    """Adjacent-position runs of a sorted unique position column, each
    capped at ``window`` records when set (the host-side planner the
    ``run_coalesce`` kernel mirrors)."""
    runs = np.split(posu, np.nonzero(np.diff(posu) != 1)[0] + 1)
    if window:
        runs = [c for r in runs
                for c in np.split(r, np.arange(window, len(r), window))]
    return runs


def find_records(store, fsel, ksel, vsel, strict: bool):
    """Every touched vSST's ``find``, the keys grouped by vSST once.

    The vSSTs come in first-occurrence order of ``fsel`` and each vSST's
    keys in their order in ``ksel`` (a stable argsort of each key's vSST
    rank: the order ``ksel[fsel == fid]`` gives).  Eligible batches find
    them in one routed call (``accel.table_find_segments``), which also
    brings back the vids the strict locator check compares; otherwise a
    ``find`` a vSST on the host.  Checks the locators (``strict``), or
    drops the keys not found.  -> (order: the vSSTs' fids, cat_rank,
    cat_pos: each record's vSST rank and position, vSST after vSST)."""
    uniq, first, inv = np.unique(fsel, return_index=True,
                                 return_inverse=True)
    by_first = np.argsort(first)
    order = uniq[by_first]                          # first-occurrence order
    rank = np.empty(len(uniq), np.int64)
    rank[by_first] = np.arange(len(uniq))
    seg = rank[inv.reshape(-1)]                     # each key's vSST rank
    perm = np.argsort(seg, kind="stable")
    counts = np.bincount(seg, minlength=len(order))
    starts = np.cumsum(counts) - counts
    kg, vg = ksel[perm], vsel[perm]
    tables = [store.version.value_files[fid] for fid in order.tolist()]
    found = accel.table_find_segments(store, tables, kg, starts, counts)
    if found is None:
        got = []
        # a ``find`` a vSST — structure-bounded  # scavlint: allow-loop
        for t, a, c in zip(tables, starts.tolist(), counts.tolist()):
            pos = t.find(kg[a:a + c])
            if strict:
                assert (pos >= 0).all() and \
                    (t.vids[pos] == vg[a:a + c]).all(), "stale locator"
            got.append(pos)
        pos = np.concatenate(got)
    else:
        pos, vids = found
        if strict:
            assert (pos >= 0).all() and (vids == vg).all(), "stale locator"
    cat_rank = seg[perm]
    if strict:
        return order, cat_rank, pos
    hit = pos >= 0
    return order, cat_rank[hit], pos[hit]


def read_values_batch(store, keys, vids, vfiles, vsizes, cat,
                      strict: bool = False) -> None:
    """Charge the I/O for fetching value records of resolved entries.

    ``strict`` (multi_get): every entry won a newest-wins lookup, so an
    unresolvable file or vid mismatch means GC dropped live data.  Scans
    stay lenient: a truncated scan pass can surface a superseded REF whose
    record GC already reclaimed — the scan retry loop re-runs it with a
    larger limit."""
    n = len(keys)
    if n == 0:
        return
    keys = np.asarray(keys, np.uint64)
    vids = np.asarray(vids, np.uint64)
    fids = resolve_value_fids(store, vfiles, keys, vids)
    if strict:
        assert (fids >= 0).all(), "value file for live key lost"
    ok = fids >= 0
    if not ok.any():
        return
    order, cat_rank, cat_pos = find_records(store, fids[ok], keys[ok],
                                            vids[ok], strict)
    window = store.cfg.coalesce_window
    plan = accel.plan_runs(store, cat_rank, cat_pos)
    if plan is None:
        pos_per_file = np.split(cat_pos, np.searchsorted(
            cat_rank, np.arange(1, len(order))))
    # one vSST per unique fid — structure-bounded  # scavlint: allow-loop
    for i, fid in enumerate(order.tolist()):        # first-occurrence order
        t = store.version.value_files[fid]
        if plan is None:
            posu = np.unique(pos_per_file[i])
            starts = None
        else:
            r_s, p_s, keep, start = plan
            sel = keep & (r_s == i)
            posu = p_s[sel]
            starts = start[sel]
        if len(posu) == 0:
            continue
        if t.layout == "rtable":
            for b in np.unique(t.index_block_of[posu]).tolist():
                store.read_block(t, "ib", b, cat, BlockCache.PRI_HIGH,
                                 t.index_block_bytes())
            runs = (split_runs(posu, window) if starts is None
                    else np.split(posu, np.nonzero(starts)[0][1:]))
            for r in runs:
                rb = t.rec_bytes[r]
                hits = store.cache.probe_records(t.fid, "rec", r, rb,
                                                 BlockCache.PRI_LOW)
                nh = int(hits.sum())
                if nh:
                    store.io.cache_hit(cat, nh)
                nbytes = int(rb[~hits].sum())
                if nbytes:
                    store.io.rand_read(nbytes, cat)
        else:
            store.read_block(t, "i", 0, cat, BlockCache.PRI_HIGH,
                             t.index_block_bytes())
            blocks = t.block_of[posu]
            for b in np.unique(blocks).tolist():
                mm = posu[blocks == b]
                nb = max(int(t.rec_bytes[mm].max()),
                         t.data_block_bytes(0, b))
                store.read_block(t, "d0", b, cat, BlockCache.PRI_LOW, nb)
