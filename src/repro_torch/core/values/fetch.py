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

Eligible batches plan through the ``run_coalesce`` kernel
(``core/accel.py``): one device sort/dedup/run-mark pass over the whole
(file-rank, position) column in first-occurrence file order, replacing the
per-file ``np.unique`` + ``np.split`` below with identical output.
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
    fsel, ksel, vsel = fids[ok], keys[ok], vids[ok]
    uniq, first = np.unique(fsel, return_index=True)
    order = uniq[np.argsort(first)]                 # first-occurrence order
    window = store.cfg.coalesce_window
    pos_per_file = []
    # one ``find`` per unique vSST — structure-bounded  # scavlint: allow-loop
    for fid in order.tolist():
        t = store.version.value_files[fid]
        m = fsel == fid
        pos = accel.table_find(store, t, ksel[m])
        if pos is None:
            pos = t.find(ksel[m])
        if strict:
            assert (pos >= 0).all() and (t.vids[pos] == vsel[m]).all(), \
                "stale locator"
        else:
            pos = pos[pos >= 0]
        pos_per_file.append(pos)
    cat_rank = np.repeat(np.arange(len(order)),
                         [len(p) for p in pos_per_file])
    cat_pos = (np.concatenate(pos_per_file) if pos_per_file
               else np.zeros(0, np.int64))
    plan = accel.plan_runs(store, cat_rank, cat_pos)
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
