"""Batched range-scan merge planning (DESIGN.md §7).

A scan merges key-sorted pools from every live source (memtable snapshots,
immutables, every level's overlapping files), newest-wins by (key, seq)
lexsort.  Per-source fetch limits adapt upward across retries: dead entries
(tombstones, superseded versions) may eat slots, requiring a refill.
"""

from __future__ import annotations

import numpy as np

from ..engine import io as sio
from .lookup import read_entry_blocks
from ..engine.tables import ETYPE_REF, ETYPE_TOMB
from ..values.fetch import read_values_batch


def scan_retry(store, start_key: int, count: int):
    """Retry wrapper: grow per-source limits until the result is complete."""
    limit = count
    for _ in range(store.cfg.scan_retry_rounds):
        out, min_excluded = scan_once(store, start_key, count, limit)
        complete = min_excluded is None or (
            len(out) >= count and out[-1][0] < min_excluded)
        if complete:
            return out
        limit *= store.cfg.scan_retry_growth
    return out


def scan_once(store, start_key: int, count: int, limit: int):
    cfg = store.cfg
    excluded = []       # first key beyond each truncated source
    pools = []
    start = np.uint64(max(0, start_key))
    for mt in [store.memtable] + store.immutables:
        mk, seqs, ety, vids, vsz, vf = mt.snapshot()
        a = int(np.searchsorted(mk, start))
        if a + limit < len(mk):
            excluded.append(int(mk[a + limit]))
        b = min(a + limit, len(mk))
        if a >= b:
            continue
        sel = slice(a, b)
        pools.append((None, mk[sel], seqs[sel], ety[sel], vids[sel],
                      vsz[sel], vf[sel], None))
    for lvl in range(cfg.max_levels):
        for t in store.version.levels[lvl]:
            a = int(np.searchsorted(t.keys, start))
            b = min(a + limit, t.n)
            if a + limit < t.n:
                excluded.append(int(t.keys[a + limit]))
            if a >= b:
                continue
            pos = np.arange(a, b, dtype=np.int64)
            pools.append((t, t.keys[pos], t.seqs[pos], t.etype[pos],
                          t.vids[pos], t.vsizes[pos], t.vfiles[pos], pos))
    min_excluded = min(excluded) if excluded else None
    if not pools:
        return [], min_excluded
    keys = np.concatenate([p[1] for p in pools])
    seqs = np.concatenate([p[2] for p in pools])
    ety = np.concatenate([p[3] for p in pools])
    vids = np.concatenate([p[4] for p in pools])
    vsz = np.concatenate([p[5] for p in pools])
    vf = np.concatenate([p[6] for p in pools])
    src = np.concatenate([np.full(len(p[1]), i, np.int64)
                          for i, p in enumerate(pools)])
    pos_all = np.concatenate([
        p[7] if p[7] is not None else np.full(len(p[1]), -1, np.int64)
        for p in pools])
    order = np.lexsort((np.iinfo(np.uint64).max - seqs, keys))
    keys, ety, vids, vsz, vf, src, pos_all = (
        a[order] for a in (keys, ety, vids, vsz, vf, src, pos_all))
    first = np.ones(len(keys), bool)
    first[1:] = keys[1:] != keys[:-1]
    live = first & (ety != ETYPE_TOMB)
    take = np.nonzero(live)[0][:count]

    # ---- I/O: data blocks for chosen rows, value fetches for refs ----
    for i_pool in np.unique(src[take]):
        p = pools[i_pool]
        if p[0] is None:
            continue
        t = p[0]
        rows = take[src[take] == i_pool]
        read_entry_blocks(store, t, pos_all[rows], ety[rows], sio.CAT_SCAN)
    ref_rows = take[ety[take] == ETYPE_REF]
    if len(ref_rows):
        read_values_batch(store, keys[ref_rows], vids[ref_rows],
                          vf[ref_rows], vsz[ref_rows], sio.CAT_SCAN)
    store.pump()
    return (list(zip(keys[take].tolist(), vids[take].tolist())),
            min_excluded)
