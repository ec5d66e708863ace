"""Vectorized point-lookup machinery (the read layer's hot path,
DESIGN.md §7).

``lookup_entries`` walks memtables -> L0 (newest first) -> L1..Ln for a
whole key column: batched columnar memtable probes (``Memtable.get_batch``),
one bloom/``find`` pass per touched SSTable, block-cache I/O accounting per
unique (stream, block) — no per-key Python anywhere on the path.

Eligible batches route through the fused ``lookup_probe`` kernel
(``core/accel.py``): the bloom bit test and the sorted-run membership/rank
run as one kernel launch for all L0 tables and one for each deeper level's
files (``accel.level_probe``; the level's row count decides routing), the
per-level file assignment as one more, byte-identical to the host path
below.
"""

from __future__ import annotations

import numpy as np

from .. import accel
from ..engine.cache import BlockCache
from ..engine.keys import BloomFilter, hash_family
from ..engine.tables import ETYPE_NONE, ETYPE_REF, SSTable


def read_block(store, t: SSTable, stream: str, block_id: int, cat: str,
               priority: int, nbytes: int | None = None) -> None:
    """Cache-aware block read: hit -> CPU cost only, miss -> random I/O."""
    ck = (t.fid, stream, int(block_id))
    if store.cache.get(ck):
        store.io.cache_hit(cat)
        return
    if nbytes is None:
        s = int(stream[1])
        nbytes = t.data_block_bytes(s, block_id)
    store.io.rand_read(int(nbytes), cat)
    store.cache.put(ck, int(nbytes), priority)


def read_entry_blocks(store, t: SSTable, pos: np.ndarray, ety: np.ndarray,
                      cat: str) -> None:
    """Charge data-block reads for entries at ``pos`` in kSST/vSST ``t``.

    DTable routes REF entries to (high-priority) KF blocks and inline
    records to KV blocks — the paper's GC-Lookup optimisation.

    The dtable dedup deliberately stays a *set* of (stream, block) pairs
    over the hit positions: its iteration order fixes the LRU insertion
    order of the touched blocks, which the pre-refactor parity goldens
    (tests/test_refactor_parity.py) lock in byte-for-byte."""
    if t.layout == "dtable":
        streams = np.where(ety == ETYPE_REF, 0, 1)
        for s, b in {(int(s), int(t.block_of[p]))
                     for s, p in zip(streams, pos)}:
            pri = BlockCache.PRI_HIGH if s == 0 else BlockCache.PRI_LOW
            read_block(store, t, f"d{s}", b, cat, pri,
                       t.data_block_bytes(s, b))
    else:
        for b in np.unique(t.block_of[pos]).tolist():
            read_block(store, t, "d0", b, cat, BlockCache.PRI_LOW,
                       t.data_block_bytes(0, b))


def lookup_entries(store, keys: np.ndarray, cat: str) -> dict:
    """Vectorized newest-wins point lookup for a batch of keys.

    Returns parallel arrays: found / etype / vid / vsize / vfile."""
    n = len(keys)
    out = {
        "found": np.zeros(n, bool),
        "etype": np.full(n, ETYPE_NONE, np.uint8),
        "vid": np.zeros(n, np.uint64),
        "vsize": np.zeros(n, np.int64),
        "vfile": np.full(n, -1, np.int64),
    }
    unresolved = np.ones(n, bool)

    # ---- memtables, newest first: batched columnar probes ----
    for mt in [store.memtable] + list(reversed(store.immutables)):
        if not unresolved.any():
            break
        rows = np.nonzero(unresolved)[0]
        probe = accel.memtable_probe(store, mt, keys[rows])
        found, _, ety, vids, vsz, vf = (probe if probe is not None
                                        else mt.get_batch(keys[rows]))
        if not found.any():
            continue
        hit = rows[found]
        out["found"][hit] = True
        out["etype"][hit] = ety[found]
        out["vid"][hit] = vids[found]
        out["vsize"][hit] = vsz[found]
        out["vfile"][hit] = vf[found]
        unresolved[hit] = False

    # raw bloom hashes depend only on the key column: hash once, reuse
    # against every probed table's filter
    kraw = hash_family(keys, BloomFilter.k_for(store.cfg.filter_bits_per_key))
    batch = accel.ProbeKeys(keys, kraw)

    def probe_file(t: SSTable, rows: np.ndarray, fused):
        """``fused``: the routed level probe's (may, pos) of these rows in
        ``t``, or None for the host path."""
        if fused is None:
            lookup_entries.host_table_probes += 1
            may = t.bloom.may_contain(keys[rows], raw=kraw[:, rows])
        else:
            may = fused[0]
        if not may.any():
            return
        rows = rows[may]
        read_block(store, t, "i", 0, cat, BlockCache.PRI_HIGH,
                   t.index_block_bytes())
        pos = t.find(keys[rows]) if fused is None else fused[1][may]
        hit = pos >= 0
        if hit.any():
            hrows, hpos = rows[hit], pos[hit]
            read_entry_blocks(store, t, hpos, t.etype[hpos], cat)
            out["found"][hrows] = True
            out["etype"][hrows] = t.etype[hpos]
            out["vid"][hrows] = t.vids[hpos]
            out["vsize"][hrows] = t.vsizes[hpos]
            out["vfile"][hrows] = t.vfiles[hpos]
            unresolved[hrows] = False

    # ---- L0, newest first: one level probe of every row still unresolved
    # against every table; a table's answer for a row does not depend on
    # the other tables, so the walk below reads the rows it reaches
    l0 = list(reversed(store.version.levels[0]))
    if l0 and unresolved.any():
        rows = np.nonzero(unresolved)[0]
        n = len(rows)
        fused = accel.level_probe(store, batch, l0, rows,
                                  np.zeros(len(l0), np.int64),
                                  np.full(len(l0), n, np.int64))
        for i, t in enumerate(l0):
            if not unresolved.any():
                break
            if fused is None:
                probe_file(t, np.nonzero(unresolved)[0], None)
                continue
            live = np.nonzero(unresolved[rows])[0]
            probe_file(t, rows[live], (fused[0][i * n + live],
                                       fused[1][i * n + live]))
    # ---- L1..Ln: the rows grouped by file (stable, ascending file index)
    # and probed in one level probe
    for lvl in range(1, store.cfg.max_levels):
        if not unresolved.any():
            break
        files = store.version.levels[lvl]
        if not files:
            continue
        rows = np.nonzero(unresolved)[0]
        fidx = accel.assign_files(store, lvl, keys[rows])
        if fidx is None:
            fidx = store.version.assign_files(lvl, keys[rows])
        inside = fidx >= 0
        order = np.argsort(fidx[inside], kind="stable")
        rows, fidx = rows[inside][order], fidx[inside][order]
        fis, starts, counts = np.unique(fidx, return_index=True,
                                        return_counts=True)
        fused = accel.level_probe(store, batch, [files[fi] for fi in fis],
                                  rows, starts, counts)
        for fi, a, c in zip(fis.tolist(), starts.tolist(), counts.tolist()):
            seg = slice(a, a + c)
            probe_file(files[fi], rows[seg], None if fused is None
                       else (fused[0][seg], fused[1][seg]))
    return out


# table probes that took the host path (the routed level probes aside)
lookup_entries.host_table_probes = 0
