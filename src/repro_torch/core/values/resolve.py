"""Inheritance-chain resolution (TerarkDB/Scavenger no-writeback GC,
paper §II-B; DESIGN.md §7).

The index LSM-tree's ``<key, file_number>`` locators stay stable across GC:
a GC output file *inherits* from every candidate it merged (``GCGroup``),
and reads resolve the live head by walking the chain.  Resolution is pure
metadata — no I/O is charged here.
"""

from __future__ import annotations

import numpy as np

from ..engine.tables import SSTable

# hop bound on chain walks — a safety net against metadata corruption, not
# a tunable: real chains are at most a few GC generations deep
_CHAIN_HOP_CAP = 10_000


class GCGroup:
    """Inheritance target: the set of output files of one GC run."""

    __slots__ = ("files",)

    def __init__(self, files: list[SSTable]):
        self.files = files

    def locate_batch(self, keys: np.ndarray, vids: np.ndarray) -> np.ndarray:
        """Vectorized locate: fid of the group file holding each (key, vid),
        -1 where no file does.  One ``find`` per file for the whole column
        (files win in list order, matching the scalar walk)."""
        keys = np.asarray(keys, np.uint64)
        vids = np.asarray(vids, np.uint64)
        out = np.full(len(keys), -1, np.int64)
        unresolved = np.ones(len(keys), bool)
        for t in self.files:
            if not unresolved.any():
                break
            rows = np.nonzero(unresolved)[0]
            pos = t.find(keys[rows])
            ok = pos >= 0
            safe = np.where(ok, pos, 0)
            ok &= t.vids[safe] == vids[rows]
            hit = rows[ok]
            out[hit] = t.fid
            unresolved[hit] = False
        return out


def compress_group(store, g: GCGroup) -> GCGroup:
    """Amortized path compression: splice retired members' successor files
    into the group in place.

    A (key, vid) found in a retired member lives in exactly one file of
    that member's own group (or was dropped), so replacing the retired
    member by its successors — and dropping dead ends — preserves every
    resolution result while bounding chain depth to ~1 hop amortized.
    Pure metadata: no I/O is charged, so accounting is unchanged.

    INVARIANT (required for correctness, upheld by the GC skeleton and
    asserted differentially by tests/test_engines_registry.py's
    compress-vs-reference walk): a (key, vid) record is physically present
    in at most one *live* vSST, and files are retired only inside
    ``gc_finalize`` after their GC outputs are registered in
    ``version.value_files`` and ``store.chains``.  A custom engine strategy
    whose ``gc_finalize`` retires candidates before registering outputs
    would break resolution with or without compression."""
    live = store.version.value_files
    if all(t.fid in live for t in g.files):
        return g
    out: list[SSTable] = []
    seen: set[int] = set()
    stack = list(g.files)
    while stack:
        t = stack.pop(0)
        if t.fid in seen:
            continue
        seen.add(t.fid)
        if t.fid in live:
            out.append(t)
        else:
            g2 = store.chains.get(t.fid)
            if g2 is not None:                  # else: dead end, drop
                stack = list(g2.files) + stack
    g.files = out
    return g


def resolve_value_fids(store, vfiles: np.ndarray, keys: np.ndarray,
                       vids: np.ndarray) -> np.ndarray:
    """Vectorized chain-head resolution: follow inheritance chains for a
    whole locator column, one grouped ``locate_batch`` per chain hop
    instead of a Python per-record walk.  Returns the live fid per row, -1
    where the record was already dropped by a GC."""
    cur = np.asarray(vfiles, np.int64).copy()
    keys = np.asarray(keys, np.uint64)
    vids = np.asarray(vids, np.uint64)
    n = len(cur)
    out = np.full(n, -1, np.int64)
    active = np.ones(n, bool)
    # live-set snapshot is safe: resolution is pure metadata, no file is
    # added or retired while chains are walked
    live = store.version.value_files
    live_fids = np.fromiter(live.keys(), np.int64, count=len(live))
    for _ in range(_CHAIN_HOP_CAP):
        rows = np.nonzero(active)[0]
        if len(rows) == 0:
            return out
        at_live = np.isin(cur[rows], live_fids)
        out[rows[at_live]] = cur[rows[at_live]]
        active[rows[at_live]] = False
        rows = rows[~at_live]
        if len(rows) == 0:
            return out
        for f in np.unique(cur[rows]).tolist():
            grp = rows[cur[rows] == f]
            g = store.chains.get(int(f))
            if g is None:
                active[grp] = False         # file gone, no inheritor
                continue
            nxt = compress_group(store, g).locate_batch(keys[grp],
                                                        vids[grp])
            dead = nxt < 0
            active[grp[dead]] = False       # dropped during that GC
            cur[grp[~dead]] = nxt[~dead]
    raise RuntimeError("inheritance chain cycle")


def resolve_value_file(store, fid: int, key: int, vid: int) -> SSTable | None:
    """Scalar shim: the live vSST holding (key, vid), or None."""
    head = int(resolve_value_fids(store, np.array([fid], np.int64),
                                  np.array([key], np.uint64),
                                  np.array([vid], np.uint64))[0])
    if head < 0:
        return None
    return store.version.value_files.get(head)
