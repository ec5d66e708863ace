"""Columnar last-write-wins stats oracle (DESIGN.md §7).

``LatestOracle`` tracks key -> (vid, vsize) for *measurement only* (space-
amplification denominators, hidden-garbage accounting) — never as an engine
decision input.  State is two key-sorted columnar runs — a large ``base``
and a small ``delta`` that absorbs writes (deletes as vid-0 tombstones) —
merged when the delta outgrows ~sqrt(base), the classic two-run LSM shape.
A whole WriteBatch applies in one vectorized pass over O(batch + delta)
elements (amortized, *not* O(total keys)), replacing the per-key dict loop
the monolithic store carried on its hottest write path while keeping every
lookup a pair of ``searchsorted`` calls.
"""

from __future__ import annotations

import numpy as np

_TOMB_VID = np.uint64(0)        # live vids start at 1 (Store.next_vid)

# delta-run compaction trigger: delta > max(_DELTA_MIN, sqrt(base) * 16)
_DELTA_MIN = 1024
_DELTA_SQRT_MULT = 16


def _probe(keys: np.ndarray, ks: np.ndarray) -> tuple:
    """found mask + safe gather positions of ``ks`` in sorted ``keys``."""
    pos = np.searchsorted(keys, ks)
    ok = pos < len(keys)
    safe = np.where(ok, pos, 0)
    if len(keys):
        ok &= keys[safe] == ks
    else:
        ok = np.zeros(len(ks), bool)
    return ok, safe


class LatestOracle:
    __slots__ = ("bkeys", "bvids", "bvsizes",
                 "dkeys", "dvids", "dvsizes", "valid_bytes")

    def __init__(self):
        self.bkeys = np.zeros(0, np.uint64)
        self.bvids = np.zeros(0, np.uint64)
        self.bvsizes = np.zeros(0, np.int64)
        self.dkeys = np.zeros(0, np.uint64)
        self.dvids = np.zeros(0, np.uint64)
        self.dvsizes = np.zeros(0, np.int64)
        self.valid_bytes = 0        # sum of live value sizes

    def __len__(self) -> int:
        live_delta = int((self.dvids != _TOMB_VID).sum())
        in_base, _ = _probe(self.bkeys, self.dkeys)
        return len(self.bkeys) - int(in_base.sum()) + live_delta

    # ------------------------------------------------------------- lookups
    def lookup_batch(self, keys: np.ndarray) -> tuple:
        """Vectorized lookup: (found, vids, vsizes) parallel arrays (zeros
        where not found).  Delta wins over base; tombstones are misses."""
        ks = np.asarray(keys, np.uint64)
        in_d, dsafe = _probe(self.dkeys, ks)
        in_b, bsafe = _probe(self.bkeys, ks)
        use_b = in_b & ~in_d
        vids = np.zeros(len(ks), np.uint64)
        vsz = np.zeros(len(ks), np.int64)
        if len(self.dkeys):
            use_d = in_d & (self.dvids[dsafe] != _TOMB_VID)
            vids[use_d] = self.dvids[dsafe[use_d]]
            vsz[use_d] = self.dvsizes[dsafe[use_d]]
        else:
            use_d = in_d
        if len(self.bkeys):
            vids[use_b] = self.bvids[bsafe[use_b]]
            vsz[use_b] = self.bvsizes[bsafe[use_b]]
        return use_d | use_b, vids, vsz

    def get(self, key: int) -> tuple[int, int] | None:
        """-> (vid, vsize) of the live version, or None."""
        found, vids, vsz = self.lookup_batch(np.array([key], np.uint64))
        if not found[0]:
            return None
        return int(vids[0]), int(vsz[0])

    # -------------------------------------------------------------- writes
    def apply_batch(self, is_put: np.ndarray, keys: np.ndarray,
                    vids: np.ndarray, vsizes: np.ndarray) -> None:
        """Apply a WriteBatch column: the last record per key wins (batch
        order = seq order); intermediate updates cancel out of
        ``valid_bytes`` exactly as they would applied one by one."""
        n = len(keys)
        if n == 0:
            return
        order = np.lexsort((np.arange(n), keys))
        sk = keys[order]
        last = np.ones(n, bool)
        last[:-1] = sk[1:] != sk[:-1]
        rows = order[last]                  # one row per key, key-sorted
        bk, bput = keys[rows], is_put[rows]
        bvid, bvsz = vids[rows], vsizes[rows]

        prev_found, _, prev_vsz = self.lookup_batch(bk)
        self.valid_bytes -= int(prev_vsz[prev_found].sum())
        self.valid_bytes += int(bvsz[bput].sum())

        # fold the batch into the delta run (batch replaces delta rows;
        # deletes become tombstones so they still mask the base)
        in_d, dsafe = _probe(self.dkeys, bk)
        keep = np.ones(len(self.dkeys), bool)
        keep[dsafe[in_d]] = False
        nvid = np.where(bput, bvid, _TOMB_VID)
        nvsz = np.where(bput, bvsz, 0)
        dk = np.concatenate([self.dkeys[keep], bk])
        o = np.argsort(dk, kind="stable")
        self.dkeys = dk[o]
        self.dvids = np.concatenate([self.dvids[keep], nvid])[o]
        self.dvsizes = np.concatenate([self.dvsizes[keep], nvsz])[o]

        # amortized compaction: delta stays ~sqrt(base)-sized, so per-batch
        # work is O(batch + sqrt(total)) instead of O(total keys)
        if len(self.dkeys) > max(_DELTA_MIN,
                                 int(len(self.bkeys) ** 0.5)
                                 * _DELTA_SQRT_MULT):
            self._compact()

    def _compact(self) -> None:
        in_b, bsafe = _probe(self.bkeys, self.dkeys)
        keep = np.ones(len(self.bkeys), bool)
        keep[bsafe[in_b]] = False
        live = self.dvids != _TOMB_VID
        bk = np.concatenate([self.bkeys[keep], self.dkeys[live]])
        o = np.argsort(bk, kind="stable")
        self.bkeys = bk[o]
        self.bvids = np.concatenate([self.bvids[keep], self.dvids[live]])[o]
        self.bvsizes = np.concatenate([self.bvsizes[keep],
                                       self.dvsizes[live]])[o]
        self.dkeys = np.zeros(0, np.uint64)
        self.dvids = np.zeros(0, np.uint64)
        self.dvsizes = np.zeros(0, np.int64)
