"""Memtable: in-memory sorted write buffer (dict + sort-at-flush,
DESIGN.md §2).

Entries are (seq, etype, vid, vsize, vfile).  Normal user puts are INLINE
(the memtable holds the full value until flush decides separation); Titan's
GC Write-Index puts REF entries pointing at an existing blob file.

Reads go through a cached *columnar snapshot* (key-sorted parallel arrays,
rebuilt lazily after a write): ``get_batch`` probes a whole key column with
one ``searchsorted``, and scans slice key ranges out of the same arrays —
no per-key Python in the batched read path.  Immutable memtables never
rebuild; the active memtable rebuilds at most once per write batch.
"""

from __future__ import annotations

import numpy as np

from .config import EngineConfig
from .tables import ETYPE_INLINE, ETYPE_REF, ETYPE_TOMB


class Memtable:
    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        # key -> (seq, etype, vid, vsize, vfile)
        self.entries: dict[int, tuple] = {}
        self.bytes = 0
        self._snap: tuple | None = None     # cached columnar snapshot

    def _entry_bytes(self, etype: int, vsize: int) -> int:
        if etype == ETYPE_TOMB:
            return self.cfg.tomb_rec_bytes()
        if etype == ETYPE_REF:
            return self.cfg.ref_rec_bytes()
        return self.cfg.inline_rec_bytes(vsize)

    def _set(self, key: int, entry: tuple) -> None:
        prev = self.entries.get(key)
        if prev is not None:
            self.bytes -= self._entry_bytes(prev[1], prev[3])
        self.entries[key] = entry
        self.bytes += self._entry_bytes(entry[1], entry[3])
        self._snap = None

    def put(self, key: int, seq: int, vid: int, vsize: int) -> None:
        self._set(key, (seq, ETYPE_INLINE, vid, vsize, -1))

    def put_ref(self, key: int, seq: int, vid: int, vsize: int,
                vfile: int) -> None:
        self._set(key, (seq, ETYPE_REF, vid, vsize, vfile))

    def delete(self, key: int, seq: int) -> None:
        self._set(key, (seq, ETYPE_TOMB, 0, 0, -1))

    def get(self, key: int):
        return self.entries.get(key)

    def snapshot(self) -> tuple:
        """Key-sorted columnar view: (keys, seqs, etype, vids, vsizes,
        vfiles) parallel arrays, cached until the next write."""
        if self._snap is None:
            n = len(self.entries)
            keys = np.fromiter(self.entries.keys(), np.uint64, count=n)
            order = np.argsort(keys, kind="stable")
            vals = list(self.entries.values())
            self._snap = (
                keys[order],
                np.fromiter((v[0] for v in vals), np.uint64, count=n)[order],
                np.fromiter((v[1] for v in vals), np.uint8, count=n)[order],
                np.fromiter((v[2] for v in vals), np.uint64, count=n)[order],
                np.fromiter((v[3] for v in vals), np.int64, count=n)[order],
                np.fromiter((v[4] for v in vals), np.int64, count=n)[order],
            )
        return self._snap

    def get_batch(self, keys: np.ndarray) -> tuple:
        """Vectorized point probe for a key column.

        Returns (found, seqs, etype, vids, vsizes, vfiles) parallel arrays
        aligned with ``keys``; rows where ``found`` is False hold the
        safe-gather placeholder and must be masked by the caller."""
        mk, seqs, ety, vids, vsz, vf = self.snapshot()
        nq = len(keys)
        if len(mk) == 0:
            return (np.zeros(nq, bool), np.zeros(nq, np.uint64),
                    np.zeros(nq, np.uint8), np.zeros(nq, np.uint64),
                    np.zeros(nq, np.int64), np.zeros(nq, np.int64))
        pos = np.searchsorted(mk, keys)
        ok = pos < len(mk)
        safe = np.where(ok, pos, 0)
        ok &= mk[safe] == keys
        return (ok, seqs[safe], ety[safe], vids[safe], vsz[safe], vf[safe])

    def entry_bytes_batch(self, ety: np.ndarray, vsizes: np.ndarray
                          ) -> np.ndarray:
        """Vectorized serialized-size computation for a record column."""
        return np.where(
            ety == ETYPE_TOMB, self.cfg.tomb_rec_bytes(),
            np.where(ety == ETYPE_REF, self.cfg.ref_rec_bytes(),
                     self.cfg.inline_rec_bytes(vsizes))).astype(np.int64)

    def put_batch(self, keys: np.ndarray, seqs: np.ndarray, ety: np.ndarray,
                  vids: np.ndarray, vsizes: np.ndarray, vfiles: np.ndarray,
                  entry_bytes: np.ndarray | None = None) -> int:
        """Insert a record column until the memtable fills.

        Returns how many records were consumed (always >= 1 on non-empty
        input); the caller rotates the memtable and re-submits the rest.
        Stops exactly where the scalar path would have rotated, so batch
        and scalar runs produce identical flush boundaries.
        """
        n = len(keys)
        if n == 0:
            return 0
        if entry_bytes is None:
            entry_bytes = self.entry_bytes_batch(ety, vsizes)
        cap = self.cfg.memtable_bytes
        entries = self.entries
        consumed = 0
        for k, rec, nbytes in zip(
                keys.tolist(),
                zip(seqs.tolist(), ety.tolist(), vids.tolist(),
                    vsizes.tolist(), vfiles.tolist()),
                entry_bytes.tolist()):
            prev = entries.get(k)
            if prev is not None:
                self.bytes -= self._entry_bytes(prev[1], prev[3])
            entries[k] = rec
            self.bytes += nbytes
            consumed += 1
            if self.bytes >= cap:
                break
        self._snap = None
        return consumed

    @property
    def full(self) -> bool:
        return self.bytes >= self.cfg.memtable_bytes

    def __len__(self) -> int:
        return len(self.entries)

    def sorted_arrays(self):
        """-> (keys, seqs, etype, vids, vsizes, vfiles) sorted by key."""
        return self.snapshot()
