"""WriteBatch: columnar, atomically-applied group of puts/deletes
(DESIGN.md §3).

The batch is the unit of the group-commit write path (``Store.write``):
one admission/quota check, one sequence-number range, one WAL append, and
chunked vectorized memtable insertion.  Ops are kept as parallel NumPy
columns (kind, key, vsize) so the whole batch crosses the Python/engine
boundary in a single call — the scalar ``Store.put``/``Store.delete`` are
thin shims over a one-record batch.

Ordering semantics match RocksDB's WriteBatch: records apply in append
order, so a later put/delete of the same key within one batch wins.
"""

from __future__ import annotations

import numpy as np

OP_PUT = 0
OP_DELETE = 1


class ScalarOps:
    """Scalar one-record shims over the batched columnar API.

    Mixed into ``Store`` and ``ShardedStore``; hosts need
    ``_write_arrays`` / ``multi_get`` / ``multi_scan``.
    """

    def put(self, key: int, vsize: int) -> int:
        """Write key with a value of ``vsize`` bytes; returns the vid."""
        vids = self._write_arrays(np.array([OP_PUT], np.uint8),
                                  np.array([key], np.uint64),
                                  np.array([vsize], np.int64))
        return int(vids[0])

    def delete(self, key: int) -> None:
        self._write_arrays(np.array([OP_DELETE], np.uint8),
                           np.array([key], np.uint64),
                           np.array([0], np.int64))

    def get(self, key: int):
        """-> vid or None."""
        res = self.multi_get(np.array([key], np.uint64))
        return int(res["vid"][0]) if res["found"][0] else None

    def scan(self, start_key: int, count: int):
        """Range query: returns up to ``count`` (key, vid) pairs in order."""
        return self.multi_scan(np.array([start_key], np.int64), count)[0]


class WriteBatch:
    __slots__ = ("_kinds", "_keys", "_vsizes")

    def __init__(self):
        self._kinds: list[np.ndarray] = []
        self._keys: list[np.ndarray] = []
        self._vsizes: list[np.ndarray] = []

    # ------------------------------------------------------------- building
    def put(self, key: int, vsize: int) -> "WriteBatch":
        return self.puts(np.array([key], np.uint64),
                         np.array([vsize], np.int64))

    def delete(self, key: int) -> "WriteBatch":
        return self.deletes(np.array([key], np.uint64))

    def puts(self, keys: np.ndarray, vsizes: np.ndarray) -> "WriteBatch":
        """Append a column of puts; ``keys`` and ``vsizes`` must align."""
        keys = np.asarray(keys, np.uint64).ravel()
        vsizes = np.asarray(vsizes, np.int64).ravel()
        if len(keys) != len(vsizes):
            raise ValueError("keys and vsizes must have equal length")
        self._kinds.append(np.full(len(keys), OP_PUT, np.uint8))
        self._keys.append(keys)
        self._vsizes.append(vsizes)
        return self

    def deletes(self, keys: np.ndarray) -> "WriteBatch":
        keys = np.asarray(keys, np.uint64).ravel()
        self._kinds.append(np.full(len(keys), OP_DELETE, np.uint8))
        self._keys.append(keys)
        self._vsizes.append(np.zeros(len(keys), np.int64))
        return self

    # ------------------------------------------------------------ consuming
    def __len__(self) -> int:
        return sum(len(k) for k in self._keys)

    def arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (kinds u8, keys u64, vsizes i64) in append order."""
        if not self._keys:
            z = np.zeros(0, np.uint64)
            return np.zeros(0, np.uint8), z, np.zeros(0, np.int64)
        return (np.concatenate(self._kinds), np.concatenate(self._keys),
                np.concatenate(self._vsizes))

    def clear(self) -> None:
        self._kinds.clear()
        self._keys.clear()
        self._vsizes.clear()
