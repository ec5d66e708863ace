"""Version: level structure, value-file registry, inheritance
(DESIGN.md §2).

TerarkDB-style no-writeback GC (paper §II-B) keeps the index LSM-tree's
``<key, file_number>`` entries stable across GC by recording *inheritance*:
a GC output file inherits from every candidate it merged.  ``resolve``
follows ``merged_into`` pointers (with path compression) to the live head.
"""

from __future__ import annotations

import numpy as np

from .tables import SSTable, KIND_VALUE


class Version:
    def __init__(self, max_levels: int):
        self.levels: list[list[SSTable]] = [[] for _ in range(max_levels)]
        self.value_files: dict[int, SSTable] = {}
        self._chain: dict[int, int] = {}     # old fid -> successor fid
        self._bounds_cache: dict[int, tuple] = {}

    # ---------------------------------------------------------------- kSSTs
    def add_l0(self, t: SSTable) -> None:
        self.levels[0].append(t)            # newest last

    def set_level(self, i: int, files: list[SSTable]) -> None:
        files.sort(key=lambda t: t.min_key)
        self.levels[i] = files
        self._bounds_cache.pop(i, None)

    def level_bytes(self, i: int) -> int:
        return sum(t.file_bytes for t in self.levels[i])

    def level_compensated_bytes(self, i: int) -> int:
        return sum(t.compensated_bytes for t in self.levels[i])

    def last_nonempty_level(self) -> int:
        for i in range(len(self.levels) - 1, 0, -1):
            if self.levels[i]:
                return i
        return 0

    def ksst_total_bytes(self) -> int:
        return sum(self.level_bytes(i) for i in range(len(self.levels)))

    def all_kssts(self):
        for lvl in self.levels:
            yield from lvl

    def level_bounds(self, i: int):
        """(min_keys, max_keys) arrays for vectorized file assignment."""
        if i not in self._bounds_cache:
            files = self.levels[i]
            mins = np.array([t.min_key for t in files], np.uint64)
            maxs = np.array([t.max_key for t in files], np.uint64)
            self._bounds_cache[i] = (mins, maxs)
        return self._bounds_cache[i]

    def assign_files(self, i: int, keys: np.ndarray) -> np.ndarray:
        """Vectorized: index of the file in level i whose range covers each
        key; -1 if none.  Level i>=1 files are disjoint and sorted."""
        files = self.levels[i]
        if not files:
            return np.full(len(keys), -1, np.int64)
        mins, maxs = self.level_bounds(i)
        pos = np.searchsorted(mins, keys, side="right") - 1
        ok = pos >= 0
        safe = np.where(ok, pos, 0)
        ok &= keys <= maxs[safe]
        return np.where(ok, pos, -1).astype(np.int64)

    def overlapping(self, i: int, lo: int, hi: int) -> list[SSTable]:
        return [t for t in self.levels[i]
                if not (t.max_key < lo or t.min_key > hi)]

    # ---------------------------------------------------------- value files
    def add_value_file(self, t: SSTable) -> None:
        assert t.kind == KIND_VALUE
        self.value_files[t.fid] = t

    def retire_value_file(self, fid: int, successor: int | None) -> None:
        t = self.value_files.pop(fid, None)
        if t is not None and successor is not None:
            t.merged_into = successor
            self._chain[fid] = successor

    def resolve(self, fid: int) -> int:
        """Chain-head resolution with path compression."""
        seen = []
        f = fid
        while f in self._chain:
            seen.append(f)
            f = self._chain[f]
        for s in seen:
            self._chain[s] = f
        return f

    def resolve_many(self, fids: np.ndarray) -> np.ndarray:
        return np.fromiter((self.resolve(int(f)) for f in fids),
                           dtype=np.int64, count=len(fids))

    def value_total_bytes(self) -> int:
        return sum(t.file_bytes for t in self.value_files.values())

    def value_garbage_bytes(self) -> int:
        return sum(t.garbage_bytes for t in self.value_files.values())

    def total_bytes(self) -> int:
        return self.ksst_total_bytes() + self.value_total_bytes()
