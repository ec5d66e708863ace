"""Block cache (two-priority LRU, RocksDB-style) and DropCache
(DESIGN.md §2).

BlockCache models RocksDB's LRUCache with a high-priority pool: blocks
inserted at high priority (index/filter blocks, and — Scavenger §III-B.2 —
DTable's KF index-key blocks) are kept in a protected pool; low-priority data
blocks evict first.  Capacity is in bytes; hits/misses are counted so
benchmarks can reproduce the paper's cache-hit-ratio analysis (§II-C).

DropCache (Scavenger §III-B.3) is an LRU *key* cache recording keys dropped
during compaction (over-written / deleted versions = hot-write data).  Flush
and GC consult it to route records to hot vs cold vSSTs.  32B/key accounting.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np


class BlockCache:
    PRI_LOW = 0
    PRI_HIGH = 1

    def __init__(self, capacity_bytes: int, high_pri_frac: float = 0.5):
        self.capacity = int(capacity_bytes)
        self.high_capacity = int(capacity_bytes * high_pri_frac)
        self._low: OrderedDict = OrderedDict()   # key -> nbytes
        self._high: OrderedDict = OrderedDict()
        self.low_bytes = 0
        self.high_bytes = 0
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------------ api
    def get(self, key) -> bool:
        if key in self._high:
            self._high.move_to_end(key)
            self.hits += 1
            return True
        if key in self._low:
            self._low.move_to_end(key)
            self.hits += 1
            return True
        self.misses += 1
        return False

    def put(self, key, nbytes: int, priority: int = PRI_LOW) -> None:
        nbytes = int(nbytes)
        if nbytes > self.capacity:
            return
        self.erase(key)
        if priority == self.PRI_HIGH:
            self._high[key] = nbytes
            self.high_bytes += nbytes
        else:
            self._low[key] = nbytes
            self.low_bytes += nbytes
        self._evict()

    def probe_records(self, fid: int, stream: str, positions, nbytes,
                      priority: int = PRI_LOW) -> np.ndarray:
        """Batched lookup-or-insert for per-record cache keys.

        For each position (in order): a resident record counts a hit and
        is touched; a missing one is inserted at ``priority`` — exactly the
        get-then-put-on-miss sequence of the scalar path, so LRU state and
        hit/miss counters stay byte-identical.  Returns the hit mask."""
        hits = np.empty(len(positions), bool)
        for i, (p, nb) in enumerate(zip(np.asarray(positions).tolist(),
                                        np.asarray(nbytes).tolist())):
            ck = (fid, stream, p)
            if self.get(ck):
                hits[i] = True
            else:
                hits[i] = False
                self.put(ck, int(nb), priority)
        return hits

    def erase(self, key) -> None:
        if key in self._high:
            self.high_bytes -= self._high.pop(key)
        elif key in self._low:
            self.low_bytes -= self._low.pop(key)

    def erase_file(self, fid: int) -> None:
        """Drop all blocks of a deleted file (active replacement, §III-B.2)."""
        for q, attr in ((self._high, "high_bytes"), (self._low, "low_bytes")):
            dead = [k for k in q if k[0] == fid]
            for k in dead:
                setattr(self, attr, getattr(self, attr) - q.pop(k))

    @property
    def used(self) -> int:
        return self.low_bytes + self.high_bytes

    def hit_ratio(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def reset_stats(self) -> None:
        self.hits = self.misses = 0

    # ------------------------------------------------------------- internal
    def _evict(self) -> None:
        while self.used > self.capacity:
            # Evict from the low-pri pool first; only shrink the high-pri
            # pool when it exceeds its reserved share (RocksDB behaviour).
            if self._low and (self.high_bytes <= self.high_capacity
                              or not self._high):
                _, nb = self._low.popitem(last=False)
                self.low_bytes -= nb
            elif self._high:
                _, nb = self._high.popitem(last=False)
                self.high_bytes -= nb
            else:
                break


class DropCache:
    """LRU of keys dropped during compaction (hot-write detection)."""

    BYTES_PER_KEY = 32

    def __init__(self, capacity_keys: int):
        self.capacity = int(capacity_keys)
        self._lru: OrderedDict = OrderedDict()
        self.record_count = 0

    def record(self, keys: np.ndarray) -> None:
        """Record keys dropped during a compaction merge."""
        if self.capacity <= 0:
            return
        for k in np.asarray(keys, dtype=np.uint64).tolist():
            if k in self._lru:
                self._lru.move_to_end(k)
            else:
                self._lru[k] = None
            self.record_count += 1
        while len(self._lru) > self.capacity:
            self._lru.popitem(last=False)

    def is_hot(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized hotness test (does NOT touch LRU order: a probe is not
        a write-hotness signal)."""
        ks = np.asarray(keys, dtype=np.uint64)
        member = self._lru
        return np.fromiter((k in member for k in ks.tolist()),
                           dtype=bool, count=len(ks))

    @property
    def nbytes(self) -> int:
        return len(self._lru) * self.BYTES_PER_KEY
