"""Shard routers (port of ``repro.core.sharding.router``): vectorized key
-> shard assignment, scatter plans, and live topology changes —
split/merge with epoch-stamped routing (DESIGN.md §6, §14).

Both routers are *slice tables* over a 64-bit routing domain: ``cuts`` is
the ascending list of slice upper bounds (exclusive; the last cut is the
domain size) and ``owners[i]`` is the shard position owning slice ``i``.
Every live shard owns exactly one contiguous slice, so a migration moves
one contiguous sub-range between exactly two shards.

  * range — the routing domain is the dense keyspace ``[0, key_space)``
    and a key routes as itself: a scan touches the owning slice and spills
    into successor slices in key order.  Keys at or beyond ``key_space``
    (e.g. YCSB insert appends) land in the last slice.
  * hash  — the routing domain is the full ``splitmix64`` image
    ``[0, 2^64)``: uniform load regardless of key skew, but keys
    interleave across shards, so range scans fan out to every shard and
    merge (see ``ShardedStore.multi_scan``).  Splits cut the *hashed*
    domain, so a split moves keys only between the split shard and the
    new one (hash-range partitioning).

Topology changes (``split`` / ``merge``) bump ``epoch`` — a monotone
counter the dispatch loops in ``ShardedStore`` snapshot before scattering
a batch: an in-flight batch that raced a finalizing migration observes
the bump and re-dispatches its unwritten rows under the new table
(DESIGN.md §14).

``scatter`` produces one permutation that groups a key column by shard;
results are written back through the same permutation so callers always
see original batch order (gather-with-original-order reassembly).
"""

from __future__ import annotations

import numpy as np

from ..engine.keys import splitmix64

POLICIES = ("hash", "range")

HASH_DOMAIN = 1 << 64           # image of splitmix64


class SliceRouter:
    """Base: an ordered slice table over an integer routing domain."""

    policy = "?"

    def __init__(self, n_shards: int, domain: int):
        n = int(n_shards)
        if n < 1:
            raise ValueError("n_shards must be >= 1")
        self.domain = int(domain)
        if self.domain < n:
            raise ValueError("routing domain must be >= n_shards")
        self.cuts = [(i + 1) * self.domain // n for i in range(n)]
        self.owners = list(range(n))
        self.epoch = 0
        self._rebuild()

    # ------------------------------------------------------------- routing
    def route(self, keys: np.ndarray) -> np.ndarray:
        """Map keys to routing-domain values (uint64)."""
        raise NotImplementedError

    def _rebuild(self) -> None:
        # bounds exclude the final cut (== domain, which may not fit u64);
        # searchsorted then sends every value past the last bound to the
        # last slice — this is also what routes overflow keys (range
        # policy keys >= key_space) to the last slice
        self._bounds = np.array(self.cuts[:-1], np.uint64)
        self._owners = np.array(self.owners, np.int64)

    def slice_of(self, keys: np.ndarray) -> np.ndarray:
        return np.searchsorted(self._bounds, self.route(keys),
                               side="right").astype(np.int64)

    def shard_of(self, keys: np.ndarray) -> np.ndarray:
        return self._owners[self.slice_of(keys)]

    # ------------------------------------------------------------ topology
    @property
    def n_slices(self) -> int:
        return len(self.cuts)

    def slice_bounds(self, sl: int) -> tuple[int, int]:
        """[lo, hi) routing-domain bounds of slice ``sl``."""
        return (0 if sl == 0 else self.cuts[sl - 1], self.cuts[sl])

    def slice_of_shard(self, pos: int) -> int:
        """Slice owned by shard position ``pos`` (exactly one, by
        construction)."""
        return self.owners.index(pos)

    def shard_range(self, pos: int) -> tuple[int, int]:
        return self.slice_bounds(self.slice_of_shard(pos))

    def split(self, pos: int, cut: int, new_pos: int) -> None:
        """Split shard ``pos``'s slice at routing-domain value ``cut``:
        ``pos`` keeps [lo, cut), the shard at ``new_pos`` takes
        [cut, hi).  Bumps the epoch."""
        sl = self.slice_of_shard(pos)
        lo, hi = self.slice_bounds(sl)
        if not lo < cut < hi:
            raise ValueError(f"cut {cut} outside slice ({lo}, {hi})")
        if new_pos in self.owners:
            raise ValueError(f"shard position {new_pos} already owns a "
                             "slice")
        self.cuts.insert(sl, int(cut))
        self.owners.insert(sl + 1, int(new_pos))
        self.epoch += 1
        self._rebuild()

    def merge(self, victim_pos: int, into_pos: int) -> None:
        """Remove ``victim_pos``'s slice, absorbing its range into the
        adjacent slice owned by ``into_pos``.  Bumps the epoch."""
        sv = self.slice_of_shard(victim_pos)
        si = self.slice_of_shard(into_pos)
        if abs(sv - si) != 1:
            raise ValueError(
                f"shards {victim_pos} and {into_pos} own non-adjacent "
                f"slices {sv} and {si}; only adjacent slices merge")
        # dropping the lower slice's cut extends the other over its range
        del self.cuts[min(sv, si)]
        del self.owners[sv]
        self.epoch += 1
        self._rebuild()

    def renumber_removed(self, pos: int) -> None:
        """A shard position was deleted from the fleet's shard list:
        shift every owner above it down by one (no epoch bump — callers
        bump via the merge that preceded the removal)."""
        self.owners = [o - 1 if o > pos else o for o in self.owners]
        self._rebuild()

    def neighbors(self, pos: int) -> list[int]:
        """Shard positions owning slices adjacent to ``pos``'s (merge
        candidates)."""
        sl = self.slice_of_shard(pos)
        out = []
        if sl > 0:
            out.append(self.owners[sl - 1])
        if sl + 1 < len(self.owners):
            out.append(self.owners[sl + 1])
        return out

    # ---------------------------------------------------------- durability
    def state_dict(self) -> dict:
        return {"policy": self.policy, "domain": self.domain,
                "cuts": list(self.cuts), "owners": list(self.owners),
                "epoch": self.epoch}

    def load_state(self, st: dict) -> None:
        if st["policy"] != self.policy or int(st["domain"]) != self.domain:
            raise ValueError(f"router state {st['policy']}/{st['domain']} "
                             f"does not match {self.policy}/{self.domain}")
        self.cuts = [int(c) for c in st["cuts"]]
        self.owners = [int(o) for o in st["owners"]]
        self.epoch = int(st["epoch"])
        self._rebuild()


class HashRouter(SliceRouter):
    policy = "hash"

    def __init__(self, n_shards: int):
        super().__init__(n_shards, HASH_DOMAIN)

    def route(self, keys: np.ndarray) -> np.ndarray:
        return splitmix64(np.asarray(keys, np.uint64))


class RangeRouter(SliceRouter):
    policy = "range"

    def __init__(self, n_shards: int, key_space: int):
        if int(key_space) < int(n_shards):
            raise ValueError("key_space must be >= n_shards")
        super().__init__(n_shards, key_space)

    def route(self, keys: np.ndarray) -> np.ndarray:
        return np.asarray(keys, np.uint64)

    def shard_start(self, shard: int) -> int:
        """Lowest key owned by ``shard`` (scan-continuation entry point)."""
        return self.shard_range(shard)[0]


def make_router(policy: str, n_shards: int, key_space: int | None = None):
    if policy == "hash":
        return HashRouter(n_shards)
    if policy == "range":
        if key_space is None:
            raise ValueError("range policy requires key_space "
                             "(upper bound of the dense key domain)")
        return RangeRouter(n_shards, key_space)
    raise ValueError(f"unknown shard policy {policy!r} (want one of "
                     f"{POLICIES})")


def restore_router(state: dict):
    """Rebuild a router from ``state_dict`` output (fleet recovery)."""
    if state["policy"] == "hash":
        r = HashRouter(len(state["owners"]))
    else:
        r = RangeRouter(len(state["owners"]), state["domain"])
    r.load_state(state)
    return r


def scatter(shard_of: np.ndarray, n_shards: int):
    """Group a routed column by shard.

    Returns ``(order, starts, ends)``: ``order`` is a stable permutation
    putting rows of the same shard adjacent (original relative order kept,
    so per-shard sub-batches preserve WriteBatch append semantics);
    ``order[starts[s]:ends[s]]`` are the original-row indices of shard
    ``s``.  Writing results back through those indices restores original
    batch order.
    """
    order = np.argsort(shard_of, kind="stable")
    srt = shard_of[order]
    ids = np.arange(n_shards, dtype=np.int64)
    starts = np.searchsorted(srt, ids, side="left")
    ends = np.searchsorted(srt, ids, side="right")
    return order, starts, ends
