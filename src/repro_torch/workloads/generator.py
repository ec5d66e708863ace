"""Workload generators matching the paper's evaluation setup (§IV-A); port
of ``repro.workloads.generator``, draw for draw the same streams.

Value-size distributions:
  * Fixed-<n>   — constant value size (paper sweeps 256B..16KB).
  * Mixed-8K    — 1:1 small (uniform 100..512B) : large (16KB); ByteDance
                  OLTP pattern (large = DB page updates, small = user writes).
  * Pareto-1K   — generalized Pareto, mean ~1KB (paper's variable-length wl).

Key distribution: Zipfian (YCSB scrambled-zipfian style) with constant 0.99
by default, or uniform.  Keys are dense integers (order-preserving, so range
scans are meaningful); 24B on-disk size is accounted by the engine config.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.batch import WriteBatch
from ..core.engine.keys import splitmix64


@dataclasses.dataclass
class ValueDist:
    name: str

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        raise NotImplementedError

    @property
    def mean(self) -> float:
        raise NotImplementedError


@dataclasses.dataclass
class Fixed(ValueDist):
    size: int = 1024

    def __init__(self, size: int):
        super().__init__(name=f"fixed-{size}")
        self.size = size

    def sample(self, rng, n):
        return np.full(n, self.size, np.int64)

    @property
    def mean(self):
        return float(self.size)


@dataclasses.dataclass
class Mixed(ValueDist):
    """small:large mix; paper default 1:1 of U(100,512) and 16KB (~8K avg)."""
    small_lo: int = 100
    small_hi: int = 512
    large: int = 16384
    large_frac: float = 0.5

    def __init__(self, small_lo=100, small_hi=512, large=16384,
                 large_frac=0.5):
        super().__init__(name=f"mixed-{large_frac:.1f}x{large}")
        self.small_lo, self.small_hi = small_lo, small_hi
        self.large, self.large_frac = large, large_frac

    def sample(self, rng, n):
        is_large = rng.random(n) < self.large_frac
        small = rng.integers(self.small_lo, self.small_hi + 1, n)
        return np.where(is_large, self.large, small).astype(np.int64)

    @property
    def mean(self):
        return (self.large_frac * self.large
                + (1 - self.large_frac) * (self.small_lo + self.small_hi) / 2)


@dataclasses.dataclass
class Pareto(ValueDist):
    """Generalized Pareto (paper refs [32,33]); clipped to [64, 64KB]."""
    mean_size: float = 1024.0
    shape: float = 0.2

    def __init__(self, mean_size=1024.0, shape=0.2):
        super().__init__(name=f"pareto-{int(mean_size)}")
        self.mean_size, self.shape = mean_size, shape

    def sample(self, rng, n):
        # GPD with xi=shape, mu=64; scale chosen to hit the requested mean:
        # mean = mu + sigma / (1 - xi)
        sigma = (self.mean_size - 64) * (1 - self.shape)
        u = rng.random(n)
        x = 64 + sigma * ((1 - u) ** (-self.shape) - 1) / self.shape
        return np.clip(x, 64, 65536).astype(np.int64)

    @property
    def mean(self):
        return self.mean_size


class ZipfKeys:
    """Scrambled-zipfian over [0, n) (YCSB-style), vectorized via rejection-
    free inverse-CDF on a precomputed table for the head + uniform tail."""

    def __init__(self, n: int, theta: float = 0.99, seed: int = 0):
        self.n = n
        self.theta = theta
        head = min(n, 10_000)
        ranks = np.arange(1, head + 1, dtype=np.float64)
        w = ranks ** (-theta)
        # tail mass approximated by integral
        if n > head:
            tail_mass = ((n ** (1 - theta)) - (head ** (1 - theta))) / (1 - theta)
        else:
            tail_mass = 0.0
        self._head = head
        self._head_cdf = np.cumsum(w) / (w.sum() + tail_mass)
        self._perm_seed = np.uint64(seed * 2654435761 + 1)

    def sample(self, rng: np.random.Generator, m: int) -> np.ndarray:
        u = rng.random(m)
        head_p = self._head_cdf[-1]
        is_head = u < head_p
        out = np.empty(m, np.int64)
        out[is_head] = np.searchsorted(self._head_cdf, u[is_head])
        n_tail = int((~is_head).sum())
        if n_tail:
            out[~is_head] = rng.integers(self._head, self.n, n_tail)
        # scramble so hot keys are spread over the key space (YCSB)
        scram = splitmix64(out.astype(np.uint64) ^ self._perm_seed)
        return (scram % np.uint64(self.n)).astype(np.int64)


class UniformKeys:
    def __init__(self, n: int):
        self.n = n

    def sample(self, rng, m):
        return rng.integers(0, self.n, m)


class HotspotKeys:
    """Shifting-hotspot distribution (adaptive-GC stressor, DESIGN.md §8).

    ``hot_frac`` of ops hit a contiguous hot set of ``hot_n`` keys; the rest
    are uniform over the whole keyspace.  Every ``shift_every`` sampled ops
    the hotspot relocates to a pseudorandom position (``splitmix64`` of the
    phase number — deterministic given the seed), so write hotness is
    *non-stationary*: trackers that never decay keep heating retired
    hotspots, and static policies keep rewriting values that stopped dying.
    Vectorized: phase assignment and hot-set offsets are pure array math.
    """

    def __init__(self, n: int, hot_n: int | None = None,
                 hot_frac: float = 0.9, shift_every: int = 10_000,
                 seed: int = 0):
        self.n = int(n)
        self.hot_n = int(hot_n) if hot_n is not None else max(1, self.n // 50)
        if self.hot_n < 1:
            raise ValueError(f"hot_n must be >= 1, got {self.hot_n}")
        self.hot_frac = float(hot_frac)
        self.shift_every = max(1, int(shift_every))
        self.seed = np.uint64(seed * 0x9E3779B9 + 7)
        self._i = 0         # ops sampled so far (drives the phase)

    def sample(self, rng: np.random.Generator, m: int) -> np.ndarray:
        idx = self._i + np.arange(m, dtype=np.int64)
        self._i += m
        phase = (idx // self.shift_every).astype(np.uint64)
        start = splitmix64(phase ^ self.seed) % np.uint64(self.n)
        is_hot = rng.random(m) < self.hot_frac
        off = rng.integers(0, self.hot_n, m).astype(np.uint64)
        hot_keys = (start + off) % np.uint64(self.n)
        uni = rng.integers(0, self.n, m).astype(np.uint64)
        return np.where(is_hot, hot_keys, uni).astype(np.int64)


@dataclasses.dataclass
class WorkloadSpec:
    """A scaled version of the paper's load/update/read/scan procedure."""
    name: str
    value_dist: ValueDist
    dataset_bytes: int = 32 << 20
    update_factor: float = 3.0          # paper: 100GB load + 300GB updates
    zipf_theta: float = 0.99
    seed: int = 0

    @property
    def n_keys(self) -> int:
        return max(64, int(self.dataset_bytes / self.value_dist.mean))

    @property
    def n_updates(self) -> int:
        return int(self.n_keys * self.update_factor)


def mixed_8k(dataset_bytes=32 << 20, **kw) -> WorkloadSpec:
    return WorkloadSpec("Mixed-8K", Mixed(), dataset_bytes, **kw)


def pareto_1k(dataset_bytes=32 << 20, **kw) -> WorkloadSpec:
    return WorkloadSpec("Pareto-1K", Pareto(), dataset_bytes, **kw)


def fixed(size: int, dataset_bytes=32 << 20, **kw) -> WorkloadSpec:
    return WorkloadSpec(f"Fixed-{size}", Fixed(size), dataset_bytes, **kw)


class Runner:
    """Drives a Store through load / update / read / scan phases.

    Ops are issued through the batched columnar API (``WriteBatch`` /
    ``multi_get`` / ``multi_scan``) in chunks of ``batch`` keys; the oracle
    updates column-wise with the same last-write-wins semantics the store
    applies inside a batch.  ``batch=1`` degenerates to the scalar loop."""

    def __init__(self, store, spec: WorkloadSpec, batch: int = 256,
                 key_gen=None):
        self.store = store
        self.spec = spec
        self.batch = max(1, int(batch))
        self.rng = np.random.default_rng(spec.seed)
        # key_gen overrides the spec's default update/read key distribution
        # (e.g. HotspotKeys for the shifting-hotspot benchmark)
        self.keys = key_gen if key_gen is not None else (
            ZipfKeys(spec.n_keys, spec.zipf_theta, spec.seed)
            if spec.zipf_theta else UniformKeys(spec.n_keys))
        self.oracle: dict[int, int] = {}

    # ------------------------------------------------------------- batching
    def apply_puts(self, keys: np.ndarray, sizes: np.ndarray) -> None:
        """Write a key/vsize column in WriteBatch chunks, updating the
        oracle (later occurrences of a key win, as in the store)."""
        keys = np.asarray(keys).astype(np.uint64)
        sizes = np.asarray(sizes).astype(np.int64)
        for i in range(0, len(keys), self.batch):
            kc, vc = keys[i:i + self.batch], sizes[i:i + self.batch]
            vids = self.store.write(WriteBatch().puts(kc, vc))
            self.oracle.update(zip(kc.tolist(), vids.tolist()))

    def check_reads(self, keys: np.ndarray) -> int:
        """multi_get a key column, compare against the oracle, return the
        mismatch count (0 expected; vids start at 1, so 0 = not-found)."""
        keys = np.asarray(keys).astype(np.uint64)
        errors = 0
        for i in range(0, len(keys), self.batch):
            kc = keys[i:i + self.batch]
            res = self.store.multi_get(kc)
            expect = np.array([self.oracle.get(k, 0) for k in kc.tolist()],
                              np.uint64)
            errors += int((res["vid"] != expect).sum())
        return errors

    # --------------------------------------------------------------- phases
    def load(self) -> dict:
        """Insert every key once (random order), as the paper's load phase."""
        t0 = self.store.io.clock_us
        order = self.rng.permutation(self.spec.n_keys)
        sizes = self.spec.value_dist.sample(self.rng, self.spec.n_keys)
        self.apply_puts(order, sizes)
        self.store.flush()
        return {"phase": "load", "ops": self.spec.n_keys,
                "sim_s": (self.store.io.clock_us - t0) / 1e6}

    def update(self, n: int | None = None) -> dict:
        n = self.spec.n_updates if n is None else n
        t0 = self.store.io.clock_us
        ks = self.keys.sample(self.rng, n)
        sizes = self.spec.value_dist.sample(self.rng, n)
        self.apply_puts(ks, sizes)
        self.store.settle()
        return {"phase": "update", "ops": n,
                "sim_s": (self.store.io.fg_clock_us - t0) / 1e6}

    def read(self, n: int) -> dict:
        t0 = self.store.io.fg_clock_us
        ks = self.keys.sample(self.rng, n)
        errors = self.check_reads(ks)
        assert errors == 0, f"{errors} read mismatches"
        return {"phase": "read", "ops": n,
                "sim_s": (self.store.io.fg_clock_us - t0) / 1e6}

    def scan(self, n: int, max_len: int = 100) -> dict:
        """Batched range queries with per-scan lengths — the same draws as
        the scalar loop, one columnar multi_scan call per chunk."""
        t0 = self.store.io.fg_clock_us
        starts = self.rng.integers(0, self.spec.n_keys, n)
        lens = self.rng.integers(1, max_len + 1, n)
        total = 0
        for i in range(0, n, self.batch):
            for out in self.store.multi_scan(starts[i:i + self.batch],
                                             lens[i:i + self.batch]):
                total += len(out)
        return {"phase": "scan", "ops": n, "entries": total,
                "sim_s": (self.store.io.fg_clock_us - t0) / 1e6}
