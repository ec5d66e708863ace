"""Exponentially-decayed count-min frequency sketch (port of
``repro.core.adaptive.sketch``, DESIGN.md §8).

A ``DecaySketch`` estimates per-key event rates from a stream of columnar
batches in O(depth * width) memory.  Two properties matter to callers:

  * **Conservative**: with decay disabled the estimate for any key is
    >= its true event count (count-min over-counts on collisions, never
    under-counts).
  * **Decay monotonicity**: advancing the op clock without adding events
    can only lower estimates (each row scales by ``0.5 ** (d / half_life)``),
    so a key that stops being written cools off on a half-life schedule —
    this is what makes a *shifting* hotspot reclassify instead of sticking.

Updates are vectorized (one ``np.bincount`` per row, ``depth`` is a small
constant): a whole key column crosses in one call, zero per-key loops.
Eligible batches route the row updates through the ``segment_sum`` kernel
and the count-min gather through ``gather_min64`` on the sketch's device:
both are bit-identical to the host path — unit-count adds accumulate as
one integer-valued float add per slot either way, and the estimate's min
compares the counters' 64-bit patterns as unsigned integers, exact for
the sketch's non-negative float64 counters.  The counters change in
place, so each routed estimate uploads them anew (at most a few hundred
KB); they are never held in a ``DeviceCache``.
"""

from __future__ import annotations

import numpy as np

from ... import kernels
from .. import accel
from ...kernels.common import to_device, to_host
from ..engine.keys import splitmix64

_MIN_MASS = 1e-9        # decayed mass below this counts as an empty slot


def normalize_half_life(half_life: float | None) -> float | None:
    """Shared decay-window normalization: None / inf / <= 0 all mean
    "no decay" (used by DecaySketch and LifetimeEstimator so the two stay
    in lockstep on what "disabled" means)."""
    if half_life and np.isfinite(half_life) and half_life > 0:
        return float(half_life)
    return None


class DecaySketch:
    __slots__ = ("width", "depth", "half_life", "counts", "clock", "_seeds",
                 "policy", "device")

    def __init__(self, width: int, depth: int = 2,
                 half_life: float | None = None, seed: int = 0,
                 policy=None, device=None):
        if width < 1 or depth < 1:
            raise ValueError("sketch width and depth must be >= 1")
        self.width = int(width)
        self.depth = int(depth)
        self.half_life = normalize_half_life(half_life)
        self.counts = np.zeros((self.depth, self.width), np.float64)
        self.clock = 0.0
        self._seeds = splitmix64(
            np.uint64(seed) + np.arange(1, self.depth + 1, dtype=np.uint64))
        self.policy = policy    # KernelPolicy (core/accel.py) or None
        # where routed batches run: CUDA unless the caller names a device
        self.device = (None if policy is None
                       else accel.resolve_device(device))

    # ---------------------------------------------------------------- decay
    def decay_to(self, clock: float) -> None:
        """Advance the op clock, scaling all counters by the elapsed decay."""
        d = float(clock) - self.clock
        if d <= 0:
            return
        self.clock = float(clock)
        if self.half_life is not None:
            self.counts *= 0.5 ** (d / self.half_life)

    # --------------------------------------------------------------- update
    def _rows(self, keys: np.ndarray) -> np.ndarray:
        """(depth, n) column indices for a key column."""
        ks = np.asarray(keys, np.uint64)
        return (splitmix64(ks[None, :] ^ self._seeds[:, None])
                % np.uint64(self.width)).astype(np.int64)

    def add(self, keys: np.ndarray, weights=None) -> None:
        """Add one event (or ``weights``) per key, vectorized.

        Unit-count adds accumulate occurrence counts first and add each
        slot's total as a single integer-valued float — the exact shape of
        the kernel's ``counts += segment_sum`` update, so the host and
        kernel paths stay bit-identical."""
        if len(keys) == 0:
            return
        idx = self._rows(keys)
        if weights is not None:
            w = np.asarray(weights, np.float64)
            for r in range(self.depth):
                np.add.at(self.counts[r], idx[r], w)
            return
        pol = self.policy
        if pol is not None and pol.ready(len(keys)):
            flat = (idx + np.arange(self.depth)[:, None] * self.width).ravel()
            (seg,) = to_host(kernels.segment_sum(
                to_device(flat, self.device), self.depth * self.width))
            self.counts += seg.reshape(self.depth, self.width)
        else:
            for r in range(self.depth):
                self.counts[r] += np.bincount(idx[r], minlength=self.width)

    # -------------------------------------------------------------- queries
    def estimate(self, keys: np.ndarray) -> np.ndarray:
        """Decayed event-count estimate per key (count-min: min over rows)."""
        if len(keys) == 0:
            return np.zeros(0, np.float64)
        idx = self._rows(keys)
        pol = self.policy
        if pol is not None and pol.ready(len(keys)):
            # (depth, width) f64 -> their 64-bit patterns; the u64 min of
            # the patterns == the numeric min for non-negative doubles
            (est,) = to_host(kernels.gather_min64(
                to_device(self.counts.view(np.int64), self.device),
                to_device(idx.T, self.device)))
            return est.view(np.float64)
        est = self.counts[0][idx[0]]
        for r in range(1, self.depth):
            est = np.minimum(est, self.counts[r][idx[r]])
        return est

    def total_mass(self) -> float:
        """Total decayed event mass (row 0 — every row sums the same adds)."""
        return float(self.counts[0].sum())

    def active_slots(self) -> int:
        """Occupied row-0 slots — a lower bound on distinct active keys."""
        return int(np.count_nonzero(self.counts[0] > _MIN_MASS))
