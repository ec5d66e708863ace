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

With a kernel policy (kernels on), the counters are **resident**: a
float64 tensor on the sketch's device, the row seeds uploaded once.  Every
add then runs there whatever the batch size, as ``segment_sum``'s key form
(``sketch_add``: the row hash and the add into the counters in one launch,
the keys the only upload, nothing brought back and no wait for the card),
and every estimate as ``gather_min64``'s (``sketch_estimate``: only the
keys go up).  Both are bit-identical to the host path: unit-count adds
accumulate as one integer-valued float add per slot either way, a decay is
the same IEEE multiply per counter in the same order (a factor waits for
the next launch that touches the counters, which applies it first, and is
never multiplied into another factor), and the estimate's min compares the
counters' 64-bit patterns as unsigned integers, exact for the sketch's
non-negative float64 counters.  ``counts`` brings the counters to the host
(waiting for the card) for the snapshot and the host-side sums, and takes a
host array to upload; with kernels off the sketch stays NumPy.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import kernels
from .. import accel
from ...kernels.common import to_device, to_device_async, to_host
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
    __slots__ = ("width", "depth", "half_life", "clock", "_seeds", "policy",
                 "device", "_counts", "_dev", "_dseeds", "_scratch",
                 "_pending")

    def __init__(self, width: int, depth: int = 2,
                 half_life: float | None = None, seed: int = 0,
                 policy=None, device=None):
        if width < 1 or depth < 1:
            raise ValueError("sketch width and depth must be >= 1")
        self.width = int(width)
        self.depth = int(depth)
        self.half_life = normalize_half_life(half_life)
        self.clock = 0.0
        self._seeds = splitmix64(
            np.uint64(seed) + np.arange(1, self.depth + 1, dtype=np.uint64))
        self.policy = policy    # KernelPolicy (core/accel.py) or None
        # where the resident counters live: CUDA unless the caller names a
        # device
        self.device = (None if policy is None
                       else accel.resolve_device(device))
        # host mode: the counters; resident: the host copy, read-only, or
        # None after a change on the device
        self._counts = np.zeros((self.depth, self.width), np.float64)
        self._dev = self._dseeds = self._scratch = None
        self._pending = None    # a decay factor the device has not applied
        if policy is not None and policy.enabled:
            self._dseeds = to_device(self._seeds, self.device)
            self._upload(self._counts)
            if self.device.type == "cuda":     # sketch_add's counts
                self._scratch = torch.zeros(self.depth * self.width,
                                            dtype=torch.int32,
                                            device=self.device)

    # ------------------------------------------------------------ counters
    @property
    def counts(self) -> np.ndarray:
        """The (depth, width) float64 counters.  A resident sketch brings
        them to the host (waiting for the card) and keeps that copy,
        read-only, until its counters next change."""
        if self._counts is None:
            self._apply_pending()
            host = self._dev.to("cpu", copy=True).numpy()
            host.flags.writeable = False
            self._counts = host
        return self._counts

    @counts.setter
    def counts(self, arr: np.ndarray) -> None:
        """Replace the counters (a snapshot's restore); a resident sketch
        uploads a copy of ``arr``."""
        if self._dev is None:
            self._counts = arr
            return
        arr = np.asarray(arr, np.float64)
        if arr.shape != (self.depth, self.width):
            raise ValueError(f"sketch counters must be "
                             f"{(self.depth, self.width)}, got {arr.shape}")
        self._upload(arr)

    def _upload(self, arr: np.ndarray) -> None:
        host = np.array(arr, np.float64)
        self._dev = torch.from_numpy(host).to(self.device, copy=True)
        self._pending = None
        host.flags.writeable = False
        self._counts = host

    def _apply_pending(self) -> None:
        """A resident sketch's waiting decay factor, applied on its device
        (a ``sketch_add`` with no keys)."""
        if self._pending is not None:
            kernels.sketch_add(self._dev, self._dseeds[:0], self._dseeds,
                               scale=self._pending)
            self._pending = None

    # ---------------------------------------------------------------- decay
    def decay_to(self, clock: float) -> None:
        """Advance the op clock, scaling all counters by the elapsed decay."""
        d = float(clock) - self.clock
        if d <= 0:
            return
        self.clock = float(clock)
        if self.half_life is None:
            return
        factor = 0.5 ** (d / self.half_life)
        if self._dev is None:
            self._counts *= factor
            return
        # resident: the factor waits for the next launch on the counters
        # (an add applies it in its own launch); an earlier one still
        # waiting is applied first, never multiplied into this one
        self._apply_pending()
        self._pending = factor
        self._counts = None

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
        the resident sketch's ``sketch_add``, so the host and device paths
        stay bit-identical.  Weighted adds (no caller in the store) take
        the host path, over a resident sketch's downloaded counters."""
        if len(keys) == 0:
            return
        if self._dev is not None and weights is None:
            kernels.sketch_add(self._dev, to_device_async(keys, self.device),
                               self._dseeds, scale=self._pending,
                               scratch=self._scratch)
            self._pending = None
            self._counts = None
            return
        idx = self._rows(keys)
        if weights is not None:
            w = np.asarray(weights, np.float64)
            counts = self.counts if self._dev is None else self.counts.copy()
            for r in range(self.depth):
                np.add.at(counts[r], idx[r], w)
            if self._dev is not None:
                self.counts = counts
            return
        for r in range(self.depth):
            self._counts[r] += np.bincount(idx[r], minlength=self.width)

    # -------------------------------------------------------------- queries
    def estimate(self, keys: np.ndarray) -> np.ndarray:
        """Decayed event-count estimate per key (count-min: min over rows)."""
        if len(keys) == 0:
            return np.zeros(0, np.float64)
        if self._dev is not None:
            # the row hash runs in the kernel over the resident counters'
            # 64-bit patterns; the u64 min of the patterns == the numeric
            # min for non-negative doubles
            self._apply_pending()
            (est,) = to_host(kernels.sketch_estimate(
                self._dev.view(torch.int64), to_device(keys, self.device),
                self._dseeds))
            return est.view(np.float64)
        idx = self._rows(keys)
        est = self._counts[0][idx[0]]
        for r in range(1, self.depth):
            est = np.minimum(est, self._counts[r][idx[r]])
        return est

    def total_mass(self) -> float:
        """Total decayed event mass (row 0 — every row sums the same adds);
        NumPy's own sum on the host, for a resident sketch too."""
        return float(self.counts[0].sum())

    def active_slots(self) -> int:
        """Occupied row-0 slots — a lower bound on distinct active keys."""
        return int(np.count_nonzero(self.counts[0] > _MIN_MASS))
