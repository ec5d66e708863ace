"""Residual value-lifetime prediction from update-interval histograms
(port of ``repro.core.adaptive.lifetime``, DESIGN.md §8).

DumpKV (arXiv:2406.01250) shows that knowing *when* a value will die lets
GC skip rewrites that are about to become garbage anyway.  We estimate
lifetimes per **key-group** (``splitmix64(key) % n_groups`` — group-level
stats stay robust under key-space churn and bound memory): every observed
write to a group contributes its inter-update interval, in user ops, to a
decayed log2-bucket histogram; the histogram's mean is the group's expected
value lifetime, and the residual for a value of known age follows from it.

All updates are columnar: one ``np.unique`` + fancy-indexing pass per
observed batch (an in-batch repeat of a group is a ~0-interval update; one
observation per group per batch keeps the histogram meaningful at any batch
size).  Eligible batches add their one-hot bucket rows through the
``segment_sum`` kernel on the estimator's device; the histogram changes in
place, so it stays on the host and only the ids and counts cross.
"""

from __future__ import annotations

import numpy as np

from ... import kernels
from .. import accel
from ...kernels.common import to_device, to_host
from .sketch import normalize_half_life

N_BUCKETS = 32          # log2 interval buckets: covers up to 2^31 ops
BUCKET_CENTER = 1.5     # midpoint multiplier for bucket [2^b, 2^(b+1))
_EPS_MASS = 1e-12       # division guard for empty histograms
_MIN_MASS = 1e-9        # below this a group counts as unobserved


class LifetimeEstimator:
    __slots__ = ("n_groups", "half_life", "residual_floor", "last_write",
                 "hist", "_centers", "policy", "device")

    def __init__(self, n_groups: int, half_life: float | None = None,
                 residual_floor: float = 0.1, policy=None, device=None):
        if n_groups < 1:
            raise ValueError("n_groups must be >= 1")
        self.n_groups = int(n_groups)
        self.half_life = normalize_half_life(half_life)
        self.residual_floor = float(residual_floor)
        self.last_write = np.full(self.n_groups, -1.0, np.float64)
        self.hist = np.zeros((self.n_groups, N_BUCKETS), np.float64)
        # bucket b holds intervals in [2^b, 2^(b+1)); center = 1.5 * 2^b
        self._centers = BUCKET_CENTER * 2.0 ** np.arange(N_BUCKETS,
                                                         dtype=np.float64)
        self.policy = policy    # KernelPolicy (core/accel.py) or None
        # where routed batches run: CUDA unless the caller names a device
        self.device = (None if policy is None
                       else accel.resolve_device(device))

    # ------------------------------------------------------------- observe
    def observe(self, groups: np.ndarray, now: float) -> None:
        """Record one write-interval observation per distinct group."""
        if len(groups) == 0:
            return
        ug = np.unique(np.asarray(groups, np.int64))
        prev = self.last_write[ug]
        has = prev >= 0
        sel = ug[has]
        if len(sel):
            iv = np.maximum(now - prev[has], 1.0)
            b = np.clip(np.log2(iv).astype(np.int64), 0, N_BUCKETS - 1)
            if self.half_life is not None:
                # lazy per-group decay: scale by time since last observation
                self.hist[sel] *= (0.5 ** (iv / self.half_life))[:, None]
            pol = self.policy
            if pol is not None and pol.ready(len(sel)):
                # one-hot bucket rows via segment_sum; adding the zero
                # columns is exact (x + 0.0 == x for the non-negative hist)
                flat = np.arange(len(sel)) * N_BUCKETS + b
                (seg,) = to_host(kernels.segment_sum(
                    to_device(flat, self.device), len(sel) * N_BUCKETS))
                self.hist[sel] += seg.reshape(-1, N_BUCKETS)
            else:
                self.hist[sel, b] += 1.0
        self.last_write[ug] = now

    # ------------------------------------------------------------- queries
    def mean_interval(self, groups: np.ndarray,
                      default: float = np.inf) -> np.ndarray:
        """Expected update interval (ops) per group; ``default`` where the
        group has no observations yet (treat unknown as cold)."""
        g = np.asarray(groups, np.int64)
        h = self.hist[g]
        w = h.sum(axis=1)
        mean = (h @ self._centers) / np.maximum(w, _EPS_MASS)
        return np.where(w > _MIN_MASS, mean, default)

    def residual(self, groups: np.ndarray, now: float,
                 default: float = np.inf) -> np.ndarray:
        """Predicted remaining ops until each group's values are next
        overwritten.

        Within the predicted interval: the mean interval less the age,
        floored at ``residual_floor`` of the mean (updates are not
        clockwork; a live hot group's residual never hits zero).  *Past* it, the prediction
        has been falsified — the group stopped updating on schedule (e.g. a
        hotspot moved away) — so the residual grows with the age instead:
        values that keep surviving are expected to keep surviving, and GC
        stops deferring files full of retired-hotspot data."""
        g = np.asarray(groups, np.int64)
        m = self.mean_interval(g, default)
        age = np.where(self.last_write[g] >= 0,
                       now - self.last_write[g], 0.0)
        return np.where(age > m, age,
                        np.maximum(m - age, self.residual_floor * m))
