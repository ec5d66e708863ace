"""AccessTracker: the store-facing facade of the adaptive subsystem
(port of ``repro.core.adaptive.tracker``, DESIGN.md §8).

One tracker per store (owned by the ``scavenger_adaptive`` strategy) keeps:

  * a decayed write-frequency sketch and a decayed read-frequency sketch
    (``DecaySketch``) over individual keys;
  * a ``LifetimeEstimator`` over key-groups
    (``group_of = splitmix64(key) % adaptive_groups``).

It is fed from the two foreground hot paths — ``WriteBatch`` apply and
``multi_get`` — through the ``EngineStrategy.observe_batch`` hook, one
columnar call per batch (zero per-key Python loops).  The tracker's clock is
the user-op count, *not* simulated device time: decay half-lives are then
workload-relative (``EngineConfig.scaled`` sizes them from the key count)
and observation costs no simulated I/O, so disabled-tracker runs are
byte-identical.

Consumers that derive expensive summaries from tracker state (GC candidate
scores) cache them against ``ops``, the tracker's op clock.

The tracker's routed batches run on the store's device, passed down
explicitly (``from_config(cfg, device)``): the kernel policy is cached on
the config, which a CPU store and a CUDA store may share.
"""

from __future__ import annotations

import numpy as np

from .. import accel
from ..engine.keys import splitmix64
from .lifetime import LifetimeEstimator
from .sketch import DecaySketch

_WRITES_SEED = 0x5CA7       # distinct hash families for the two sketches
_READS_SEED = 0xADAF


class AccessTracker:
    __slots__ = ("n_groups", "writes", "reads", "lifetime", "ops")

    def __init__(self, n_groups: int, sketch_width: int, sketch_depth: int,
                 half_life_ops: float | None,
                 residual_floor: float = 0.1, policy=None, device=None):
        self.n_groups = int(n_groups)
        self.writes = DecaySketch(sketch_width, sketch_depth,
                                  half_life_ops, seed=_WRITES_SEED,
                                  policy=policy, device=device)
        self.reads = DecaySketch(sketch_width, sketch_depth,
                                 half_life_ops, seed=_READS_SEED,
                                 policy=policy, device=device)
        self.lifetime = LifetimeEstimator(n_groups, half_life_ops,
                                          residual_floor=residual_floor,
                                          policy=policy, device=device)
        self.ops = 0.0

    @classmethod
    def from_config(cls, cfg, device=None) -> "AccessTracker":
        """The tracker ``cfg`` describes, routing on ``device`` (CUDA
        unless the caller names one)."""
        return cls(cfg.adaptive_groups, cfg.adaptive_sketch_width,
                   cfg.adaptive_sketch_depth, cfg.adaptive_half_life_ops,
                   residual_floor=cfg.adaptive_residual_floor,
                   policy=accel.policy_of(cfg), device=device)

    # ------------------------------------------------------------- observe
    def group_of(self, keys: np.ndarray) -> np.ndarray:
        ks = np.asarray(keys, np.uint64)
        return (splitmix64(ks) % np.uint64(self.n_groups)).astype(np.int64)

    def observe_writes(self, keys: np.ndarray) -> None:
        """One put/delete column (deletes end a lifetime like overwrites)."""
        n = len(keys)
        if n == 0:
            return
        self.ops += n
        self.writes.decay_to(self.ops)
        self.reads.decay_to(self.ops)
        self.writes.add(keys)
        self.lifetime.observe(self.group_of(keys), self.ops)

    def observe_reads(self, keys: np.ndarray) -> None:
        n = len(keys)
        if n == 0:
            return
        self.ops += n
        self.writes.decay_to(self.ops)
        self.reads.decay_to(self.ops)
        self.reads.add(keys)

    # ------------------------------------------------------------- queries
    def write_rate(self, keys: np.ndarray) -> np.ndarray:
        """Decayed write-count estimate per key (the hotness signal)."""
        return self.writes.estimate(keys)

    def read_rate(self, keys: np.ndarray) -> np.ndarray:
        return self.reads.estimate(keys)

    def mean_write_rate(self) -> float:
        """Mean decayed write count over active keys (temperature baseline)."""
        return self.writes.total_mass() / max(self.writes.active_slots(), 1)

    def residual_lifetime(self, keys: np.ndarray,
                          default: float = np.inf) -> np.ndarray:
        """Predicted ops until each key's current value is overwritten."""
        return self.lifetime.residual(self.group_of(keys), self.ops, default)
