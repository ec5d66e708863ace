"""``scavenger_adaptive``: the seventh registered engine (port of
``repro.core.adaptive.engine``, DESIGN.md §8).

Scavenger's feature set (compensated compaction, lazy read, decoupled
index, hot/cold write) plus the workload-adaptive layer this package adds
(Scavenger+ direction, arXiv:2508.13935):

  * **observation** — ``observe_batch`` feeds the ``AccessTracker`` from
    the batched write/read hot paths;
  * **adaptive GC candidate choice** — ``gc_candidate_score`` discounts a
    vSST's garbage ratio by the byte-weighted probability that its records
    die within ``adaptive_gc_horizon_ops`` anyway (predicted dead-byte
    yield): files whose live values are about to be overwritten are
    deferred, so GC stops rewriting bytes that were dying on their own,
    and the same score ranks GC jobs fleet-wide in the ``FleetScheduler``;
  * **temperature segregation** — ``rewrite_temperature`` partitions flush
    and GC-survivor vSSTs hot/warm/cold via the ``TemperatureMap``, so cold
    values stop being rewritten over and over and hot files die wholesale.

With ``adaptive_enabled=False`` every hook falls back to the inherited
default and the engine is byte-identical to plain ``scavenger``
(``tests/test_torch_adaptive.py`` holds this against the port's
``scavenger``).
"""

from __future__ import annotations

import numpy as np

from .. import accel
from ..engines.paper import ScavengerEngine
from ..engines.registry import register_engine
from .temperature import TemperatureMap
from .tracker import AccessTracker

# prediction-cache pruning: sweep dead fids once the cache outgrows the
# live vSST set by this factor (floored so tiny stores don't thrash)
_SOON_CACHE_SLACK = 4
_SOON_CACHE_MIN = 8


@register_engine
class AdaptiveScavengerEngine(ScavengerEngine):
    name = "scavenger_adaptive"
    adaptive_enabled = True

    def __init__(self, cfg):
        super().__init__(cfg)
        if cfg.adaptive_enabled:
            self.tracker = AccessTracker.from_config(cfg, self.device)
            self.tempmap = TemperatureMap(self.tracker, cfg.temp_hot_mult,
                                          cfg.temp_cold_mult)
        else:
            self.tracker = None
            self.tempmap = None
        self._soon_cache: dict[int, tuple[float, float]] = {}

    # ------------------------------------------------------------- observe
    def observe_batch(self, store, kind: str, keys, vsizes=None) -> None:
        if self.tracker is None:
            return
        with accel.op_timer(store, "segment_reduce"):
            if kind == "write":
                self.tracker.observe_writes(keys)
            else:
                self.tracker.observe_reads(keys)

    # ---------------------------------------------------------- GC scoring
    def gc_candidate_score(self, store, t) -> float:
        g = t.garbage_ratio()
        if self.tracker is None or g <= 0.0:
            return g
        soon = self._soon_dead_frac(store, t)
        return g * (1.0 - self.cfg.adaptive_defer_weight * soon)

    def _soon_dead_frac(self, store, t) -> float:
        """Byte-weighted probability that the file's *live* records are
        overwritten within the GC horizon.

        The tracker cannot tell which of the file's records are already
        garbage, but the predicted soon-dead mass covers the dead ones too
        (their keys are the churners), so subtracting the known garbage
        bytes from the prediction — and normalizing by live bytes — keeps a
        file's own garbage from inflating its deferral discount.  The raw
        prediction is cached per file on the tracker's op clock (vSSTs are
        immutable, only the prediction window moves); the garbage
        adjustment uses the current ``garbage_bytes`` every call."""
        now = self.tracker.ops
        ent = self._soon_cache.get(t.fid)
        if ent is not None and now - ent[0] < self.cfg.adaptive_score_refresh_ops:
            pred_dead = ent[1]
        else:
            horizon = self.cfg.adaptive_gc_horizon_ops
            # unknown groups predict an infinite residual -> p_dead == 0
            resid = self.tracker.residual_lifetime(t.keys, default=np.inf)
            p = 1.0 - 0.5 ** (horizon / np.maximum(resid, 1.0))
            pred_dead = float((p * t.rec_bytes).sum())
            if len(self._soon_cache) > _SOON_CACHE_SLACK * max(
                    len(store.version.value_files), _SOON_CACHE_MIN):
                live_files = store.version.value_files
                self._soon_cache = {fid: v
                                    for fid, v in self._soon_cache.items()
                                    if fid in live_files}
            self._soon_cache[t.fid] = (now, pred_dead)
        live_bytes = max(int(t.rec_bytes.sum()) - t.garbage_bytes, 1)
        return min(1.0, max(0.0, (pred_dead - t.garbage_bytes) / live_bytes))

    # ------------------------------------------------- vSST temperature
    def rewrite_temperature(self, store, keys) -> np.ndarray | None:
        if self.tempmap is None:
            return None
        return self.tempmap.classify(keys)
