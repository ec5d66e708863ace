"""Workload-aware hotness & lifetime tracking (adaptive subsystem; port of
``repro.core.adaptive``).

Scavenger's critique of existing KV-separated GC strategies is that they
"lack thorough consideration of workload characteristics": GC triggers on a
static garbage-ratio threshold, blind to *which* live values are about to
die and which will be rewritten over and over.  This package closes that
gap with a columnar observation pipeline (DESIGN.md §8):

  * ``DecaySketch``       — exponentially-decayed count-min frequency sketch
                            (vectorized batch updates, conservative: never
                            under-counts).
  * ``LifetimeEstimator`` — per-key-group update-interval histograms turned
                            into predicted residual value lifetimes
                            (lifetime-aware GC à la DumpKV, arXiv:2406.01250).
  * ``AccessTracker``     — ties the sketches and estimator to the store's
                            op stream (``WriteBatch`` apply / ``multi_get``),
                            zero per-key Python loops.
  * ``TemperatureMap``    — classifies keys hot/warm/cold from decayed write
                            rates, driving temperature-partitioned vSSTs.
  * ``engine``            — the ``scavenger_adaptive`` strategy composing it
                            all through the ``EngineStrategy`` hook surface.

Everything here is *observation plus policy*: it consumes the op stream and
influences GC candidate choice and vSST partitioning, but costs no simulated
device time and — when disabled — leaves every engine byte-identical.
"""

from .lifetime import LifetimeEstimator
from .sketch import DecaySketch
from .temperature import TEMP_COLD, TEMP_HOT, TEMP_WARM, TemperatureMap
from .tracker import AccessTracker

__all__ = ["AccessTracker", "DecaySketch", "LifetimeEstimator",
           "TemperatureMap", "TEMP_COLD", "TEMP_WARM", "TEMP_HOT"]
