"""Scavenger core, PyTorch port: KV-separated LSM-tree engines.

Seven selectable engines over one deterministic substrate:
rocksdb | blobdb | titan | terarkdb | scavenger | hybrid |
scavenger_adaptive — each a pluggable strategy object resolved from the
``repro_torch.core.engines`` registry.  Host bookkeeping is NumPy, as in
the reference package; the batched probes, fetch planning and the
adaptive tracker's sketch updates run as CUDA kernels on the store's
device (``core/accel.py``, ``core/adaptive/``).  Durable stores
(``durability/``) write the reference package's on-disk format.
"""

from .batch import WriteBatch
from .durability import CrashPoint, Durability
from .engine.config import EngineConfig, ENGINES
from .engines import (EngineStrategy, available_engines, make_strategy,
                      register_engine)
from .oracle import LatestOracle
from .store import Store

__all__ = ["CrashPoint", "Durability", "EngineConfig", "ENGINES",
           "EngineStrategy", "LatestOracle", "Store", "WriteBatch",
           "available_engines", "make_strategy", "register_engine"]
