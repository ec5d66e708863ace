"""Scavenger core, PyTorch port: KV-separated LSM-tree engines.

Six selectable engines over one deterministic substrate:
rocksdb | blobdb | titan | terarkdb | scavenger | hybrid — each a pluggable
strategy object resolved from the ``repro_torch.core.engines`` registry.
Host bookkeeping is NumPy, as in the reference package; the batched probes
and fetch planning run as CUDA kernels on the store's device
(``core/accel.py``).
"""

from .batch import WriteBatch
from .engine.config import EngineConfig, ENGINES
from .engines import (EngineStrategy, available_engines, make_strategy,
                      register_engine)
from .oracle import LatestOracle
from .store import Store

__all__ = ["EngineConfig", "ENGINES", "EngineStrategy", "LatestOracle",
           "Store", "WriteBatch", "available_engines", "make_strategy",
           "register_engine"]
