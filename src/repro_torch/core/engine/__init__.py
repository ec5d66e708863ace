"""Engine substrate: config, simulated device, tables, memtable, caches,
version (DESIGN.md §2-§3)."""

from .config import EngineConfig, ENGINES
from .io import SimIO, DeviceModel
from .cache import BlockCache, DropCache
from .memtable import Memtable
from .tables import (SSTable, build_ksst, build_vsst, ETYPE_INLINE,
                     ETYPE_REF, ETYPE_TOMB, KIND_KEY, KIND_VALUE)
from .version import Version
from .keys import BloomFilter, splitmix64, hash_family

__all__ = [
    "EngineConfig", "ENGINES", "SimIO", "DeviceModel", "BlockCache",
    "DropCache", "Memtable", "SSTable", "build_ksst", "build_vsst",
    "ETYPE_INLINE", "ETYPE_REF", "ETYPE_TOMB", "KIND_KEY", "KIND_VALUE",
    "Version", "BloomFilter", "splitmix64", "hash_family",
]
