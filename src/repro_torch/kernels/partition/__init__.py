from .ops import hot_cold_partition
from .ref import hot_cold_partition_ref

__all__ = ["hot_cold_partition", "hot_cold_partition_ref"]
