from .ops import merge_dedup
from .ref import merge_dedup_ref

__all__ = ["merge_dedup", "merge_dedup_ref"]
