from .ops import gather_min64, segment_sum
from .ref import gather_min64_ref, segment_sum_ref

__all__ = ["gather_min64", "gather_min64_ref", "segment_sum",
           "segment_sum_ref"]
