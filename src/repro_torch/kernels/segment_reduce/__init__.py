from .ops import gather_min64, segment_sum, sketch_add, sketch_estimate
from .ref import (gather_min64_ref, segment_sum_ref, sketch_add_ref,
                  sketch_estimate_ref)

__all__ = ["gather_min64", "gather_min64_ref", "segment_sum",
           "segment_sum_ref", "sketch_add", "sketch_add_ref",
           "sketch_estimate", "sketch_estimate_ref"]
