from .ops import (count_le, interval_rank, lookup_probe, lookup_probe_segments,
                  rank_probe, rank_probe_segments)
from .ref import (count_le_ref, interval_rank_ref, lookup_probe_ref,
                  lookup_probe_segments_ref, rank_probe_ref,
                  rank_probe_segments_ref)

__all__ = ["count_le", "count_le_ref", "interval_rank", "interval_rank_ref",
           "lookup_probe", "lookup_probe_ref", "lookup_probe_segments",
           "lookup_probe_segments_ref", "rank_probe", "rank_probe_ref",
           "rank_probe_segments", "rank_probe_segments_ref"]
