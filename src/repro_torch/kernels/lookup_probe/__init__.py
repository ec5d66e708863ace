from .ops import count_le, interval_rank, lookup_probe, rank_probe
from .ref import (count_le_ref, interval_rank_ref, lookup_probe_ref,
                  rank_probe_ref)

__all__ = ["count_le", "count_le_ref", "interval_rank", "interval_rank_ref",
           "lookup_probe", "lookup_probe_ref", "rank_probe", "rank_probe_ref"]
