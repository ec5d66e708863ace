"""Hand-written CUDA kernels (Hopper, ``sm_90a``) for the store's batched
probes, fetch planning and adaptive tracker, each beside its plain torch
version.

``KERNELS`` lists the wrappers; each counts its launches in ``.launches``.
The wrappers run the plain version for CPU tensors and the CUDA kernel for
CUDA tensors (``common.library()`` builds it on first use).
"""

from .lookup_probe import (count_le, count_le_ref, interval_rank,
                           interval_rank_ref, lookup_probe,
                           lookup_probe_ref, rank_probe, rank_probe_ref)
from .run_coalesce import run_coalesce, run_coalesce_ref
from .segment_reduce import (gather_min64, gather_min64_ref, segment_sum,
                             segment_sum_ref)

KERNELS = (lookup_probe, rank_probe, count_le, run_coalesce, segment_sum,
           gather_min64)

__all__ = ["KERNELS", "count_le", "count_le_ref", "gather_min64",
           "gather_min64_ref", "interval_rank", "interval_rank_ref",
           "lookup_probe", "lookup_probe_ref", "rank_probe", "rank_probe_ref",
           "run_coalesce", "run_coalesce_ref", "segment_sum",
           "segment_sum_ref"]
