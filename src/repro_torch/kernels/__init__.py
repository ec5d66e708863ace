"""Hand-written CUDA kernels (Hopper, ``sm_90a``) for the store's batched
probes and fetch planning, each beside its plain torch version.

``KERNELS`` lists the wrappers; each counts its launches in ``.launches``.
The wrappers run the plain version for CPU tensors and the CUDA kernel for
CUDA tensors (``common.library()`` builds it on first use).
"""

from .lookup_probe import (count_le, count_le_ref, interval_rank,
                           interval_rank_ref, lookup_probe,
                           lookup_probe_ref, rank_probe, rank_probe_ref)
from .run_coalesce import run_coalesce, run_coalesce_ref

KERNELS = (lookup_probe, rank_probe, count_le, run_coalesce)

__all__ = ["KERNELS", "count_le", "count_le_ref", "interval_rank",
           "interval_rank_ref", "lookup_probe", "lookup_probe_ref",
           "rank_probe", "rank_probe_ref", "run_coalesce",
           "run_coalesce_ref"]
