"""Hand-written CUDA kernels (Hopper, ``sm_90a``) for the store's batched
probes, fetch planning and adaptive tracker, and for the GC-Lookup, bloom,
merge, partition and paged-gather work of the kernel benchmark, each
beside its plain torch version.

``KERNELS`` lists the wrappers; each counts its launches in ``.launches``
(``lookup_probe_segments`` on ``lookup_probe``, ``rank_probe_segments`` on
``rank_probe``, ``sketch_estimate`` on ``gather_min64`` and ``sketch_add``
on ``segment_sum``: each is another form of that kernel;
``rank_probe_segments`` and ``sketch_add`` also keep their own counts).
The wrappers run the plain version for CPU tensors and the CUDA kernel for
CUDA tensors (``common.library()`` builds it on first use).
"""

from .bloom import bloom_build, bloom_build_ref, bloom_probe, bloom_probe_ref
from .gc_lookup import gc_lookup, gc_lookup_ref
from .lookup_probe import (count_le, count_le_ref, interval_rank,
                           interval_rank_ref, lookup_probe,
                           lookup_probe_ref, lookup_probe_segments,
                           lookup_probe_segments_ref, rank_probe,
                           rank_probe_ref, rank_probe_segments,
                           rank_probe_segments_ref)
from .merge import merge_dedup, merge_dedup_ref
from .paged_gather import page_gather, page_gather_ref
from .partition import hot_cold_partition, hot_cold_partition_ref
from .run_coalesce import run_coalesce, run_coalesce_ref
from .segment_reduce import (gather_min64, gather_min64_ref, segment_sum,
                             segment_sum_ref, sketch_add, sketch_add_ref,
                             sketch_estimate, sketch_estimate_ref)

KERNELS = (lookup_probe, rank_probe, count_le, run_coalesce, segment_sum,
           gather_min64, gc_lookup, bloom_probe, merge_dedup,
           hot_cold_partition, page_gather)

__all__ = ["KERNELS", "bloom_build", "bloom_build_ref", "bloom_probe",
           "bloom_probe_ref", "count_le", "count_le_ref", "gather_min64",
           "gather_min64_ref", "gc_lookup", "gc_lookup_ref",
           "hot_cold_partition", "hot_cold_partition_ref", "interval_rank",
           "interval_rank_ref", "lookup_probe", "lookup_probe_ref",
           "lookup_probe_segments", "lookup_probe_segments_ref",
           "merge_dedup", "merge_dedup_ref", "page_gather", "page_gather_ref",
           "rank_probe", "rank_probe_ref", "rank_probe_segments",
           "rank_probe_segments_ref", "run_coalesce", "run_coalesce_ref",
           "segment_sum", "segment_sum_ref", "sketch_add", "sketch_add_ref",
           "sketch_estimate", "sketch_estimate_ref"]
