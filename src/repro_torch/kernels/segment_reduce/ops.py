"""Wrappers of the segment-reduce kernels (``csrc/kernels.cu``) that carry
the adaptive tracker's sketch and lifetime-histogram updates and its
count-min estimate.

CPU tensors run the plain torch version (``ref.py``); CUDA tensors launch
the CUDA kernel, which adds one to the wrapper's ``launches``, or raise.
Outputs are allocated here; the kernels allocate nothing.
"""

from __future__ import annotations

import torch

from ..common import check_columns, launch, outputs
from .ref import gather_min64_ref, segment_sum_ref


def segment_sum(ids: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Occurrence count per slot of an id column; ids outside
    [0, n_slots) are ignored.  ids (P,) int64 -> (n_slots,) int64."""
    dev = check_columns("segment_sum", ids)
    n_slots = int(n_slots)
    if ids.dim() != 1 or n_slots < 0:
        raise ValueError(f"segment_sum: want 1-d ids and n_slots >= 0, got "
                         f"{tuple(ids.shape)} and {n_slots}")
    if dev.type == "cpu":
        return segment_sum_ref(ids, n_slots)
    (out,) = outputs(n_slots, dev, torch.int64)
    p = ids.shape[0]
    if n_slots:
        launch("segment_sum", dev, ids.data_ptr(), p, n_slots,
               out.data_ptr())
        if p:
            segment_sum.launches += 1
    return out


segment_sum.launches = 0


def gather_min64(bits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Count-min read: per query, the minimum in u64 order of the D
    patterns ``bits[r, idx[q, r]]``.  bits (D, W) int64 (the bit view of
    float64 counters), idx (Q, D) int64 in [0, W) -> (Q,) int64 patterns
    (view them as float64)."""
    dev = check_columns("gather_min64", bits, idx)
    if bits.dim() != 2 or bits.shape[0] < 1 or idx.dim() != 2 \
            or idx.shape[1] != bits.shape[0]:
        raise ValueError(f"gather_min64: want bits (D, W) with D >= 1 and "
                         f"idx (Q, D), got {tuple(bits.shape)} and "
                         f"{tuple(idx.shape)}")
    if dev.type == "cpu":
        return gather_min64_ref(bits, idx)
    d, w = bits.shape
    q = idx.shape[0]
    (out,) = outputs(q, dev, torch.int64)
    if q:
        launch("gather_min64", dev, bits.data_ptr(), d, w, idx.data_ptr(), q,
               out.data_ptr())
        gather_min64.launches += 1
    return out


gather_min64.launches = 0
