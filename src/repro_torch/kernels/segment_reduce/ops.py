"""Wrappers of the segment-reduce kernels (``csrc/kernels.cu``) that carry
the adaptive tracker's sketch adds (``sketch_add``: ``segment_sum``'s key
form, the row hash and the add into the counters on the card), its
lifetime-histogram adds (``segment_sum``) and its count-min estimate
(``sketch_estimate``: the row hash inside the ``gather_min64`` kernel).

CPU tensors run the plain torch version (``ref.py``); CUDA tensors launch
the CUDA kernel, which adds one to the wrapper's ``launches``, or raise.
Outputs are allocated here; the kernels allocate nothing.
"""

from __future__ import annotations

import torch

from ..common import check_columns, fast_mod_magic, launch, outputs
from .ref import (gather_min64_ref, segment_sum_ref, sketch_add_ref,
                  sketch_estimate_ref)


def segment_sum(ids: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Occurrence count per slot of an id column; ids outside
    [0, n_slots) are ignored.  ids (P,) int64 -> (n_slots,) int64.

    On the card one launch writes every count, zeros included (no
    memset); past 4,096 ids, or 131,072 slots with any ids (``kernels.cu``
    ``kSegMaxIds``, ``kSegMaxSlots``), the counts are zeroed by a memset
    and added with one atomic an id."""
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
        segment_sum.launches += 1
    return out


segment_sum.launches = 0

_MAX_ROWS = 65535       # the scratch path's grid rows


def sketch_add(counts: torch.Tensor, keys: torch.Tensor, seeds: torch.Tensor,
               *, scale: float | None = None,
               scratch: torch.Tensor | None = None) -> None:
    """The count-min sketch's add, in place: for every row r, slot
    ``splitmix64(key ^ seeds[r]) % W`` of ``counts[r]`` receives the number
    of keys that hash to it, as one float64 add of that integer total (the
    host's ``counts[r] += np.bincount(...)``).  ``scale``: a decay factor
    every counter is multiplied by first (one IEEE multiply, the host's
    ``counts *= scale``); with no keys, the call only scales.

    counts (D, W) float64; keys (Q,) and seeds (D,) int64 u64 patterns.
    ``scratch``: on the card, a zeroed (D * W,) int32 tensor of counts that
    the call leaves zero (one is made here when none is given).  Launches
    count on ``segment_sum``, whose key form this is, and on
    ``sketch_add``."""
    dev = check_columns("sketch_add", keys, seeds)
    if counts.dtype != torch.float64 or counts.dim() != 2 \
            or not counts.is_contiguous() or counts.device != dev:
        raise ValueError(f"sketch_add: want contiguous (D, W) float64 "
                         f"counts on {dev}, got {counts.dtype} "
                         f"{tuple(counts.shape)} on {counts.device}")
    d, w = counts.shape
    if not 1 <= d <= _MAX_ROWS or w < 1 or keys.dim() != 1 \
            or tuple(seeds.shape) != (d,):
        raise ValueError(f"sketch_add: want D in [1, {_MAX_ROWS}], W >= 1, "
                         f"keys (Q,) and seeds (D,), got "
                         f"{tuple(counts.shape)}, {tuple(keys.shape)} and "
                         f"{tuple(seeds.shape)}")
    if dev.type == "cpu":
        sketch_add_ref(counts, keys, seeds, scale)
        return
    q = keys.shape[0]
    if q == 0 and scale is None:
        return
    if q:
        if scratch is None:
            (scratch,) = outputs(d * w, dev, torch.int32)
            scratch.zero_()
        elif scratch.dtype != torch.int32 or scratch.numel() != d * w \
                or not scratch.is_contiguous() or scratch.device != dev:
            raise ValueError(f"sketch_add: want a contiguous ({d * w},) "
                             f"int32 scratch on {dev}")
    launch("sketch_add", dev, counts.data_ptr(), d, w, *fast_mod_magic(w),
           keys.data_ptr(), q, seeds.data_ptr(), int(scale is not None),
           1.0 if scale is None else float(scale),
           None if scratch is None else scratch.data_ptr())
    segment_sum.launches += 1
    sketch_add.launches += 1


sketch_add.launches = 0


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


def sketch_estimate(bits: torch.Tensor, keys: torch.Tensor,
                    seeds: torch.Tensor) -> torch.Tensor:
    """The count-min estimate with the row hash on the card: per key, the
    minimum in u64 order of ``bits[r, splitmix64(key ^ seeds[r]) % W]``
    over the D rows (``DecaySketch._rows`` and ``gather_min64`` in one
    pass).  bits (D, W) int64 patterns, keys (Q,) and seeds (D,) int64
    u64 patterns -> (Q,) int64 patterns.  Launches count on
    ``gather_min64``, whose kernel this is."""
    dev = check_columns("sketch_estimate", bits, keys, seeds)
    if bits.dim() != 2 or bits.shape[0] < 1 or bits.shape[1] < 1 \
            or keys.dim() != 1 or tuple(seeds.shape) != (bits.shape[0],):
        raise ValueError(f"sketch_estimate: want bits (D, W) with D, W >= 1, "
                         f"keys (Q,) and seeds (D,), got {tuple(bits.shape)}, "
                         f"{tuple(keys.shape)} and {tuple(seeds.shape)}")
    if dev.type == "cpu":
        return sketch_estimate_ref(bits, keys, seeds)
    d, w = bits.shape
    q = keys.shape[0]
    (out,) = outputs(q, dev, torch.int64)
    if q:
        launch("sketch_estimate", dev, bits.data_ptr(), d, w,
               *fast_mod_magic(w), keys.data_ptr(), seeds.data_ptr(), q,
               out.data_ptr())
        gather_min64.launches += 1
    return out
