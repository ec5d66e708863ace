"""Plain torch versions of the segment-reduce kernels (CPU tensors).

Same integer outputs as ``repro.kernels.segment_reduce.ref``.  The sketch's
float64 counters travel as int64 tensors holding their bit patterns
(``ndarray.view(np.int64)``) and the minimum is taken in u64 order
(``u64_order``), the order of the reference's lexicographic (hi, lo) u32
compare.
"""

from __future__ import annotations

import torch

from ..common import u64_order


def segment_sum_ref(ids: torch.Tensor, n_slots: int) -> torch.Tensor:
    """ids (P,) int64 -> (n_slots,) int64 occurrence counts; ids outside
    [0, n_slots) are ignored (the reference masks with -1)."""
    valid = ids[(ids >= 0) & (ids < n_slots)]
    out = torch.zeros(n_slots, dtype=torch.int64, device=ids.device)
    return out.index_add_(0, valid, torch.ones_like(valid))


def gather_min64_ref(bits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """bits (D, W) int64 bit patterns, idx (Q, D) int64 slot per row
    -> (Q,) int64: the pattern of min over rows of ``bits[r, idx[:, r]]``,
    compared as u64.  An index outside [0, W) fetches the pattern 0."""
    d, w = bits.shape
    ok = (idx >= 0) & (idx < w)
    rows = torch.arange(d, device=bits.device)
    got = bits[rows[None, :], idx.clamp(0, max(w - 1, 0))] if w else \
        torch.zeros(idx.shape, dtype=torch.int64, device=bits.device)
    got = torch.where(ok, got, torch.zeros_like(got))
    return u64_order(u64_order(got).amin(dim=1))
