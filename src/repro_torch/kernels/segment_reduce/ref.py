"""Plain torch versions of the segment-reduce kernels (CPU tensors).

Same integer outputs as ``repro.kernels.segment_reduce.ref``.  The sketch's
float64 counters travel as int64 tensors holding their bit patterns
(``ndarray.view(np.int64)``) and the minimum is taken in u64 order
(``u64_order``), the order of the reference's lexicographic (hi, lo) u32
compare.
"""

from __future__ import annotations

import torch

from ..common import splitmix64, u64_mod, u64_order


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


def sketch_estimate_ref(bits: torch.Tensor, keys: torch.Tensor,
                        seeds: torch.Tensor) -> torch.Tensor:
    """bits (D, W) int64 patterns, keys (Q,) and seeds (D,) int64 u64
    patterns -> (Q,) int64: ``gather_min64_ref`` at the sketch's row hash
    ``splitmix64(key ^ seeds[r]) % W`` (u64)."""
    cols = u64_mod(splitmix64(keys[:, None] ^ seeds[None, :]), bits.shape[1])
    return gather_min64_ref(bits, cols)


def sketch_add_ref(counts: torch.Tensor, keys: torch.Tensor,
                   seeds: torch.Tensor, scale: float | None = None) -> None:
    """counts (D, W) float64, changed in place; keys (Q,) and seeds (D,)
    int64 u64 patterns.  ``scale``: every counter times it first.  Then
    per row, the keys' occurrence counts at ``splitmix64(key ^ seeds[r])
    % W`` (u64), added as one float64 add per slot."""
    if scale is not None:
        counts.mul_(scale)
    d, w = counts.shape
    cols = u64_mod(splitmix64(keys[:, None] ^ seeds[None, :]), w)
    for r in range(d):
        cnt = torch.zeros(w, dtype=torch.int64, device=counts.device)
        cnt.index_add_(0, cols[:, r], torch.ones_like(cols[:, r]))
        counts[r] += cnt.to(torch.float64)
