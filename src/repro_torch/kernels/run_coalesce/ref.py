"""Plain torch version of the run-coalescing kernel (CPU tensors).

Same outputs as ``repro.kernels.run_coalesce.ref``.  Each (rank, pos) pair
packs into one u64 ``rank << 32 | pos``, the column pads to a power of two
with all-ones pairs (which sort after every real pair), and a bitonic
network sorts it — the CUDA kernel's algorithm, written with tensor ops.
The dedup and run marks are the reference's shifted compares and scans.
"""

from __future__ import annotations

import torch

from ..common import U32_MAX, next_pow2, u64_order


def bitonic_sort_u64(keys: torch.Tensor) -> torch.Tensor:
    """Ascending u64 sort of a power-of-two int64 column (bit patterns)."""
    o = u64_order(keys)
    n = o.shape[0]
    idx = torch.arange(n, device=keys.device)
    k = 2
    while k <= n:
        j = k >> 1
        while j > 0:
            partner = idx ^ j
            b = o[partner]
            # the lower index of an ascending pair keeps the min, of a
            # descending pair the max; the partner takes the other
            keep_min = (idx < partner) == ((idx & k) == 0)
            o = torch.where(keep_min, torch.minimum(o, b),
                            torch.maximum(o, b))
            j >>= 1
        k <<= 1
    return u64_order(o)


def run_coalesce_ref(rank: torch.Tensor, pos: torch.Tensor, window=None):
    """rank/pos (M,) int64 in [0, 2^32 - 1) -> (rank_s, pos_s int64, keep,
    run_start bool), all (M,) sorted by the lexicographic (rank, pos)."""
    m = rank.shape[0]
    mp = max(2, next_pow2(m))
    packed = torch.full((mp,), -1, dtype=torch.int64, device=rank.device)
    packed[:m] = (rank << 32) | pos
    s = bitonic_sort_u64(packed)[:m]
    r, p = (s >> 32) & U32_MAX, s & U32_MAX
    i0 = torch.arange(m, device=rank.device) == 0
    prev_r = torch.cat([r.new_zeros(1), r[:-1]])
    prev_p = torch.cat([p.new_zeros(1), p[:-1]])
    keep = i0 | (r != prev_r) | (p != prev_p)
    gap = ((p - prev_p) & U32_MAX) > 1          # u32 difference, as the ref
    start = (i0 | (r != prev_r) | gap) & keep
    if window is not None:
        kept = torch.cumsum(keep.to(torch.int64), 0)
        base = torch.cummax(torch.where(start, kept, 0), 0).values
        start = start | (keep & ((kept - base) % window == 0))
    return r, p, keep, start
