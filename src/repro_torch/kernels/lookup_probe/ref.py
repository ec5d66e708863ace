"""Plain torch versions of the lookup-probe kernels (CPU tensors).

Same integer outputs as ``repro.kernels.lookup_probe.ref``, over the full
u64 key range: keys are int64 tensors holding u64 bit patterns, ordered
through ``u64_order``.  The rank is a vectorized lower/upper-bound binary
search, the arithmetic each CUDA thread runs for its query.
"""

from __future__ import annotations

import torch

from ..common import u64_order


def bound_search(run: torch.Tensor, queries: torch.Tensor,
                 right: bool = False) -> torch.Tensor:
    """searchsorted over a sorted u64 run: #{run < q} (left) or
    #{run <= q} (right) per query.  -> (Q,) int64."""
    n = run.shape[0]
    ro, qo = u64_order(run), u64_order(queries)
    lo = torch.zeros_like(qo)
    hi = torch.full_like(qo, n)
    # each step at least halves every open [lo, hi): n.bit_length() close all
    for _ in range(n.bit_length()):
        mid = (lo + hi) >> 1
        v = ro[mid.clamp(max=n - 1)]
        go_right = (v <= qo) if right else (v < qo)
        open_ = lo < hi
        lo = torch.where(open_ & go_right, mid + 1, lo)
        hi = torch.where(open_ & ~go_right, mid, hi)
    return lo


def rank_probe_ref(queries: torch.Tensor, run: torch.Tensor):
    """queries (Q,) vs sorted unique run (N,).
    -> (found (Q,) bool, rank (Q,) int64), rank = #{run < query}."""
    n = run.shape[0]
    rank = bound_search(run, queries)
    if n == 0:
        return torch.zeros(queries.shape, dtype=torch.bool,
                           device=queries.device), rank
    found = (rank < n) & (run[rank.clamp(max=n - 1)] == queries)
    return found, rank


def lookup_probe_ref(queries: torch.Tensor, run: torch.Tensor,
                     bit_idx: torch.Tensor, words: torch.Tensor):
    """Fused bloom test + membership/rank.

    bit_idx (Q, k) pre-modulo'd filter bit indices; words (W,) the
    filter's u64 words.  -> (may (Q,) bool, found (Q,) bool, rank (Q,))."""
    w = words[bit_idx >> 6]                                   # (Q, k)
    # the arithmetic shift fills above bit 63 - s only, so bit s is exact
    may = ((w >> (bit_idx & 63)) & 1).bool().all(dim=1)
    found, rank = rank_probe_ref(queries, run)
    return may, found, rank


def count_le_ref(queries: torch.Tensor, mins: torch.Tensor) -> torch.Tensor:
    """#{mins <= query} per query (searchsorted side='right').  -> (Q,)."""
    return bound_search(mins, queries, right=True)


def interval_rank_ref(queries: torch.Tensor, mins: torch.Tensor,
                      maxs: torch.Tensor) -> torch.Tensor:
    """Index of the covering [min, max] interval per query, -1 if none:
    ``count_le - 1`` where the query is <= that interval's max.  -> (Q,)."""
    if mins.shape[0] == 0:
        return torch.full(queries.shape, -1, dtype=torch.int64,
                          device=queries.device)
    fidx = count_le_ref(queries, mins) - 1
    ok = fidx >= 0
    ok &= u64_order(queries) <= u64_order(maxs[fidx.clamp(min=0)])
    return torch.where(ok, fidx, -1)
