"""Wrappers of the lookup-probe kernels (``csrc/kernels.cu``).

Each wrapper checks its operands, then runs the plain torch version
(``ref.py``) for CPU tensors, or launches its CUDA kernel for CUDA tensors
and adds one to its ``launches`` count.  A CUDA operand never reaches the
plain version: the kernel runs or the wrapper raises.  Outputs are
allocated here; the kernels allocate nothing.

Operands are int64 tensors holding u64 bit patterns (keys, filter words,
bit indices); sorted runs are ascending in u64 order and may be empty.
"""

from __future__ import annotations

import torch

from ..common import check_columns, launch, outputs
from .ref import (count_le_ref, interval_rank_ref, lookup_probe_ref,
                  rank_probe_ref)


def rank_probe(queries: torch.Tensor, run: torch.Tensor):
    """Membership and searchsorted-left rank of each query in a sorted
    unique run.  -> (found (Q,) bool, rank (Q,) int64)."""
    dev = check_columns("rank_probe", queries, run)
    if dev.type == "cpu":
        return rank_probe_ref(queries, run)
    q, n = queries.shape[0], run.shape[0]
    found, rank = outputs(q, dev, torch.bool, torch.int64)
    if q:
        launch("rank_probe", dev, queries.data_ptr(), q, run.data_ptr(), n,
               found.data_ptr(), rank.data_ptr())
        rank_probe.launches += 1
    return found, rank


rank_probe.launches = 0


def lookup_probe(queries: torch.Tensor, run: torch.Tensor,
                 bit_idx: torch.Tensor, words: torch.Tensor):
    """Fused bloom test (AND of the k bits ``bit_idx`` (Q, k) names in the
    filter's u64 ``words``) plus membership/rank in the sorted run.
    -> (may (Q,) bool, found (Q,) bool, rank (Q,) int64)."""
    dev = check_columns("lookup_probe", queries, run, bit_idx, words)
    q = queries.shape[0]
    if bit_idx.dim() != 2 or bit_idx.shape[0] != q:
        raise ValueError(f"lookup_probe: bit_idx must be ({q}, k), got "
                         f"{tuple(bit_idx.shape)}")
    if dev.type == "cpu":
        return lookup_probe_ref(queries, run, bit_idx, words)
    k = bit_idx.shape[1]
    may, found, rank = outputs(q, dev, torch.bool, torch.bool, torch.int64)
    if q:
        launch("lookup_probe", dev, queries.data_ptr(), q, run.data_ptr(),
               run.shape[0], bit_idx.data_ptr(), k, words.data_ptr(),
               may.data_ptr(), found.data_ptr(), rank.data_ptr())
        lookup_probe.launches += 1
    return may, found, rank


lookup_probe.launches = 0


def count_le(queries: torch.Tensor, mins: torch.Tensor) -> torch.Tensor:
    """#{mins <= query} per query over a sorted column (searchsorted
    side='right').  -> (Q,) int64."""
    dev = check_columns("count_le", queries, mins)
    if dev.type == "cpu":
        return count_le_ref(queries, mins)
    return _count_le_launch(dev, queries, mins, None)


count_le.launches = 0


def _count_le_launch(dev, queries, mins, maxs) -> torch.Tensor:
    q = queries.shape[0]
    (cnt,) = outputs(q, dev, torch.int64)
    if q:
        launch("count_le", dev, queries.data_ptr(), q, mins.data_ptr(),
               mins.shape[0], None if maxs is None else maxs.data_ptr(),
               int(maxs is not None), cnt.data_ptr())
        count_le.launches += 1
    return cnt


def interval_rank(queries: torch.Tensor, mins: torch.Tensor,
                  maxs: torch.Tensor) -> torch.Tensor:
    """Index of the covering [min, max] interval per query, -1 if none.

    ``mins`` ascending, intervals disjoint (an LSM level's file bounds):
    ``count_le - 1``, checked against the interval's max.  On the card the
    check runs inside the ``count_le`` kernel (one launch).  -> (Q,) int64."""
    dev = check_columns("interval_rank", queries, mins, maxs)
    if mins.shape[0] != maxs.shape[0]:
        raise ValueError("interval_rank: mins and maxs differ in length")
    if dev.type == "cpu":
        return interval_rank_ref(queries, mins, maxs)
    return _count_le_launch(dev, queries, mins, maxs)
