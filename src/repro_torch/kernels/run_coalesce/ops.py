"""Wrapper of the run-coalescing kernel (``csrc/kernels.cu``).

CPU tensors run the plain torch version (``ref.py``); CUDA tensors launch
the CUDA kernel, which adds one to ``run_coalesce.launches``, or raise.
"""

from __future__ import annotations

import torch

from ..common import (U32_MAX, check_columns, launch, next_pow2, outputs,
                      smem_sort_cap)
from .ref import run_coalesce_ref


def run_coalesce(rank: torch.Tensor, pos: torch.Tensor, *, window=None):
    """Plan coalesced I/O runs for (file-rank, record-position) pairs.

    rank/pos (M,) int64 in [0, 2^32 - 1).  -> (rank_s, pos_s int64, keep,
    run_start bool), all (M,) sorted by (rank, pos); duplicates have keep
    False, and run_start marks the first kept record of each adjacent run
    (capped at ``window`` kept records per run when set).

    The range is checked here for CPU operands only: on the card the check
    would cost several launches and a synchronisation per call, so the
    caller checks its host columns before the upload
    (``core/accel.py:plan_runs``); the kernel packs each pair as
    ``rank << 32 | pos`` and would misorder values outside the range."""
    dev = check_columns("run_coalesce", rank, pos)
    m = rank.shape[0]
    if pos.shape[0] != m:
        raise ValueError("run_coalesce: rank and pos differ in length")
    if window is not None and int(window) < 1:
        raise ValueError(f"run_coalesce: window must be >= 1, got {window}")
    if m == 0:
        e = torch.zeros(0, dtype=torch.int64, device=dev)
        b = torch.zeros(0, dtype=torch.bool, device=dev)
        return e, e.clone(), b, b.clone()
    if dev.type == "cpu":
        if bool(((rank < 0) | (rank >= U32_MAX) | (pos < 0)
                 | (pos >= U32_MAX)).any()):
            raise ValueError("run_coalesce: rank and pos must lie in "
                             "[0, 2^32 - 1)")
        return run_coalesce_ref(rank, pos, window)
    mp = max(2, next_pow2(m))
    outs = outputs(m, dev, torch.int64, torch.int64, torch.bool, torch.bool)
    # global-memory sort buffer, only for columns past the shared-memory cap
    scratch = (torch.empty(mp, dtype=torch.int64, device=dev)
               if mp > smem_sort_cap() else None)
    launch("run_coalesce", dev, rank.data_ptr(), pos.data_ptr(), m, mp,
           None if scratch is None else scratch.data_ptr(),
           0 if window is None else int(window),
           *(o.data_ptr() for o in outs))
    run_coalesce.launches += 1
    return outs


run_coalesce.launches = 0
