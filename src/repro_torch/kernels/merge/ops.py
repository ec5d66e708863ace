"""Wrapper of the compaction merge kernel (``csrc/kernels.cu``).

CPU tensors run the plain torch version (``ref.py``); CUDA tensors launch
the CUDA kernel, which adds one to ``merge_dedup.launches``, or raise.
Outputs are allocated here; the kernel allocates nothing.  Columns are
int32 tensors holding u32 bit patterns (``kernels/common.py``).
"""

from __future__ import annotations

import torch

from ..common import check_u32_columns, launch, outputs
from .ref import merge_dedup_ref


def merge_dedup(ak, aseq, avid, bk, bseq, bvid):
    """Merge two runs of (key, seq, vid) with newest-wins dedup.

    -> (keys, seqs, vids (NA + NB,) int32, keep (NA + NB,) bool): A's rows
    then B's in (key asc, seq desc) order, ties in input order (A first),
    and ``keep`` marking the first row of each key (its newest version).

    Precondition on the card: each run is already in (key asc, seq desc)
    order, as an engine run (unique keys, ascending) is; the kernel places
    each row by its co-rank in the other run and does not sort.  The plain
    version sorts, so it holds on any input."""
    dev = check_u32_columns("merge_dedup", ak, aseq, avid, bk, bseq, bvid)
    na, nb = ak.shape[0], bk.shape[0]
    if aseq.shape[0] != na or avid.shape[0] != na or bseq.shape[0] != nb \
            or bvid.shape[0] != nb:
        raise ValueError("merge_dedup: a run's keys, seqs and vids differ "
                         "in length")
    if dev.type == "cpu":
        return merge_dedup_ref(ak, aseq, avid, bk, bseq, bvid)
    n = na + nb
    outs = outputs(n, dev, torch.int32, torch.int32, torch.int32, torch.bool)
    if n:
        launch("merge_dedup", dev, ak.data_ptr(), aseq.data_ptr(),
               avid.data_ptr(), na, bk.data_ptr(), bseq.data_ptr(),
               bvid.data_ptr(), nb, *(o.data_ptr() for o in outs))
        merge_dedup.launches += 1
    return outs


merge_dedup.launches = 0
