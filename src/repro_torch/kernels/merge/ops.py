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

# Rows a thread of the merge kernel merges: 8 (a tile of 256 x 8 rows a
# CTA) from WIDE_ROWS rows on, else 1, which spreads a short merge over
# more SMs.  Measured (PERF.md §6).
ITEMS = (1, 8)
WIDE_ROWS = 1 << 17


def merge_dedup(ak, aseq, avid, bk, bseq, bvid, *, _items: int | None = None):
    """Merge two runs of (key, seq, vid) with newest-wins dedup.

    -> (keys, seqs, vids (NA + NB,) int32, keep (NA + NB,) bool): A's rows
    then B's in (key asc, seq desc) order, ties in input order (A first),
    and ``keep`` marking the first row of each key (its newest version).

    Precondition on the card: each run is already in (key asc, seq desc)
    order, as an engine run (unique keys, ascending) is; the kernel merges
    along the merge path and does not sort.  The plain version sorts, so it
    holds on any input.  ``_items`` sets the rows a thread merges (1 or 8)
    in place of the choice by ``WIDE_ROWS``, for the tests and the timing
    of the choice."""
    dev = check_u32_columns("merge_dedup", ak, aseq, avid, bk, bseq, bvid)
    na, nb = ak.shape[0], bk.shape[0]
    if aseq.shape[0] != na or avid.shape[0] != na or bseq.shape[0] != nb \
            or bvid.shape[0] != nb:
        raise ValueError("merge_dedup: a run's keys, seqs and vids differ "
                         "in length")
    if dev.type == "cpu":
        return merge_dedup_ref(ak, aseq, avid, bk, bseq, bvid)
    n = na + nb
    if _items is None:
        _items = ITEMS[n >= WIDE_ROWS]
    if _items not in ITEMS:
        raise ValueError(f"merge_dedup: {_items} rows a thread, not one of "
                         f"{ITEMS}")
    outs = outputs(n, dev, torch.int32, torch.int32, torch.int32, torch.bool)
    if n:
        launch("merge_dedup", dev, ak.data_ptr(), aseq.data_ptr(),
               avid.data_ptr(), na, bk.data_ptr(), bseq.data_ptr(),
               bvid.data_ptr(), nb, *(o.data_ptr() for o in outs), _items)
        merge_dedup.launches += 1
    return outs


merge_dedup.launches = 0
