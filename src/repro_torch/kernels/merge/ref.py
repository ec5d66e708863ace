"""Plain torch version of the compaction merge kernel (CPU tensors).

Same rows as ``repro.kernels.merge.ref``: A's rows then B's, ordered by
``lexsort((0xFFFFFFFF - seq, key))`` (key ascending, seq descending, ties
in input order) and ``keep`` true where the key differs from the previous
row's.  Columns are int32 tensors holding u32 bit patterns.  It sorts, so
unlike the kernel it needs no order within the runs.
"""

from __future__ import annotations

import torch

from ..common import u32_values


def merge_dedup_ref(ak, aseq, avid, bk, bseq, bvid):
    """-> (keys, seqs, vids (NA + NB,) int32, keep (NA + NB,) bool)."""
    keys = torch.cat([ak, bk])
    seqs = torch.cat([aseq, bseq])
    vids = torch.cat([avid, bvid])
    # lexsort as two stable passes: the minor key first, then the major
    by_seq = torch.sort(u32_values(seqs), descending=True, stable=True)[1]
    by_key = torch.sort(u32_values(keys)[by_seq], stable=True)[1]
    order = by_seq[by_key]
    keys, seqs, vids = keys[order], seqs[order], vids[order]
    keep = torch.ones(keys.shape[0], dtype=torch.bool, device=keys.device)
    keep[1:] = keys[1:] != keys[:-1]
    return keys, seqs, vids, keep
