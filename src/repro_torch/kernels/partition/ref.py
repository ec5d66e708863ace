"""Plain torch version of the hot/cold partition kernel (CPU tensors).

Same outputs as ``repro.kernels.partition.ref``: a stable partition of the
records, hot first, and the hot count.
"""

from __future__ import annotations

import torch


def hot_cold_partition_ref(keys, hot, vids, vsizes):
    """-> (keys, vids, vsizes (N,) int32, n_hot (1,) int64)."""
    order = torch.sort((~hot).to(torch.int8), stable=True)[1]
    return (keys[order], vids[order], vsizes[order],
            hot.sum(dtype=torch.int64).reshape(1))
