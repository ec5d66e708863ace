"""Wrapper of the hot/cold partition kernel (``csrc/kernels.cu``).

CPU tensors run the plain torch version (``ref.py``); CUDA tensors launch
the CUDA kernel, which adds one to ``hot_cold_partition.launches``, or
raise.  Outputs and the per-tile scratch are allocated here; the kernel
allocates nothing.  keys, vids and vsizes are int32 tensors holding u32
bit patterns (``kernels/common.py``), hot a bool tensor.  The kernel loads
16 bytes a thread where all four operands are 16-byte aligned, else one
value at a time.
"""

from __future__ import annotations

import torch

from ..common import check_u32_columns, launch, outputs, partition_tile
from .ref import hot_cold_partition_ref


def hot_cold_partition(keys, hot, vids, vsizes):
    """Stable hot-first partition of the records (keys, vids, vsizes).
    -> (keys, vids, vsizes (N,) int32, n_hot (1,) int64)."""
    dev = check_u32_columns("hot_cold_partition", keys, vids, vsizes)
    n = keys.shape[0]
    if hot.dtype != torch.bool or hot.shape != (n,) \
            or not hot.is_contiguous() or hot.device != dev \
            or vids.shape[0] != n or vsizes.shape[0] != n:
        raise ValueError("hot_cold_partition: want keys, vids, vsizes and a "
                         "contiguous bool hot mask of one length on one "
                         "device")
    if dev.type == "cpu":
        return hot_cold_partition_ref(keys, hot, vids, vsizes)
    outs = outputs(n, dev, torch.int32, torch.int32, torch.int32)
    if n == 0:
        return (*outs, torch.zeros(1, dtype=torch.int64, device=dev))
    tile = partition_tile()
    n_hot, scratch = outputs(1, dev, torch.int64) + outputs(
        (n + tile - 1) // tile, dev, torch.int32)
    vec16 = all(t.data_ptr() % 16 == 0 for t in (keys, hot, vids, vsizes))
    launch("hot_cold_partition", dev, keys.data_ptr(), hot.data_ptr(),
           vids.data_ptr(), vsizes.data_ptr(), n, scratch.data_ptr(),
           *(o.data_ptr() for o in outs), n_hot.data_ptr(), int(vec16))
    hot_cold_partition.launches += 1
    return (*outs, n_hot)


hot_cold_partition.launches = 0
