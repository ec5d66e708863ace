"""Wrapper of the GC-Lookup kernel (``csrc/kernels.cu``).

CPU tensors run the plain torch version (``ref.py``); CUDA tensors launch
the CUDA kernel, which adds one to ``gc_lookup.launches``, or raise.
Outputs are allocated here; the kernel allocates nothing.  The kernel
reads a search's last keys 16 bytes a load where the key column is
16-byte aligned, else one at a time.

Columns are int32 tensors holding u32 bit patterns.  The reference wrapper
also takes u64 columns and asserts that their keys lie below 2^32 - 2; the
port adds no wider key range, so it refuses every int64 (u64) column with
a ``ValueError``.
"""

from __future__ import annotations

import torch

from ..common import check_u32_columns, launch, outputs
from .ref import gc_lookup_ref


def gc_lookup(queries: torch.Tensor, keys: torch.Tensor, vids: torch.Tensor,
              vfiles: torch.Tensor):
    """Exact-match lookup of each query in an ascending run of (keys, vids,
    vfiles); with duplicate keys the first entry answers.
    -> (found (Q,) bool, vid (Q,) int32, vfile (Q,) int32), zeros on a
    miss."""
    dev = check_u32_columns("gc_lookup", queries, keys, vids, vfiles)
    n = keys.shape[0]
    if vids.shape[0] != n or vfiles.shape[0] != n:
        raise ValueError("gc_lookup: keys, vids and vfiles differ in length")
    if dev.type == "cpu":
        return gc_lookup_ref(queries, keys, vids, vfiles)
    q = queries.shape[0]
    found, vid, vfile = outputs(q, dev, torch.bool, torch.int32, torch.int32)
    if q:
        launch("gc_lookup", dev, queries.data_ptr(), q, keys.data_ptr(),
               vids.data_ptr(), vfiles.data_ptr(), n, found.data_ptr(),
               vid.data_ptr(), vfile.data_ptr(),
               int(keys.data_ptr() % 16 == 0))
        gc_lookup.launches += 1
    return found, vid, vfile


gc_lookup.launches = 0
