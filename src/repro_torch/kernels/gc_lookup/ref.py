"""Plain torch version of the GC-Lookup kernel (CPU tensors).

Same outputs as ``repro.kernels.gc_lookup.ref``: the first run entry equal
to the query (searchsorted side='left') gives vid and vfile.  Columns are
int32 tensors holding u32 bit patterns (``kernels/common.py``).
"""

from __future__ import annotations

import torch

from ..common import u32_values


def gc_lookup_ref(queries: torch.Tensor, keys: torch.Tensor,
                  vids: torch.Tensor, vfiles: torch.Tensor):
    """queries (Q,); ascending run keys, vids, vfiles (N,).
    -> (found (Q,) bool, vid (Q,) int32, vfile (Q,) int32)."""
    q, n = queries.shape[0], keys.shape[0]
    if n == 0:
        z = torch.zeros(q, dtype=torch.int32, device=queries.device)
        return torch.zeros(q, dtype=torch.bool, device=queries.device), z, \
            z.clone()
    kv, qv = u32_values(keys), u32_values(queries)
    pos = torch.searchsorted(kv, qv).clamp_(max=n - 1)
    found = kv[pos] == qv
    zero = torch.zeros((), dtype=torch.int32, device=queries.device)
    return (found, torch.where(found, vids[pos], zero),
            torch.where(found, vfiles[pos], zero))
