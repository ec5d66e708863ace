"""Plain torch version of the paged gather kernel (CPU tensors).

Same output as ``repro.kernels.paged_gather.ref``.
"""

from __future__ import annotations

import torch


def page_gather_ref(page_table: torch.Tensor,
                    pages: torch.Tensor) -> torch.Tensor:
    """page_table (B, P) int32, pages (N, page_size, D)
    -> (B, P * page_size, D) of pages' dtype."""
    b, p = page_table.shape
    _, page_size, d = pages.shape
    idx = page_table.reshape(-1).to(device=pages.device, dtype=torch.int64)
    return pages[idx].reshape(b, p * page_size, d)
