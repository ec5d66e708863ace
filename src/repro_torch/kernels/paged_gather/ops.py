"""Wrapper of the paged gather kernel (``csrc/kernels.cu``).

CPU pages run the plain torch version (``ref.py``); CUDA pages launch the
CUDA kernel, which adds one to ``page_gather.launches``, or raise.  The
output is allocated here; the kernel allocates nothing.
"""

from __future__ import annotations

import torch

from ..common import launch, outputs
from .ref import page_gather_ref


def upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor's copy on ``device``."""
    return t.to(device, copy=True)


def page_gather(page_table: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """Gather pages through a page table into per-sequence buffers.

    page_table (B, P) int32 on the host (the page allocator's table), every
    entry in [0, N); pages (N, page_size, D) contiguous, any dtype.
    -> (B, P * page_size, D): row b is pages[table[b, 0]], ...,
    pages[table[b, P-1]] one after another.  An entry outside [0, N)
    raises ``ValueError`` (the reference's jnp gather would clamp it)."""
    if page_table.device.type != "cpu" or page_table.dtype != torch.int32 \
            or page_table.dim() != 2:
        raise ValueError(f"page_gather: the page table must be a (B, P) "
                         f"int32 tensor on the host, got {page_table.dtype} "
                         f"{tuple(page_table.shape)} on {page_table.device}")
    if pages.dim() != 3 or not pages.is_contiguous() \
            or pages.device.type not in ("cpu", "cuda"):
        raise ValueError(f"page_gather: pages must be a contiguous (N, "
                         f"page_size, D) tensor on the CPU or a card, got "
                         f"{tuple(pages.shape)} on {pages.device}")
    n, page_size, d = pages.shape
    if page_table.numel() and (int(page_table.min()) < 0
                               or int(page_table.max()) >= n):
        raise ValueError(f"page_gather: page table entries must lie in "
                         f"[0, {n})")
    dev = pages.device
    if dev.type == "cpu":
        return page_gather_ref(page_table, pages)
    b, p = page_table.shape
    (out,) = outputs(b * p * page_size * d, dev, pages.dtype)
    page_bytes = page_size * d * pages.element_size()
    if b * p and page_bytes:
        table = upload(page_table.contiguous(), dev)
        vec16 = page_bytes % 16 == 0 and pages.data_ptr() % 16 == 0 \
            and out.data_ptr() % 16 == 0
        launch("page_gather", dev, table.data_ptr(), b * p, pages.data_ptr(),
               page_bytes, int(vec16), out.data_ptr())
        page_gather.launches += 1
    return out.view(b, p * page_size, d)


page_gather.launches = 0
