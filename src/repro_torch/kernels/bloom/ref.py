"""Plain torch versions of the bloom filter build and probe.

Same bits as ``repro.kernels.bloom.ref``: ``h1 = mix32(q)``,
``h2 = mix32(q ^ MIX1) | 1`` (the murmur3 finalizer) and bit ``j`` at
``(h1 + j*h2) mod nbits``, in wrapping u32 arithmetic.  Keys and filter
words are int32 tensors holding u32 bit patterns (``kernels/common.py``);
the arithmetic runs on their int64 values, masked to 32 bits after every
step that could leave them, and each multiply by a 32-bit constant is split
in 16-bit halves so no product passes 2^49.

``bloom_build_ref`` is the filter build (an OR-scatter of bits packed into
u32 words).  The reference has no Pallas kernel for it, so it is a torch
function on both devices, not a kernel.  ``bloom_probe_ref`` runs for CPU
tensors.
"""

from __future__ import annotations

import torch

from ..common import U32_MAX, u32_bits, u32_values

MIX1 = 0x85EBCA6B
MIX2 = 0xC2B2AE35


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for values a in [0, 2^32) and a u32 constant c."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32_MAX


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The murmur3 finalizer on int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, MIX1)
    x = x ^ (x >> 13)
    x = _mul32(x, MIX2)
    return x ^ (x >> 16)


def bloom_hashes(keys: torch.Tensor, k: int, nbits: int) -> torch.Tensor:
    """keys (Q,) u32 bit views -> (k, Q) int64 bit indices in [0, nbits)."""
    x = u32_values(keys)
    h1 = mix32(x)
    h2 = mix32(x ^ MIX1) | 1
    js = torch.arange(k, dtype=torch.int64, device=keys.device)[:, None]
    return ((h1[None, :] + js * h2[None, :]) & U32_MAX) % nbits


def bloom_build_ref(keys: torch.Tensor, k: int, nbits: int) -> torch.Tensor:
    """-> (nbits // 32,) int32 words (u32 bit views) with the keys' bits
    set; bit b lives in word b >> 5 at position b & 31."""
    if nbits <= 0 or nbits % 32:
        raise ValueError(f"bloom_build: nbits must be a positive multiple "
                         f"of 32, got {nbits}")
    bits = torch.zeros(nbits, dtype=torch.bool, device=keys.device)
    bits[bloom_hashes(keys, k, nbits).reshape(-1)] = True
    shifts = torch.arange(32, dtype=torch.int64, device=keys.device)
    words = (bits.view(-1, 32).to(torch.int64) << shifts).sum(dim=1)
    return u32_bits(words)


def bloom_probe_ref(queries: torch.Tensor, words: torch.Tensor, k: int,
                    nbits: int) -> torch.Tensor:
    """-> (Q,) bool: every one of the query's k bits is set."""
    idx = bloom_hashes(queries, k, nbits)
    w = u32_values(words)[idx >> 5]
    return ((w >> (idx & 31)) & 1).eq(1).all(dim=0)
