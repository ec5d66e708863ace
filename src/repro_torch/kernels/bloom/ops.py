"""Bloom filter build and the wrapper of the bloom-probe kernel
(``csrc/kernels.cu``).

``bloom_probe``: CPU tensors run the plain torch version (``ref.py``);
CUDA tensors launch the CUDA kernel, which adds one to
``bloom_probe.launches``, or raise.  ``bloom_build`` is a torch function on
either device (the reference has no kernel for it).

Keys and filter words are int32 tensors holding u32 bit patterns
(``kernels/common.py``), as the reference's u32 lanes.
"""

from __future__ import annotations

import torch

from ..common import (U32_MAX, check_u32_columns, fast_mod_magic, launch,
                      outputs)
from .ref import bloom_build_ref, bloom_probe_ref

# The reference kernel fetches filter words in chunks of WORD_CHUNK u32
# words (src/repro/kernels/common.py), so its ``bloom_build`` rounds nbits
# up to whole chunks of 32 * WORD_CHUNK bits.  Rounding any other way
# would change every filter's bits.
WORD_CHUNK = 512


def bloom_build(keys: torch.Tensor, bits_per_key: int = 10):
    """Filter words for a key set.  (k, nbits) come from the engine's
    ``bloom_params``, nbits rounded up to a multiple of 32 * WORD_CHUNK.
    -> (words (nbits // 32,) int32, k, nbits)."""
    from ...core.engine.keys import bloom_params
    check_u32_columns("bloom_build", keys)
    k, nbits = bloom_params(keys.shape[0], bits_per_key)
    chunk = 32 * WORD_CHUNK
    nbits = (nbits + chunk - 1) // chunk * chunk
    return bloom_build_ref(keys, k, nbits), k, nbits


def bloom_probe(queries: torch.Tensor, words: torch.Tensor, k: int,
                nbits: int) -> torch.Tensor:
    """May-contain test of each query against a filter of ``nbits`` bits
    (``words`` holds at least nbits / 32 of them) and ``k`` probes.
    -> (Q,) bool."""
    dev = check_u32_columns("bloom_probe", queries, words)
    k, nbits = int(k), int(nbits)
    if k < 0 or not 0 < nbits <= min(32 * words.shape[0], U32_MAX):
        raise ValueError(f"bloom_probe: want k >= 0 and 0 < nbits <= "
                         f"min(32 * {words.shape[0]} words, 2^32 - 1), got "
                         f"k={k} nbits={nbits}")
    if dev.type == "cpu":
        return bloom_probe_ref(queries, words, k, nbits)
    q = queries.shape[0]
    (out,) = outputs(q, dev, torch.bool)
    if q:
        launch("bloom_probe", dev, queries.data_ptr(), q, words.data_ptr(),
               nbits, *fast_mod_magic(nbits), k, out.data_ptr())
        bloom_probe.launches += 1
    return out


bloom_probe.launches = 0
