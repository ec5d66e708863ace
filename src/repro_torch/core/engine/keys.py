"""Fixed-width key codec and vectorized hashing (DESIGN.md §3).

The paper uses 24-byte string keys.  The vectorized engine and the device
kernels have no variable-length string compare, so keys are fixed-width u64
lanes; the engine still *accounts* 24 bytes per key for space/I-O
(``EngineConfig.key_bytes``).  This module provides the splitmix64 hash
family used by bloom filters and the DropCache; the ``lookup_probe`` kernel
tests bits of the filter words built here.
"""

from __future__ import annotations

import numpy as np

_SPLITMIX_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)

_LN2 = 0.69                     # probes ~= ln2 * bits/key (RocksDB's round)
_WORD_BITS = 64                 # bloom bit array is u64 words
_WORD_BYTES = 8
_WORD_MASK = np.uint64(63)      # bit index within a word


def splitmix64(x: np.ndarray | int) -> np.ndarray:
    """Vectorized splitmix64 finalizer (u64 -> u64, wrapping)."""
    with np.errstate(over="ignore"):
        z = np.asarray(x, dtype=np.uint64) + _SPLITMIX_GAMMA
        z = (z ^ (z >> np.uint64(30))) * _MIX1
        z = (z ^ (z >> np.uint64(27))) * _MIX2
        return z ^ (z >> np.uint64(31))


def hash_family(keys: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """k independent 64-bit hashes per key via double hashing.

    Returns array of shape (k, n) u64.
    """
    keys = np.asarray(keys, dtype=np.uint64)
    with np.errstate(over="ignore"):
        h1 = splitmix64(keys ^ splitmix64(np.uint64(seed)))
        h2 = splitmix64(h1) | np.uint64(1)  # odd so strides cover the table
        ks = np.arange(k, dtype=np.uint64)[:, None]
        return h1[None, :] + ks * h2[None, :]


def bloom_params(n_keys: int, bits_per_key: int) -> tuple[int, int]:
    """Canonical bloom sizing of the engine filter: ``(k, nbits)`` with
    ``k = round(ln2 * bits/key)`` probes and ``nbits`` rounded up to whole
    u64 words."""
    k = max(1, int(round(bits_per_key * _LN2)))
    nbits = int(max(_WORD_BITS, max(1, n_keys) * bits_per_key))
    nwords = (nbits + _WORD_BITS - 1) // _WORD_BITS
    return k, nwords * _WORD_BITS


class BloomFilter:
    """Standard k-hash bloom filter over u64 keys (10 bits/key default).

    Real bit array; false positives occur naturally (and cost wasted block
    reads in the read path, as in RocksDB).
    """

    __slots__ = ("nbits", "k", "bits", "nbytes")

    @staticmethod
    def k_for(bits_per_key: int) -> int:
        """Number of hash probes for a given bits/key (ln2 * bits/key)."""
        return bloom_params(1, bits_per_key)[0]

    def __init__(self, keys: np.ndarray, bits_per_key: int = 10):
        self.k, self.nbits = bloom_params(len(keys), bits_per_key)
        nwords = self.nbits // _WORD_BITS
        self.bits = np.zeros(nwords, dtype=np.uint64)
        self.nbytes = nwords * _WORD_BYTES
        if len(keys):
            hs = hash_family(keys, self.k) % np.uint64(self.nbits)
            word = (hs >> np.uint64(6)).ravel()
            bit = (hs & _WORD_MASK).ravel()
            np.bitwise_or.at(self.bits, word, np.uint64(1) << bit)

    def may_contain(self, keys: np.ndarray,
                    raw: np.ndarray | None = None) -> np.ndarray:
        """Vectorized membership test -> bool array.

        ``raw`` may carry precomputed ``hash_family(keys, k)`` output (pre-
        modulo): the raw hashes depend only on the keys, so a batched lookup
        walking many tables hashes its key column once and reuses it against
        every filter of the same ``k``."""
        if raw is None or len(raw) != self.k:
            keys = np.atleast_1d(np.asarray(keys, dtype=np.uint64))
            raw = hash_family(keys, self.k)
        hs = raw % np.uint64(self.nbits)
        word = hs >> np.uint64(6)
        bit = hs & _WORD_MASK
        hit = (self.bits[word] >> bit) & np.uint64(1)
        return hit.all(axis=0)
