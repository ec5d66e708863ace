"""The port's plain kernel versions against the reference kernels' ops.

Each of the four kernels of the port (``repro_torch.kernels``) runs its
plain torch version on CPU tensors; the same NumPy-seeded inputs go
through the reference's ops in ``xla`` mode (its jitted ``ref.py``
oracle).  Integer outputs must be equal exactly.  The reference takes u32
keys only, so the cases above 2^32 and 2^63 are held against NumPy's
``searchsorted`` on ``uint64`` and the engine's ``BloomFilter`` instead.
The CUDA kernels themselves run only on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from _hypothesis_support import given, settings, st

from repro import kernels as R
from repro.core.engine.keys import BloomFilter as RefBloomFilter
from repro.core.engine.keys import hash_family as ref_hash_family
from repro.core.values.fetch import split_runs
from repro_torch import kernels as T
from repro_torch.core.engine.keys import BloomFilter, hash_family

BOUNDARY = 0xFFFFFFFD       # largest key the reference's u32 ops accept


def col(a) -> torch.Tensor:
    """NumPy u64/i64 column -> int64 CPU tensor of the same bits."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype != np.int64:
        a = a.astype(np.uint64)
    return torch.from_numpy(a.view(np.int64).copy())


def np_(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


def _probe_case(rng, q, n, boundary=False):
    """Adversarial (queries, table, bit_idx, u64 words) in the reference's
    u32 range (tests/test_kernels.py:_probe_case, u64 filter words)."""
    space = np.arange(1, 4 * n + 2, dtype=np.uint64)
    table = np.sort(rng.choice(space, n, replace=False))
    if boundary and n:
        table[-1] = BOUNDARY
    queries = np.concatenate([
        rng.choice(table, q // 2 + 1) if n else np.zeros(1, np.uint64),
        rng.integers(4 * n + 2, 8 * n + 9, q).astype(np.uint64)])[:q]
    if boundary and q:
        queries[0] = BOUNDARY
    k, nbits = 7, 1 << 14
    words = rng.integers(0, 2**64 - 1, nbits // 64, dtype=np.uint64,
                         endpoint=True)
    bit_idx = rng.integers(0, nbits, (q, k)).astype(np.uint64)
    return queries, table, bit_idx, words


# ------------------------------------------------------------ lookup_probe
@pytest.mark.parametrize("q,n", [(0, 16), (1, 1), (7, 300), (256, 512),
                                 (300, 1000), (1, 0), (64, 0)])
def test_lookup_probe_matches_reference(q, n):
    rng = np.random.default_rng(q * 1000 + n)
    queries, table, bit_idx, words = _probe_case(rng, q, n, boundary=True)
    may, found, rank = T.lookup_probe(col(queries), col(table), col(bit_idx),
                                      col(words))
    rmay, rfound, rrank = R.lookup_probe(queries, table,
                                         bit_idx.astype(np.uint32), words,
                                         mode="xla")
    assert_array_equal(np_(may), rmay)
    assert_array_equal(np_(found), rfound)
    assert_array_equal(np_(rank), rrank)


@pytest.mark.parametrize("q,n", [(1, 1), (9, 3), (200, 700), (513, 4096)])
def test_rank_probe_matches_reference(q, n):
    rng = np.random.default_rng(7 * q + n)
    queries, table, _, _ = _probe_case(rng, q, n, boundary=True)
    found, rank = T.rank_probe(col(queries), col(table))
    rfound, rrank = R.rank_probe(queries, table, mode="xla")
    assert_array_equal(np_(found), rfound)
    assert_array_equal(np_(rank), rrank)


def test_rank_probe_all_duplicates():
    table = np.array([5, 9, 1000], np.uint64)
    queries = np.full(9, 9, np.uint64)          # all-duplicate batch
    found, rank = T.rank_probe(col(queries), col(table))
    rfound, rrank = R.rank_probe(queries, table, mode="xla")
    assert np_(found).all() and (np_(rank) == 1).all()
    assert_array_equal(np_(found), rfound)
    assert_array_equal(np_(rank), rrank)


@pytest.mark.parametrize("edge", ["min", "max", "below", "above"])
def test_rank_probe_at_run_edges(edge):
    table = np.array([10, 20, 30, BOUNDARY], np.uint64)
    q = {"min": 10, "max": BOUNDARY, "below": 0, "above": BOUNDARY - 1}[edge]
    queries = np.array([q], np.uint64)
    found, rank = T.rank_probe(col(queries), col(table))
    rfound, rrank = R.rank_probe(queries, table, mode="xla")
    assert_array_equal(np_(found), rfound)
    assert_array_equal(np_(rank), rrank)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, BOUNDARY), min_size=1, max_size=64,
                unique=True),
       st.lists(st.integers(0, BOUNDARY), min_size=1, max_size=64))
def test_rank_probe_property(tkeys, queries):
    table = np.sort(np.array(tkeys, np.uint64))
    q = np.array(queries, np.uint64)
    found, rank = T.rank_probe(col(q), col(table))
    rfound, rrank = R.rank_probe(q, table, mode="xla")
    assert_array_equal(np_(found), rfound)
    assert_array_equal(np_(rank), rrank)


# ----------------------------------------------- count_le / interval_rank
def test_interval_rank_matches_reference():
    # disjoint sorted [min, max] file ranges, like an LSM level
    mins = np.array([10, 40, 100, 1000], np.uint64)
    maxs = np.array([30, 60, 900, BOUNDARY], np.uint64)
    queries = np.array([0, 10, 30, 31, 40, 99, 100, 900, 901, 1000,
                        BOUNDARY], np.uint64)
    got = T.interval_rank(col(queries), col(mins), col(maxs))
    assert_array_equal(np_(got), R.interval_rank(queries, mins, maxs,
                                                 mode="xla"))


@pytest.mark.parametrize("q,n", [(1, 1), (5, 2), (300, 17), (1000, 400)])
def test_count_le_matches_reference(q, n):
    from repro.kernels.lookup_probe.ref import count_le_ref
    rng = np.random.default_rng(q + 31 * n)
    mins = np.sort(rng.choice(np.arange(0, 10 * n + 5, dtype=np.uint64), n,
                              replace=False))
    queries = np.concatenate([mins, rng.integers(0, 10 * n + 10, q)
                              .astype(np.uint64)])[:q]
    got = T.count_le(col(queries), col(mins))
    want = np.asarray(count_le_ref(queries.astype(np.uint32),
                                   mins.astype(np.uint32)))
    assert_array_equal(np_(got), want)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 10_000), min_size=2, max_size=40,
                unique=True),
       st.lists(st.integers(0, 11_000), min_size=1, max_size=50))
def test_interval_rank_property(bounds, queries):
    e = np.sort(np.array(bounds, np.uint64))
    mins, maxs = e[::2][:len(e) // 2], e[1::2][:len(e) // 2]
    q = np.array(queries, np.uint64)
    got = T.interval_rank(col(q), col(mins), col(maxs))
    assert_array_equal(np_(got), R.interval_rank(q, mins, maxs, mode="xla"))


def test_interval_rank_empty_level():
    q = col(np.array([1, 2, 3], np.uint64))
    e = col(np.zeros(0, np.uint64))
    assert (np_(T.interval_rank(q, e, e)) == -1).all()


# ------------------------------------------- u64 keys beyond the reference
@pytest.mark.parametrize("lo,hi", [(0, 2**33), (2**32, 2**40),
                                   (2**63 - 5000, 2**63 + 5000),
                                   (0, 2**64 - 1)])
@pytest.mark.parametrize("n", [1, 50, 3000])
def test_probes_on_u64_keys_match_numpy(lo, hi, n):
    rng = np.random.default_rng(n + hi % 1000)
    table = np.unique(rng.integers(lo, hi, n, dtype=np.uint64,
                                   endpoint=True))
    queries = np.concatenate([
        table[rng.integers(0, len(table), 40)],
        rng.integers(lo, hi, 60, dtype=np.uint64, endpoint=True),
        table[[0, -1]]])
    found, rank = T.rank_probe(col(queries), col(table))
    want = np.searchsorted(table, queries)
    assert_array_equal(np_(rank), want)
    assert_array_equal(np_(found), (want < len(table))
                       & (table[np.minimum(want, len(table) - 1)]
                          == queries))
    cnt = T.count_le(col(queries), col(table))
    assert_array_equal(np_(cnt), np.searchsorted(table, queries, "right"))
    # one-key "files" [k, k]: interval_rank finds exactly the equal keys
    fidx = T.interval_rank(col(queries), col(table), col(table))
    assert_array_equal(np_(fidx), np.where(np_(found), want, -1))


@pytest.mark.parametrize("hi", [2**33, 2**64 - 1])
def test_lookup_probe_bloom_on_u64_keys(hi):
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, hi, 2000, dtype=np.uint64,
                                  endpoint=True))
    queries = np.concatenate([keys[:500], rng.integers(
        0, hi, 500, dtype=np.uint64, endpoint=True)])
    bf = BloomFilter(keys, 10)
    ref_bf = RefBloomFilter(keys, 10)
    assert_array_equal(bf.bits, ref_bf.bits)
    raw = hash_family(queries, bf.k)
    assert_array_equal(raw, ref_hash_family(queries, bf.k))
    bit_idx = (raw % np.uint64(bf.nbits)).T
    may, found, rank = T.lookup_probe(col(queries), col(keys), col(bit_idx),
                                      col(bf.bits))
    assert_array_equal(np_(may), ref_bf.may_contain(queries))
    assert np_(may)[:500].all()                  # no false negatives
    assert_array_equal(np_(rank), np.searchsorted(keys, queries))


# ------------------------------------------------------------ run_coalesce
def _runs(rank_s, pos_s, keep, start):
    out = []
    for r in np.unique(rank_s[keep]):
        sel = keep & (rank_s == r)
        runs = np.split(pos_s[sel], np.nonzero(start[sel])[0][1:])
        out.append((int(r), [c.tolist() for c in runs]))
    return out


def _host_plan(rank, pos, window):
    out = []
    for r in np.unique(rank):
        posu = np.unique(pos[rank == r])
        out.append((int(r), [c.tolist() for c in split_runs(posu, window)]))
    return out


@pytest.mark.parametrize("window", [None, 1, 3])
@pytest.mark.parametrize("case", ["empty", "single", "dups", "mixed",
                                  "wide", "u32_edge"])
def test_run_coalesce_matches_reference(case, window):
    rng = np.random.default_rng(len(case) * 10 + (window or 0))
    if case == "empty":
        rank = pos = np.zeros(0, np.int64)
    elif case == "single":
        rank, pos = np.array([3]), np.array([77])
    elif case == "dups":
        rank = np.zeros(12, np.int64)
        pos = np.full(12, 5, np.int64)          # all-duplicate positions
    elif case == "mixed":
        rank = rng.integers(0, 5, 700)
        pos = rng.integers(0, 40, 700)
    elif case == "wide":
        rank = rng.integers(0, 300, 3000)
        pos = rng.integers(0, 1 << 20, 3000)
    else:                                       # ranks/pos at the u32 edge
        rank = np.array([2**32 - 2, 0, 2**32 - 2, 7, 7], np.int64)
        pos = np.array([2**32 - 2, 2**32 - 3, 2**32 - 3, 0, 2], np.int64)
    rank, pos = rank.astype(np.int64), pos.astype(np.int64)
    got = [np_(a) for a in T.run_coalesce(col(rank), col(pos),
                                          window=window)]
    want = R.run_coalesce(rank, pos, window=window, mode="xla")
    for g, w in zip(got, want):
        assert_array_equal(g, w)
    assert _runs(*got) == _host_plan(rank, pos, window)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 4), st.integers(0, 30)),
                min_size=1, max_size=80),
       st.sampled_from([None, 1, 2, 7]))
def test_run_coalesce_property(pairs, window):
    rank = np.array([p[0] for p in pairs], np.int64)
    pos = np.array([p[1] for p in pairs], np.int64)
    got = [np_(a) for a in T.run_coalesce(col(rank), col(pos),
                                          window=window)]
    for g, w in zip(got, R.run_coalesce(rank, pos, window=window,
                                        mode="xla")):
        assert_array_equal(g, w)


@pytest.mark.parametrize("m", [1, 2, 3, 64, 1000, 4097])
def test_bitonic_sort_u64_matches_numpy(m):
    from repro_torch.kernels.run_coalesce.ref import bitonic_sort_u64
    from repro_torch.kernels.common import next_pow2
    rng = np.random.default_rng(m)
    mp = max(2, next_pow2(m))
    keys = rng.integers(0, 2**64 - 1, mp, dtype=np.uint64, endpoint=True)
    keys[: mp // 4] = keys[0]                   # duplicates
    got = bitonic_sort_u64(col(keys)).numpy().view(np.uint64)
    assert_array_equal(got, np.sort(keys))


# ----------------------------------------------------- operand validation
def test_wrappers_reject_bad_operands():
    q = col(np.array([1, 2], np.uint64))
    with pytest.raises(ValueError, match="int64"):
        T.rank_probe(q.to(torch.int32), q)
    with pytest.raises(ValueError, match="int64"):
        T.count_le(q, q.to(torch.float64))
    with pytest.raises(ValueError, match="bit_idx"):
        T.lookup_probe(q, q, col(np.zeros((3, 7), np.uint64)), q)
    with pytest.raises(ValueError, match="2\\^32"):
        T.run_coalesce(col(np.array([2**32 - 1])), col(np.array([0])))
    with pytest.raises(ValueError, match="2\\^32"):
        T.run_coalesce(col(np.array([-1])), col(np.array([0])))
    with pytest.raises(ValueError, match="window"):
        T.run_coalesce(q, q, window=0)
    with pytest.raises(ValueError, match="length"):
        T.run_coalesce(q, q[:1])
