"""The port's GC-Lookup, bloom, merge, partition and paged-gather plain
versions, and its bloom build, against the reference package.

Each wrapper of ``repro_torch.kernels`` runs its plain torch version on
CPU tensors.  The same NumPy-seeded inputs go through the reference's ops
wrappers (Pallas in interpret mode, as ``tests/test_kernels.py`` runs them)
and its ``ref.py`` oracles, at the shapes of ``tests/test_kernels.py``.
Every output must be equal exactly: u32 columns as bits, pages bit for bit.
``merge_dedup`` equals ``ref.py`` row for row and the Pallas wrapper on the
surviving rows (the network may order the two copies of a key otherwise).
Where the Pallas wrappers' padding changes the answer (a key or query equal
to a pad value, duplicate keys in a GC-Lookup run) the port follows
``ref.py`` and is held against it alone.  The CUDA kernels run only on the
card (``chip_smoke.py``, ``tests/test_torch_cuda.py``); their placement
arithmetic (the tiled merge path, prefix-count partition) is mirrored in
NumPy here.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from _hypothesis_support import given, settings, st

from repro import kernels as R
from repro_torch import kernels as T
from repro_torch.bench import kernels as B
from repro_torch.kernels.common import u32_tensor

BOUNDARY = 0xFFFFFFFD       # largest key the reference's u32 ops accept


def u32(t: torch.Tensor) -> np.ndarray:
    """int32 bit-view tensor (or bool tensor) -> NumPy u32 (or bool)."""
    a = t.numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def equal(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        assert_array_equal(g.astype(np.int64), w.astype(np.int64))


# --------------------------------------------------------------- gc_lookup
def _gc_port(queries, keys, vids, vfiles):
    got = T.gc_lookup(*(u32_tensor(a) for a in (queries, keys, vids, vfiles)))
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
    return [u32(t) for t in got]


def _gc_oracle(queries, keys, vids, vfiles):
    return [np.asarray(x) for x in R.gc_lookup_ref(
        jnp.asarray(queries), jnp.asarray(keys), jnp.asarray(vids),
        jnp.asarray(vfiles))]


@pytest.mark.parametrize("q,n", [(1, 10), (17, 100), (300, 1000),
                                 (256, 512), (5, 2000)])
def test_gc_lookup_matches_reference(q, n):
    rng = np.random.default_rng(q * 1000 + n)
    s_keys = np.sort(rng.choice(np.arange(1, 10 * n, dtype=np.uint32),
                                size=n, replace=False))
    s_vids = rng.integers(1, 1 << 30, n).astype(np.uint32)
    s_vf = rng.integers(1, 1 << 20, n).astype(np.uint32)
    queries = np.concatenate([
        rng.choice(s_keys, q // 2 + 1),
        rng.integers(10 * n, 20 * n, q - q // 2 - 1).astype(np.uint32)])[:q]
    got = _gc_port(queries, s_keys, s_vids, s_vf)
    equal(got, R.gc_lookup(queries, s_keys, s_vids, s_vf))
    equal(got, _gc_oracle(queries, s_keys, s_vids, s_vf))


@pytest.mark.parametrize("case", ["boundary", "duplicates", "empty_run",
                                  "no_queries", "one_each"])
def test_gc_lookup_edges_follow_the_oracle(case):
    """Keys at the top of the u32 range, queries equal to the Pallas pads,
    duplicate keys (the oracle takes the first, the Pallas kernel sums
    them), an empty run, no queries, one query into a run of one."""
    rng = np.random.default_rng(5)
    keys = np.sort(rng.choice(np.arange(1, 5000, dtype=np.uint32), 300,
                              replace=False))
    if case == "boundary":
        keys[-3:] = [BOUNDARY - 2, BOUNDARY - 1, BOUNDARY]
        queries = np.array([BOUNDARY, BOUNDARY - 1, 0xFFFFFFFE, 0xFFFFFFFF,
                            keys[0], 0], np.uint32)
    elif case == "duplicates":
        keys = np.sort(np.concatenate([keys, keys[::7]]))
        queries = np.concatenate([keys[::5], [0, 6000]]).astype(np.uint32)
    elif case == "empty_run":
        keys, queries = keys[:0], keys[:4]
    elif case == "no_queries":
        queries = keys[:0]
    else:
        keys, queries = keys[:1], keys[:1]
    vids = (keys * 3 + 1).astype(np.uint32)
    vfiles = np.arange(len(keys), dtype=np.uint32)
    got = _gc_port(queries, keys, vids, vfiles)
    if len(keys):
        equal(got, _gc_oracle(queries, keys, vids, vfiles))
    pos = np.searchsorted(keys, queries)             # first equal entry
    hit = (pos < len(keys)) & (keys[np.minimum(pos, max(len(keys) - 1, 0))]
                               == queries) if len(keys) else \
        np.zeros(len(queries), bool)
    assert_array_equal(got[0], hit)
    assert_array_equal(got[1][hit], vids[pos[hit]])
    assert_array_equal(got[2][hit], vfiles[pos[hit]])
    assert (got[1][~hit] == 0).all() and (got[2][~hit] == 0).all()
    if case != "duplicates":
        low = queries <= BOUNDARY                    # where the pads agree
        ref = R.gc_lookup(queries, keys, vids, vfiles)
        equal([g[low] for g in got], [np.asarray(r)[low] for r in ref])


@pytest.mark.parametrize("bad", ["key_at_pad", "key_above_u32",
                                 "negative_key", "query_above_u32",
                                 "vid_above_u32", "u64_that_fits"])
def test_gc_lookup_refuses_what_does_not_fit_u32(bad):
    # the port takes u32 bit views only: every u64 (int64) column raises,
    # those the reference refuses and those it would narrow alike
    keys = np.array([3, 9, 12], np.uint64)
    queries = np.array([9, 4], np.uint64)
    vids = np.array([1, 2, 3], np.uint64)
    if bad == "key_at_pad":
        keys[-1] = 2**32 - 2
    elif bad == "key_above_u32":
        keys[-1] = 2**40
    elif bad == "negative_key":
        keys[-1] = 2**64 - 1                 # -1 as an int64 pattern
    elif bad == "query_above_u32":
        queries[0] = 2**32
    elif bad == "vid_above_u32":
        vids[0] = 2**32
    cols = [torch.from_numpy(a.view(np.int64).copy())
            for a in (queries, keys, vids, vids)]
    with pytest.raises(ValueError, match="gc_lookup"):
        T.gc_lookup(*cols)
    if bad.startswith("key"):
        # the reference refuses these too, where JAX keeps u64 columns
        with jax.enable_x64(True), pytest.raises(AssertionError):
            R.gc_lookup(queries, keys, vids, vids)


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(0, 2**20), min_size=1, max_size=200, unique=True),
       st.lists(st.integers(0, 2**20), min_size=1, max_size=100))
def test_gc_lookup_property(skeys, queries):
    s_keys = np.sort(np.array(skeys, np.uint32))
    s_vids = s_keys + 7
    s_vf = s_keys % 97
    q = np.array(queries, np.uint32)
    got = _gc_port(q, s_keys, s_vids, s_vf)
    equal(got, R.gc_lookup(q, s_keys, s_vids, s_vf))
    member = np.isin(q, s_keys)
    assert_array_equal(got[0], member)
    assert_array_equal(got[1][member], (q + 7)[member])


def _gc_search_mirror(keys, queries, log_f, log_w):
    """The CUDA kernel's search, in NumPy, for every query at once.  With
    2^lg the largest power of two <= N, rank = #{run < q} lies in
    [0, 2^(lg+1)); the level of step 2^l tests run[r + 2^l - 1] < q (a
    position past the run tests false) and adds 2^l to r.  The levels of
    steps >= 2^fs, fs = max(lg + 1 - log_f, log_w), read the staged fences
    (fence m = run[((m + 1) << fs) - 1], 2^(lg + 1 - fs) <= 2^log_f of
    them) at index (r >> fs) + 2^(l - fs) - 1; the levels down to step
    2^log_w read the run; then the 2^log_w keys at [r, r + 2^log_w) (r a
    multiple of 2^log_w) give rank = r + #{those < q}, found where one
    equals q.  -> (rank, found, r, the fences)."""
    n, w = len(keys), 1 << log_w
    q = queries.astype(np.int64)
    k = np.concatenate([keys.astype(np.int64), [0xFFFFFFFF]])

    def at(p):                      # a position past the run tests false
        return k[np.minimum(p, n)]
    lg = n.bit_length() - 1         # -1 for an empty run
    fs = max(lg + 1 - log_f, log_w)
    nf = 2 << (lg - fs) if lg >= fs else 0
    fence = at(((np.arange(nf) + 1) << fs) - 1)
    mi = np.zeros(len(q), np.int64)
    for l in range(lg, fs - 1, -1):
        st = 1 << (l - fs)
        mi += np.where(fence[mi + st - 1] < q, st, 0)
    r = mi << fs
    for l in range(min(lg, fs - 1), log_w - 1, -1):
        r += np.where(at(r + (1 << l) - 1) < q, 1 << l, 0)
    win = r[:, None] + np.arange(w)
    valid = win < n
    kw = at(win)
    rank = r + ((kw < q[:, None]) & valid).sum(1)
    found = ((kw == q[:, None]) & valid).any(1)
    return rank, found, r, fence


def _gc_mirror_case(n, kind, rng):
    """A run of n keys (duplicates in runs of up to three for "dup"; the
    top three at 0xFFFFFFFB..0xFFFFFFFD for "top") and queries: every key,
    its neighbours, 0, the largest u32 values and random ones."""
    keys = np.sort(rng.choice(np.arange(1, 10 * max(n, 1) + 2,
                                        dtype=np.uint32), n, replace=False))
    if kind == "dup":
        keys = np.sort(np.concatenate([keys, keys[::3], keys[::7]]))[:n]
    if kind == "top" and n >= 3:
        keys[-3:] = [BOUNDARY - 2, BOUNDARY - 1, BOUNDARY]
    queries = np.concatenate([
        keys, keys - 1, keys + 1,
        [0, 1, BOUNDARY - 1, BOUNDARY, BOUNDARY + 1, 0xFFFFFFFF],
        rng.integers(0, 1 << 32, 64, dtype=np.uint64)]).astype(np.uint32)
    return keys, queries


GC_MIRROR_SIZES = sorted({0, 1, 7, 8, 9} | {
    m for e in range(2, 15) for m in ((1 << e) - 1, 1 << e, (1 << e) + 1)})


@pytest.mark.parametrize("kind", ["", "dup", "top"])
@pytest.mark.parametrize("n", GC_MIRROR_SIZES + [70001])
def test_gc_lookup_search_mirror(n, kind):
    """The kernel's search, mirrored with its fence count and window (read
    from the CUDA source), equals searchsorted (side='left') on runs
    around the fence stride and window sizes, with duplicate keys (the
    first copy answers) and keys and queries at the top of u32; r stays a
    multiple of the window, the rank lies in the window, and the staged
    fences fit their shared memory."""
    log_f = _cu_constant("kGcLogFences")
    log_w = _cu_constant("kGcLogWindow")
    keys, queries = _gc_mirror_case(n, kind, np.random.default_rng(n))
    rank, found, r, fence = _gc_search_mirror(keys, queries, log_f, log_w)
    want = np.searchsorted(keys, queries, side="left")
    assert_array_equal(rank, want)
    hit = want < n
    hit[hit] = keys[want[hit]] == queries[hit]
    assert_array_equal(found, hit)
    assert (r % (1 << log_w) == 0).all() and ((rank - r) < 1 << log_w).all()
    assert len(fence) <= 1 << log_f
    vids = (keys * 3 + 1).astype(np.uint32)
    got = _gc_port(queries, keys, vids, keys)
    assert_array_equal(got[0], found)
    assert_array_equal(got[1][found], vids[rank[found]])


# ------------------------------------------------------------------- bloom
def _bloom_keys(rng, n, top=False):
    keys = rng.choice(np.arange(1, 1 << 24, dtype=np.uint32), n,
                      replace=False)
    if top:          # the top of the u32 range: every masked step matters
        keys[:4] = [0xFFFFFFFF, 0xFFFFFFFE, 0x80000000, 0x7FFFFFFF]
    return keys


@pytest.mark.parametrize("n,q,top", [(10, 5, False), (1000, 300, False),
                                     (5000, 1000, False), (64, 40, True)])
def test_bloom_matches_reference(n, q, top):
    rng = np.random.default_rng(n)
    keys = _bloom_keys(rng, n, top)
    words, k, nbits = R.bloom_build(keys)
    pw, pk, pn = T.bloom_build(u32_tensor(keys))
    assert (pk, pn) == (k, nbits)
    assert_array_equal(u32(pw), np.asarray(words))      # identical filter
    probes = np.concatenate([keys[:q // 2],
                             rng.integers(1 << 24, 1 << 25,
                                          q - q // 2).astype(np.uint32)])
    got = T.bloom_probe(u32_tensor(probes), pw, k, nbits).numpy()
    assert_array_equal(got, np.asarray(R.bloom_probe(probes, words, k,
                                                     nbits)))
    assert_array_equal(got, np.asarray(R.bloom_probe_ref(
        jnp.asarray(probes), words, k, nbits)))
    assert got[:q // 2].all(), "bloom false negative"


@settings(max_examples=10, deadline=None)
@given(st.lists(st.integers(0, 2**32 - 1), min_size=1, max_size=80,
                unique=True),
       st.lists(st.integers(0, 2**32 - 1), min_size=0, max_size=40),
       st.sampled_from([4, 10]))
def test_bloom_property(keys, probes, bits_per_key):
    """Any u32 keys: the same words, no false negative, the same probes."""
    keys = np.array(keys, np.uint32)
    probes = np.concatenate([keys, np.array(probes, np.uint32)])
    words, k, nbits = R.bloom_build(keys, bits_per_key)
    pw, pk, pn = T.bloom_build(u32_tensor(keys), bits_per_key)
    assert (pk, pn) == (k, nbits)
    assert_array_equal(u32(pw), np.asarray(words))
    got = T.bloom_probe(u32_tensor(probes), pw, k, nbits).numpy()
    assert_array_equal(got, np.asarray(R.bloom_probe_ref(
        jnp.asarray(probes), words, k, nbits)))
    assert got[:len(keys)].all()


# probe counts past one batch of the kernel's word loads (bits/key 1, 16
# and 24: k 1, 11 and 17)
@pytest.mark.parametrize("bits_per_key,k_want", [(1, 1), (16, 11), (24, 17)])
def test_bloom_probe_counts_past_a_batch(bits_per_key, k_want):
    rng = np.random.default_rng(bits_per_key)
    keys = _bloom_keys(rng, 700)
    words, k, nbits = R.bloom_build(keys, bits_per_key)
    pw, pk, pn = T.bloom_build(u32_tensor(keys), bits_per_key)
    assert (pk, pn) == (k, nbits) and k == k_want
    assert_array_equal(u32(pw), np.asarray(words))
    probes = np.concatenate([keys[:200], rng.integers(
        1 << 24, 1 << 25, 300).astype(np.uint32)])
    got = T.bloom_probe(u32_tensor(probes), pw, k, nbits).numpy()
    assert_array_equal(got, np.asarray(R.bloom_probe_ref(
        jnp.asarray(probes), words, k, nbits)))
    assert got[:200].all(), "bloom false negative"


# filters whose nbits lies below 32 * len(words) and is no multiple of 32:
# bits are taken modulo nbits, never modulo the words' bits
@pytest.mark.parametrize("nbits", [1, 31, 33, 1000, 32 * 40 - 1])
def test_bloom_probe_nbits_below_the_words(nbits):
    rng = np.random.default_rng(nbits)
    words = np.bitwise_or.reduce(      # 7/8 of the bits set
        rng.integers(0, 1 << 32, (3, 40), dtype=np.uint64)).astype(np.uint32)
    probes = rng.integers(0, 1 << 32, 500, dtype=np.uint64).astype(np.uint32)
    for k in (0, 1, 3, 9):
        got = T.bloom_probe(u32_tensor(probes), u32_tensor(words), k,
                            nbits).numpy()
        assert_array_equal(got, np.asarray(R.bloom_probe_ref(
            jnp.asarray(probes), jnp.asarray(words), k, nbits)))


def test_bloom_probe_checks_its_filter():
    w = u32_tensor(np.zeros(4, np.uint32))
    q = u32_tensor(np.arange(3, dtype=np.uint32))
    assert T.bloom_probe(q, w, 0, 128).all()          # no probe: may contain
    for k, nbits in ((3, 129), (3, 0), (-1, 64)):
        with pytest.raises(ValueError, match="bloom_probe"):
            T.bloom_probe(q, w, k, nbits)
    with pytest.raises(ValueError, match="int32"):
        T.bloom_probe(q.to(torch.int64), w, 3, 64)


# ------------------------------------------------------------------- merge
def _merge_port(a, b):
    got = T.merge_dedup(*(u32_tensor(c) for c in (*a, *b)))
    assert got[3].dtype == torch.bool
    return [u32(t) for t in got]


def _merge_oracle(a, b):
    return [np.asarray(x) for x in R.merge_dedup_ref(
        *(jnp.asarray(c) for c in (*a, *b)))]


def _survivors(out):
    keys, seqs, vids, keep = (np.asarray(o) for o in out)
    return sorted(zip(keys[keep].tolist(), seqs[keep].tolist(),
                      vids[keep].tolist()))


MERGE_TILE = 2048           # output rows a CTA of the merge kernel takes


def _merge_path_mirror(a, b, tile=MERGE_TILE):
    """The CUDA kernel's merge path, in NumPy: the output cut into tiles of
    ``tile`` rows; each tile's split (i rows of A before output row d: A[m]
    is among them iff A[m] <= B[d - m - 1] in the order of (key << 32 |
    ~seq)) found by the kernel's 32-way search, the tile's two windows
    merged (A first on equal packed rows), and keep from each row's key
    against the previous row's, the tile's first row against the row just
    before the tile (the later in merge order of A[i - 1] and B[j - 1])."""
    def packed(run):
        k, s = run[0].astype(np.uint64), run[1].astype(np.uint64)
        return (k << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - s)
    pa, pb = packed(a), packed(b)
    na, nb = len(pa), len(pb)

    def split(d):           # the kernel's merge_split, lane by lane
        lo, hi = max(0, d - nb), min(d, na)
        while lo < hi:
            s = (hi - lo + 31) >> 5
            m = lo + np.arange(1, 33) * s - 1
            ok = m < hi
            inside = np.zeros(32, bool)
            inside[ok] = pa[m[ok]] <= pb[d - m[ok] - 1]
            c = int(inside.sum())
            first_out = lo + (c + 1) * s - 1
            lo += c * s
            hi = min(hi, first_out)
        return lo

    out = [np.zeros(na + nb, np.uint32) for _ in range(3)]
    keep = np.zeros(na + nb, bool)
    for d0 in range(0, na + nb, tile):
        d1 = min(d0 + tile, na + nb)
        i0, i1 = split(d0), split(d1)
        j0, j1 = d0 - i0, d1 - i1
        ia, ib = i0, j0
        for o in range(d0, d1):
            take_a = ia < i1 and (ib >= j1 or pa[ia] <= pb[ib])
            run, x = (a, ia) if take_a else (b, ib)
            for c in range(3):
                out[c][o] = run[c][x]
            ia, ib = (ia + 1, ib) if take_a else (ia, ib + 1)
        if d0 == 0:
            prev = None
        elif i0 == 0 or (j0 > 0 and pa[i0 - 1] <= pb[j0 - 1]):
            prev = b[0][j0 - 1]
        else:
            prev = a[0][i0 - 1]
        keys = out[0][d0:d1]
        keep[d0:d1] = keys != np.concatenate(
            [[keys[0] if prev is None else prev], keys[:-1]])
        if d0 == 0:
            keep[0] = True
    return out + [keep]


def _runs(rng, na, nb, space=1000):
    ak = np.sort(rng.choice(np.arange(space, dtype=np.uint32), na,
                            replace=False))
    bk = np.sort(rng.choice(np.arange(space, dtype=np.uint32), nb,
                            replace=False))
    aseq = rng.integers(0, 1000, na).astype(np.uint32) * 2        # even
    bseq = rng.integers(0, 1000, nb).astype(np.uint32) * 2 + 1    # odd
    avid = rng.integers(0, 1 << 30, na).astype(np.uint32)
    bvid = rng.integers(0, 1 << 30, nb).astype(np.uint32)
    return (ak, aseq, avid), (bk, bseq, bvid)


@pytest.mark.parametrize("na,nb", [(1, 1), (10, 3), (100, 100), (64, 257)])
def test_merge_dedup_matches_reference(na, nb):
    a, b = _runs(np.random.default_rng(na * 97 + nb), na, nb)
    got = _merge_port(a, b)
    equal(got, _merge_oracle(a, b))                   # row for row
    assert _survivors(got) == _survivors(R.merge_dedup(*a, *b))
    equal(got, _merge_path_mirror(a, b))


@pytest.mark.parametrize("case", ["a_empty", "b_empty", "both_empty",
                                  "shared_keys", "equal_rows", "top_keys",
                                  "extreme_seqs"])
def test_merge_dedup_edges_follow_the_oracle(case):
    """Empty runs, runs sharing every key, rows equal in key and seq (A
    first), key 0xFFFFFFFF (the Pallas pad) and seqs at 0 and 2^32 - 1."""
    rng = np.random.default_rng(11)
    a, b = _runs(rng, 50, 40)
    if case == "a_empty":
        a = tuple(c[:0] for c in a)
    elif case == "b_empty":
        b = tuple(c[:0] for c in b)
    elif case == "both_empty":
        a, b = tuple(c[:0] for c in a), tuple(c[:0] for c in b)
    elif case == "shared_keys":
        b = (a[0].copy(), a[1] + 1, a[2] + 5)
    elif case == "equal_rows":
        b = (a[0].copy(), a[1].copy(), a[2] + 5)
    elif case == "top_keys":
        a[0][-2:] = [0xFFFFFFFE, 0xFFFFFFFF]
        b[0][-1] = 0xFFFFFFFF
    else:
        a[1][:] = 0
        b = (a[0].copy(), np.full(len(a[0]), 0xFFFFFFFF, np.uint32), a[2] + 5)
    got = _merge_port(a, b)
    equal(got, _merge_path_mirror(a, b))
    if len(a[0]) + len(b[0]):
        equal(got, _merge_oracle(a, b))
    else:
        assert all(len(g) == 0 for g in got)
    if case in ("shared_keys", "extreme_seqs"):     # one newest copy
        assert _survivors(got) == _survivors(R.merge_dedup(*a, *b))


def _merge_tile_case(case, rng):
    """Runs for the merge path's tile edges (in the mirror's tiles of 8):
    one run empty, runs of unequal and odd lengths, a key's two copies on
    either side of a tile boundary (its newer copy in A or in B), every
    key in both runs, key 0xFFFFFFFF, equal seqs."""
    if case == "a_empty":
        return _runs(rng, 0, 37)
    if case == "b_empty":
        return _runs(rng, 29, 0)
    if case == "unequal_odd":
        return _runs(rng, 101, 7, space=400)
    if case.startswith("split_pair"):   # pair k at rows 2k - 1 and 2k
        ak = np.arange(0, 60, dtype=np.uint32)
        bk = ak[1:].copy()
        aseq = np.full(len(ak), 10 if case == "split_pair_a" else 5,
                       np.uint32)
        bseq = np.full(len(bk), 7, np.uint32)
        return (ak, aseq, ak + 1), (bk, bseq, bk + 2)
    a, b = _runs(rng, 64, 64, space=200)
    if case == "all_shared":
        return a, (a[0].copy(), a[1] + 1, a[2] + 3)
    if case == "top_key":
        a[0][-1] = b[0][-1] = 0xFFFFFFFF
        return a, b
    # equal seqs: every key in both runs with the same seq (A first)
    return a, (a[0].copy(), a[1].copy(), a[2] + 3)


@pytest.mark.parametrize("tile", [1, 3, 8, MERGE_TILE])
@pytest.mark.parametrize("case", ["a_empty", "b_empty", "unequal_odd",
                                  "split_pair_a", "split_pair_b",
                                  "all_shared", "top_key", "equal_seqs"])
def test_merge_dedup_merge_path_tiles(case, tile):
    """The kernel's tiled merge path, mirrored at small tiles so that
    every edge lies on a tile boundary, equals the port's rows, ``ref.py``
    row for row, and the Pallas wrapper in interpret mode on the surviving
    rows (its network orders two copies of a key otherwise).  Key
    0xFFFFFFFF is the Pallas pad, and two copies of a key with equal seqs
    survive as whichever its network puts first: there ``ref.py`` alone
    holds the port (A's copy survives)."""
    a, b = _merge_tile_case(case, np.random.default_rng(len(case)))
    got = _merge_port(a, b)
    equal(got, _merge_path_mirror(a, b, tile))
    equal(got, _merge_oracle(a, b))
    if case not in ("top_key", "equal_seqs"):
        assert _survivors(got) == _survivors(
            R.merge_dedup(*a, *b, interpret=True))


@settings(max_examples=15, deadline=None)
@given(st.lists(st.integers(0, 50), min_size=1, max_size=60, unique=True),
       st.lists(st.integers(0, 50), min_size=1, max_size=60, unique=True))
def test_merge_dedup_property_newest_wins(akeys, bkeys):
    ak = np.sort(np.array(akeys, np.uint32))
    bk = np.sort(np.array(bkeys, np.uint32))
    a = (ak, np.full(len(ak), 10, np.uint32), ak + 1)
    b = (bk, np.full(len(bk), 20, np.uint32), bk + 2)     # b is newer
    got = _merge_port(a, b)
    equal(got, _merge_oracle(a, b))
    equal(got, _merge_path_mirror(a, b))
    kept = dict(zip(got[0][got[3]].tolist(), got[2][got[3]].tolist()))
    expect = {int(k): int(k) + 1 for k in ak}
    expect.update({int(k): int(k) + 2 for k in bk})
    assert kept == expect


# --------------------------------------------------------------- partition
def _partition_port(keys, hot, vids, vsz):
    got = T.hot_cold_partition(u32_tensor(keys), torch.from_numpy(hot),
                               u32_tensor(vids), u32_tensor(vsz))
    assert got[3].dtype == torch.int64 and got[3].shape == (1,)
    return [u32(t) for t in got[:3]], int(got[3])


def _prefix_mirror(keys, hot, vids, vsz):
    """The CUDA kernel's placement, in NumPy: a hot record at its exclusive
    hot prefix h(i), a cold one at n_hot + i - h(i)."""
    h = np.cumsum(hot) - hot
    dst = np.where(hot, h, hot.sum() + np.arange(len(hot)) - h)
    out = [np.zeros(len(hot), np.uint32) for _ in range(3)]
    for o, c in zip(out, (keys, vids, vsz)):
        o[dst] = c
    return out


@pytest.mark.parametrize("n,share", [(1, 0.3), (7, 0.3), (64, 0.3),
                                     (500, 0.3), (0, 0.3), (100, 1.0),
                                     (100, 0.0), (1030, 0.3)])
def test_partition_matches_reference(n, share):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    hot = rng.random(n) < share
    vids = rng.integers(0, 1 << 30, n).astype(np.uint32)
    vsz = rng.integers(1, 1 << 16, n).astype(np.uint32)
    got, n_hot = _partition_port(keys, hot, vids, vsz)
    gk, gv, gs, gcnt = R.hot_cold_partition(keys, hot, vids, vsz)
    assert n_hot == int(gcnt) == hot.sum()
    equal(got, (gk, gv, gs))
    if n:
        wk, wv, ws, wcnt = R.hot_cold_partition_ref(
            jnp.asarray(keys), jnp.asarray(hot), jnp.asarray(vids),
            jnp.asarray(vsz))
        assert int(wcnt) == n_hot
        equal(got, (wk, wv, ws))
    equal(got, _prefix_mirror(keys, hot, vids, vsz))


def _cu_constant(name: str) -> int:
    """An ``int`` constant of the CUDA source (the kernels' own sizes)."""
    src = (Path(T.__file__).parent / "csrc" / "kernels.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _two_launch_mirror(keys, hot, vids, vsz, tile, threads):
    """The CUDA kernel's two launches, in NumPy.  Launch 1: each tile's hot
    count, 16 flags a thread.  Launch 2, a tile a CTA: the tile's hot
    offset (the counts of the tiles before it) and n_hot (all counts);
    record x = 4 * (u * threads + t) + j of the tile is thread t's j-th of
    item u, so its hot rank in the tile is the exclusive sum over the
    (item, warp) pairs before its own, then the earlier lanes' counts,
    then its own earlier records'; a hot record goes to that rank, a cold
    one to tile_hot + x - rank, in shared memory; the hot run is written
    from the tile's offset, the cold run from n_hot + the tile's start -
    its offset."""
    n, warps, items = len(hot), threads // 32, tile // (4 * threads)
    ntiles = -(-n // tile)
    flags = np.zeros(ntiles * tile, bool)
    flags[:n] = hot
    counts = flags.reshape(ntiles, tile // 16, 16).sum(-1).sum(-1)
    n_hot = int(counts.sum())
    out = [np.zeros(n, np.uint32) for _ in range(3)]
    for b in range(ntiles):
        t0 = b * tile
        cnt = min(tile, n - t0)
        f = flags[t0:t0 + tile].reshape(items, warps, 32, 4)
        c = f.sum(-1)                              # a thread an item
        incl = np.cumsum(c, axis=-1)               # over the lanes
        pair = incl[..., -1].reshape(-1)           # (item, warp) order
        pair_off = (np.cumsum(pair) - pair).reshape(items, warps, 1, 1)
        rank = pair_off + (incl - c)[..., None] + np.cumsum(f, -1) - f
        rank = rank.reshape(-1)[:cnt]
        th = int(pair.sum())
        x = np.arange(cnt)
        h = f.reshape(-1)[:cnt]
        pos = np.where(h, rank, th + x - rank)
        before = int(counts[:b].sum())
        p = np.arange(cnt)
        dst = np.where(p < th, before + p, n_hot + t0 - before - th + p)
        for o, col in zip(out, (keys, vids, vsz)):
            smem = np.zeros(cnt, np.uint32)
            smem[pos] = col[t0:t0 + cnt]
            o[dst] = smem
    return out, n_hot


@pytest.mark.parametrize("tile,threads", [("kernel", "kernel"), (128, 32),
                                          (1024, 64)])
@pytest.mark.parametrize("n,share", [("tile-1", .3), ("tile", .3),
                                     ("tile+1", .3), ("3tile+5", .3),
                                     ("3tile+5", 1.), ("3tile+5", 0.),
                                     ("3tile+5", "last"), (1, .3), (0, .3)])
def test_partition_two_launch_placement(n, share, tile, threads):
    """The kernel's placement, mirrored at its own tile and at small ones,
    equals the port's partition and the reference's, with tiles cut
    either side of a record, all records hot, none, and only the last
    tile's."""
    if tile == "kernel":
        tile = _cu_constant("kPartTile")
        threads = _cu_constant("kPartThreads")
    if isinstance(n, str):
        n = {"tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
             "3tile+5": 3 * tile + 5}[n]
    rng = np.random.default_rng(n + tile)
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    hot = rng.random(n) < (.3 if share == "last" else share)
    if share == "last":
        hot[:(n - 1) // tile * tile] = False
    vids = np.arange(n, dtype=np.uint32)
    vsz = rng.integers(1, 1 << 16, n).astype(np.uint32)
    got, n_hot = _partition_port(keys, hot, vids, vsz)
    mirror, m_hot = _two_launch_mirror(keys, hot, vids, vsz, tile, threads)
    assert n_hot == m_hot == hot.sum()
    equal(got, mirror)
    gk, gv, gs, gcnt = R.hot_cold_partition(keys, hot, vids, vsz)
    assert int(gcnt) == n_hot
    equal(got, (gk, gv, gs))


# ------------------------------------------------------------ paged gather
@pytest.mark.parametrize("b,p,npages,psize,d,dtype", [
    (1, 1, 4, 8, 128, jnp.float32),
    (4, 8, 64, 16, 128, jnp.float32),
    (2, 4, 16, 8, 64, jnp.bfloat16),
    (3, 5, 32, 4, 256, jnp.int32),
    (2, 3, 5, 3, 5, jnp.bfloat16),          # a page of 30 bytes
])
def test_page_gather_matches_reference(b, p, npages, psize, d, dtype):
    rng = np.random.default_rng(b * 100 + p)
    pages = jnp.asarray(
        rng.standard_normal((npages, psize, d)) * 10).astype(dtype)
    table = rng.integers(0, npages, (b, p)).astype(np.int32)
    tdtype = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
              jnp.int32: torch.int32}[dtype]
    host = np.array(pages.astype(jnp.float32) if dtype != jnp.int32
                    else pages)
    tpages = torch.from_numpy(host).to(tdtype)
    got = T.page_gather(torch.from_numpy(table), tpages)
    assert got.shape == (b, p * psize, d) and got.dtype == tdtype
    want = R.page_gather(table, pages)
    bits = {torch.bfloat16: torch.int16}.get(tdtype, torch.int32)
    want_bits = np.asarray(want).view(
        np.int16 if tdtype == torch.bfloat16 else np.int32)
    assert_array_equal(got.view(bits).numpy(), want_bits)   # bit for bit
    assert_array_equal(np.asarray(R.page_gather_ref(jnp.asarray(table),
                                                    pages)),
                       np.asarray(want))


@pytest.mark.parametrize("entry", [-1, 16])
def test_page_gather_refuses_entries_outside_the_pool(entry):
    pages = torch.zeros((16, 2, 4))
    table = torch.tensor([[0, entry]], dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\[0, 16\)"):
        T.page_gather(table, pages)
    # the reference's gather clamps it instead
    got = R.page_gather(table.numpy(), jnp.asarray(pages.numpy()))
    assert got.shape == (1, 4, 4)
    with pytest.raises(ValueError, match="host"):
        T.page_gather(table.to(torch.int64), pages)


# ----------------------------------------------------------- the bench
def _reference_outputs(case: B.Case):
    """The reference's op on the case's host operands."""
    host = [a.numpy() if isinstance(a, torch.Tensor) else a
            for a in case.args]
    host = [a.view(np.uint32) if isinstance(a, np.ndarray)
            and a.dtype == np.int32 and case.kernel != "page_gather" else a
            for a in host]
    if case.kernel == "gc_lookup":
        return R.gc_lookup(*host)
    if case.kernel == "bloom_probe":
        return (R.bloom_probe(host[0], jnp.asarray(host[1]), host[2],
                              host[3]),)
    if case.kernel == "merge_dedup":
        return R.merge_dedup_ref(*(jnp.asarray(a) for a in host))
    if case.kernel == "hot_cold_partition":
        out = R.hot_cold_partition(*host)
        return (*out[:3], np.array([out[3]]))
    return (R.page_gather(host[0], jnp.asarray(host[1])),)


@pytest.mark.parametrize("kernel", list(B.ROW_NAMES))
def test_bench_cases_equal_the_reference(kernel):
    (case,) = [c for c in B.bench_cases() if c.kernel == kernel]
    got = B.wrapper(case)(*B.operands(case, "cpu"))
    got = got if isinstance(got, tuple) else (got,)
    got = [u32(t) if t.dtype != torch.float32 else t.numpy() for t in got]
    equal(got, _reference_outputs(case))
    if kernel == "bloom_probe":       # the filter equals the reference's too
        keys = np.sort(B.bench_cases()[0].args[1].numpy().view(np.uint32))
        assert_array_equal(u32(case.args[1]),
                           np.asarray(R.bloom_build(keys)[0]))


def test_bench_runs_on_the_cpu_with_the_reference_row_contract():
    rows = B.run("cpu", "bench")
    assert [r["name"] for r in rows] == [
        "kernels/gc_lookup", "kernels/bloom_probe", "kernels/merge_dedup",
        "kernels/partition", "kernels/page_gather"]
    for r in rows:
        assert set(r) == {"name", "us_per_call", "derived"}
        assert isinstance(r["us_per_call"], float) and r["us_per_call"] > 0
        fields = dict(kv.split("=", 1) for kv in r["derived"].split())
        assert float(fields["ref_us"]) > 0 and int(fields["bytes"]) > 0
        assert fields["shapes"] == "bench"


def test_bench_refuses_unknown_shapes():
    with pytest.raises(ValueError, match="shapes"):
        B.cases("huge")
