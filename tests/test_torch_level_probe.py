"""The level form of ``lookup_probe`` and the key form of ``gather_min64``
against the reference, on the CPU.

``lookup_probe_segments`` (one launch per LSM level on the card) runs its
plain torch version here; each of its segments is held against the
reference's ``lookup_probe`` op (``xla`` mode, its jitted ``ref.py``
oracle) on the same NumPy-seeded inputs, and past the reference's u32 key
range against the engine's ``BloomFilter`` and NumPy's ``searchsorted``.
The store cases hold the routing change itself: a level whose files each
get fewer rows than ``kernel_min_batch`` but whose total reaches it now
routes, and several L0 tables holding one key answer newest first.
``sketch_estimate`` (the count-min estimate with the row hash inside the
kernel) is held bit for bit against the reference's ``DecaySketch``.
Integer outputs and estimate bit patterns must be equal exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

import repro.core as R
import repro_torch.core as T
from repro import kernels as RK
from repro.core.adaptive.sketch import DecaySketch as RefSketch
from repro.core.engine.keys import BloomFilter as RefBloomFilter
from repro.core.engine.keys import splitmix64 as ref_splitmix64
from repro_torch import kernels as K
from repro_torch.core.accel import KernelPolicy
from repro_torch.core.adaptive.sketch import DecaySketch
from repro_torch.core.engine.keys import BloomFilter, hash_family
from repro_torch.kernels.common import fast_mod_magic, splitmix64, u64_mod

U32_TOP = 0xFFFFFFFD        # largest key the reference's u32 ops accept


def col(a) -> torch.Tensor:
    """NumPy u64/i64 column -> int64 CPU tensor of the same bits."""
    a = np.ascontiguousarray(np.asarray(a, np.uint64))
    return torch.from_numpy(a.view(np.int64).copy())


# ------------------------------------------------------------- helpers
def test_torch_splitmix64_and_u64_mod_match_numpy():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.integers(0, 2**64 - 1, 5000, dtype=np.uint64,
                                     endpoint=True),
                        np.array([0, 1, 2**63 - 1, 2**63, 2**64 - 1],
                                 np.uint64)])
    assert_array_equal(splitmix64(col(x)).numpy().view(np.uint64),
                       ref_splitmix64(x))
    for m in (1, 3, 64, 4096, 4097, 2**32 + 15, 2**61 + 1):
        assert_array_equal(u64_mod(col(x), m).numpy().view(np.uint64),
                           x % np.uint64(m))
    with pytest.raises(ValueError):
        u64_mod(col(x), 0)


@pytest.mark.parametrize("d", [1, 2, 3, 64, 4097, 120_000, 2**32 + 1,
                               2**63 + 5, 2**64 - 1])
def test_fast_mod_magic_gives_the_kernels_remainder(d):
    """The kernels' modulo by a per-call divisor (a multiply by the magic
    ``fast_mod_magic`` returns), in exact integers, against ``%``."""
    m, ln = fast_mod_magic(d)
    m %= 1 << 64                                  # the u64 pattern
    rng = np.random.default_rng(d % 1000)
    xs = [0, 1, d - 1, d % (1 << 64), 2**63, 2**64 - 1] + [
        int(x) for x in rng.integers(0, 2**64 - 1, 300, dtype=np.uint64,
                                     endpoint=True)]
    for x in xs:
        t = (x * m) >> 64
        q = (t + ((x - t) >> min(ln, 1))) >> max(ln - 1, 0)
        assert x - q * d == x % d
    with pytest.raises(ValueError):
        fast_mod_magic(0)


# -------------------------------------------------- the segmented probe
def _level(rng, sizes, k, hi, *, share=0):
    """Sorted unique runs of the given sizes below ``hi`` (the first
    ``share`` keys of run 0 also in every other run, as L0 tables holding
    the same key), their filters at ``k`` probes, and a key column of half
    run keys and half random ones."""
    bpk = {1: 1, 2: 3, 3: 4, 4: 6, 5: 7, 6: 9, 7: 10}[k]
    runs = [np.unique(rng.integers(0, hi, n, dtype=np.uint64,
                                   endpoint=True)) for n in sizes]
    if share and len(runs) > 1 and len(runs[0]):
        common = runs[0][:share]
        runs = [runs[0]] + [np.unique(np.concatenate([r, common]))
                            for r in runs[1:]]
    blooms = [BloomFilter(r, bpk) for r in runs]
    assert all(b.k == k for b in blooms)
    pool = np.concatenate(runs + [np.zeros(1, np.uint64)])
    keys = np.concatenate([pool[rng.integers(0, len(pool), 300)],
                           rng.integers(0, hi, 300, dtype=np.uint64,
                                        endpoint=True)])
    return runs, blooms, keys


def _segments(rng, n_keys, counts, shared):
    """rows and starts for segments of the given counts: disjoint slices
    of one row column, or (``shared``) all the same rows, as L0."""
    counts = np.asarray(counts, np.int64)
    if shared:
        rows = np.sort(rng.choice(n_keys, int(counts.max(initial=0)),
                                  replace=False)).astype(np.int64)
        return rows, np.zeros(len(counts), np.int64), np.full(
            len(counts), len(rows), np.int64)
    rows = rng.integers(0, n_keys, int(counts.sum())).astype(np.int64)
    return rows, np.cumsum(counts) - counts, counts


CASES = {   # name: (run sizes, segment counts, k, key bound, shared rows)
    "one_file": ([500], [200], 7, U32_TOP, False),
    "empty_runs": ([0, 300, 0], [40, 60, 1], 7, U32_TOP, False),
    "one_key_runs": ([1, 1, 1, 200], [50, 1, 30, 70], 7, U32_TOP, False),
    "zero_query_segments": ([100, 200, 300, 50], [0, 120, 0, 0], 7,
                            U32_TOP, False),
    "segments_straddle_tiles": ([3000, 2000], [600, 257], 7, U32_TOP,
                                False),
    "many_files": ([40] * 60, [7] * 60, 7, U32_TOP, False),
    "l0_shared_rows": ([800, 700, 600, 5], [300, 300, 300, 300], 7, U32_TOP,
                       True),
    **{f"k{k}": ([400, 900], [150, 250], k, U32_TOP, False)
       for k in range(1, 8)},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_segments_plain_matches_reference_per_segment(case):
    sizes, counts, k, hi, shared = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    runs, blooms, keys = _level(rng, sizes, k, hi, share=40 if shared else 0)
    rows, starts, counts = _segments(rng, len(keys), counts, shared)
    kraw = hash_family(keys, k)
    may, found, rank = K.lookup_probe_segments(
        col(keys), col(kraw), rows, starts, counts, [col(r) for r in runs],
        [col(b.bits) for b in blooms], [b.nbits for b in blooms])
    assert may.shape == found.shape == rank.shape == (int(counts.sum()),)
    out = 0
    for s, (run, bf) in enumerate(zip(runs, blooms)):
        r = rows[starts[s]:starts[s] + counts[s]]
        bit_idx = (kraw[:, r] % np.uint64(bf.nbits)).T.astype(np.uint32)
        want = RK.lookup_probe(keys[r], run, bit_idx, bf.bits, mode="xla")
        seg = slice(out, out + len(r))
        assert_array_equal(may[seg].numpy(), want[0])
        assert_array_equal(found[seg].numpy(), want[1])
        assert_array_equal(rank[seg].numpy(), want[2])
        out += len(r)


@pytest.mark.parametrize("k", range(1, 8))
@pytest.mark.parametrize("hi", [2**40, 2**64 - 1])
def test_segments_plain_on_u64_keys(k, hi):
    """Keys past the reference's u32 range, those >= 2^63 included: the
    filter test against the reference's ``BloomFilter`` and the rank
    against NumPy's u64 ``searchsorted``; L0-style shared rows."""
    rng = np.random.default_rng(k * 7 + (hi > 2**40))
    runs, _, keys = _level(rng, [700, 1, 0, 1500], k, hi, share=1)
    keys[:4] = [0, 2**63, hi, runs[0][0]]
    ref_blooms = [RefBloomFilter(r, {1: 1, 2: 3, 3: 4, 4: 6, 5: 7, 6: 9,
                                     7: 10}[k]) for r in runs]
    rows, starts, counts = _segments(rng, len(keys), [400] * 4, True)
    rows[:4] = [0, 1, 2, 3]
    rows.sort()
    may, found, rank = K.lookup_probe_segments(
        col(keys), col(hash_family(keys, k)), rows, starts, counts,
        [col(r) for r in runs], [col(b.bits) for b in ref_blooms],
        [b.nbits for b in ref_blooms])
    for s, (run, bf) in enumerate(zip(runs, ref_blooms)):
        seg = slice(s * len(rows), (s + 1) * len(rows))
        q = keys[rows]
        assert_array_equal(may[seg].numpy(), bf.may_contain(q))
        want = np.searchsorted(run, q)
        assert_array_equal(rank[seg].numpy(), want)
        assert_array_equal(found[seg].numpy(), (want < len(run)) & (
            run[np.minimum(want, max(len(run) - 1, 0))] == q)
            if len(run) else np.zeros(len(q), bool))


def test_segments_wrapper_checks_its_plan():
    rng = np.random.default_rng(1)
    runs, blooms, keys = _level(rng, [50], 7, U32_TOP)
    kt, kr = col(keys), col(hash_family(keys, 7))
    args = ([col(runs[0])], [col(blooms[0].bits)], [blooms[0].nbits])
    with pytest.raises(ValueError, match="rows outside"):
        K.lookup_probe_segments(kt, kr, np.array([len(keys)]), [0], [1],
                                *args)
    with pytest.raises(ValueError, match="segment outside"):
        K.lookup_probe_segments(kt, kr, np.array([0, 1]), [1], [2], *args)
    with pytest.raises(ValueError, match="filter bits"):
        K.lookup_probe_segments(kt, kr, np.array([0]), [0], [1], args[0],
                                args[1], [blooms[0].nbits + 64])
    may, found, rank = K.lookup_probe_segments(kt, kr, np.zeros(0, np.int64),
                                               [], [], [], [], [])
    assert may.shape == found.shape == rank.shape == (0,)


# ------------------------------------------------------- the store path
def _spy_levels(monkeypatch):
    """Record (rows, starts, counts) of every level probe the port makes."""
    seen = []
    real = K.lookup_probe_segments

    def spy(keys, kraw, rows, starts, counts, *a, **kw):
        seen.append((len(rows), np.asarray(starts).copy(),
                     np.asarray(counts).copy()))
        return real(keys, kraw, rows, starts, counts, *a, **kw)
    monkeypatch.setattr(K, "lookup_probe_segments", spy)
    return seen


def _store_run(pkg, engine, *, l0_rounds=0, **kw):
    """Loads 24 batches of u32-range keys (a deep level of ~40 files), then
    ``l0_rounds`` rewrites of one key set, each flushed to its own L0 table,
    then multi_gets of written and absent keys.  -> (stats, vids, the block
    cache's high- and low-priority keys in LRU order, file ids counted
    from the store's first: the id counter is one per process)."""
    store_kw = {"device": kw.pop("device")} if "device" in kw else {}
    cfg = pkg.EngineConfig.scaled(engine, 8 << 20, est_keys=16384, **kw)
    base = pkg.engine.tables.SSTable._next_fid
    store = pkg.Store(cfg, **store_kw)
    rng = np.random.default_rng(5)
    written = []
    for _ in range(24):
        ks = rng.integers(0, U32_TOP, 1024).astype(np.uint64)
        written.append(ks)
        store.write(pkg.WriteBatch().puts(ks, np.full(1024, 1024)))
    store.drain()
    hot = written[-1][:300]
    for _ in range(l0_rounds):
        store.write(pkg.WriteBatch().puts(hot, np.full(len(hot), 700)))
        store.flush()
    pool = np.concatenate(written)
    vids = []
    for _ in range(2):
        q = np.concatenate([pool[rng.integers(0, len(pool), 384)],
                            hot[rng.integers(0, len(hot), 64)],
                            rng.integers(0, U32_TOP, 128).astype(np.uint64)])
        vids.append(store.multi_get(q)["vid"].tolist())
    lru = [[(fid - base, stream, block) for fid, stream, block in q]
           for q in (store.cache._high, store.cache._low)]
    return store.stats(), vids, *lru


@pytest.mark.parametrize("engine", ["scavenger", "titan"])
def test_level_routes_when_only_its_total_reaches_min_batch(engine,
                                                            monkeypatch):
    """Every file of the deepest level gets fewer rows than
    ``kernel_min_batch`` but the level's total reaches it: the port routes
    it through one level probe.  Stats, vids and the block cache's keys in
    LRU order equal the reference's with kernels on; stats and vids equal
    its run with kernels off too (the reference's own LRU order differs
    between its kernels on and off, so the order is compared like for
    like)."""
    seen = _spy_levels(monkeypatch)
    got = _store_run(T, engine, device="cpu")
    min_batch = T.EngineConfig.kernel_min_batch
    assert any(len(c) > 1 and c.max() < min_batch <= n
               for n, _, c in seen), seen
    on = _store_run(R, engine)
    assert got == on
    off = _store_run(R, engine, use_kernels=False)
    assert got[:2] == off[:2]
    assert _store_run(T, engine, device="cpu", use_kernels=False) == off


@pytest.mark.parametrize("l0_rounds", [2, 3])
def test_l0_newest_wins_in_one_level_probe(l0_rounds, monkeypatch):
    """Several L0 tables hold the same keys: one level probe takes every
    table on the same rows, and the host walk answers newest first."""
    seen = _spy_levels(monkeypatch)
    got = _store_run(T, "scavenger", device="cpu", l0_rounds=l0_rounds,
                     kernel_min_batch=1)
    assert any(len(c) >= l0_rounds and not s.any() and (c == n).all()
               for n, s, c in seen), seen
    assert got == _store_run(R, "scavenger", l0_rounds=l0_rounds,
                             kernel_min_batch=1)
    off = _store_run(R, "scavenger", l0_rounds=l0_rounds, use_kernels=False)
    assert got[:2] == off[:2]


# ---------------------------------------------------- the fused estimate
def _sketches(width, depth, seed):
    """The reference's host-path sketch, the port's routed one (CPU: the
    plain version) and the port's host-path one, fed the same adds."""
    ref = RefSketch(width, depth, half_life=5000.0, seed=seed)
    routed = DecaySketch(width, depth, half_life=5000.0, seed=seed,
                         policy=KernelPolicy(True, 1), device="cpu")
    host = DecaySketch(width, depth, half_life=5000.0, seed=seed)
    rng = np.random.default_rng(width * 10 + depth)
    for step in range(3):
        ks = rng.integers(0, 2**64 - 1, 700, dtype=np.uint64, endpoint=True)
        ks[:3] = [0, 2**63, 2**64 - 1]
        for sk in (ref, routed, host):
            sk.add(ks)
            sk.decay_to(1000.0 * (step + 1))
    return ref, routed, host


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("width", [1, 3, 4096, 4097])
def test_sketch_estimate_matches_reference(width, depth):
    ref, routed, host = _sketches(width, depth, seed=width + depth)
    assert_array_equal(routed.counts.view(np.uint64),
                       ref.counts.view(np.uint64))
    rng = np.random.default_rng(depth)
    keys = rng.integers(0, 2**64 - 1, 900, dtype=np.uint64, endpoint=True)
    keys[:3] = [0, 2**63, 2**64 - 1]
    want = ref.estimate(keys).view(np.uint64)
    assert_array_equal(routed.estimate(keys).view(np.uint64), want)
    assert_array_equal(host.estimate(keys).view(np.uint64), want)
    # the op itself against gather_min64 at the reference's row hash
    bits = torch.from_numpy(ref.counts.view(np.int64).copy())
    got = K.sketch_estimate(bits, col(keys), col(ref._seeds))
    idx = torch.from_numpy(ref._rows(keys).T.copy())
    assert torch.equal(got, K.gather_min64_ref(bits, idx))


def test_routed_estimate_builds_no_index_matrix(monkeypatch):
    _, routed, host = _sketches(4096, 2, seed=9)
    keys = np.arange(5000, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    want = host.estimate(keys)

    def refuse(self, keys):
        raise AssertionError("the routed estimate built the index matrix")
    monkeypatch.setattr(DecaySketch, "_rows", refuse)
    assert_array_equal(routed.estimate(keys).view(np.uint64),
                       want.view(np.uint64))


def test_sketch_estimate_wrapper_checks_shapes():
    bits = torch.zeros((2, 8), dtype=torch.int64)
    keys = torch.zeros(5, dtype=torch.int64)
    with pytest.raises(ValueError):
        K.sketch_estimate(bits, keys, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        K.sketch_estimate(torch.zeros((2, 0), dtype=torch.int64), keys,
                          torch.zeros(2, dtype=torch.int64))
    assert K.sketch_estimate(bits, keys[:0],
                             torch.zeros(2, dtype=torch.int64)).shape == (0,)
