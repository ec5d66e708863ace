"""The segmented form of ``rank_probe`` and the value fetch that routes
through it, against the reference, on the CPU.

``rank_probe_segments`` (every vSST find of a multi_get or scan in one
launch on the card) runs its plain torch version here; each segment is
held against the reference's ``rank_probe`` op (``xla`` mode, its jitted
``ref.py`` oracle) on the same NumPy-seeded inputs, and past the
reference's u32 key range against NumPy's ``searchsorted``.  The store
cases hold the routing change itself: ``read_values_batch`` groups a
batch's keys by vSST and finds them in one routed call, and the port with
kernels on (every op routed) must give the stats, multi_get vids and scan
rows of the port with kernels off and of the reference, on all seven
engines, for a batch spread over hundreds of vSSTs and one on a single
vSST.  Integer outputs must be equal exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

import repro.core as R
import repro_torch.core as T
from repro import kernels as RK
from repro_torch import kernels as K

U32_TOP = 0xFFFFFFFD        # largest key the reference's u32 ops accept
STAGE_CAP = 2048            # keys a CTA stages whole (the kernel's fences)


def col(a) -> torch.Tensor:
    """NumPy u64 column -> int64 CPU tensor of the same bits."""
    a = np.ascontiguousarray(np.asarray(a, np.uint64))
    return torch.from_numpy(a.view(np.int64).copy())


def _segments(rng, sizes, counts, hi, *, every_key=False):
    """Sorted unique runs of ``sizes`` keys below ``hi`` and, per segment,
    ``counts`` queries (half run keys, the rest anywhere, 0 and hi - 1
    among them), grouped segment after segment.
    -> (runs, keys, seg_start, seg_count)."""
    runs = [np.unique(rng.integers(0, hi, n, dtype=np.uint64,
                                   endpoint=True)) for n in sizes]
    qs = []
    for run, c in zip(runs, counts):
        if every_key:
            q = run.copy()
        else:
            q = rng.integers(0, hi, c, dtype=np.uint64, endpoint=True)
            if len(run) and c:
                q[: c // 2] = run[rng.integers(0, len(run), c // 2)]
            q[: min(c, 2)] = [0, hi][: min(c, 2)]
        qs.append(q)
    counts = np.array([len(q) for q in qs], np.int64)
    starts = np.cumsum(counts) - counts
    keys = np.concatenate(qs) if qs else np.zeros(0, np.uint64)
    return runs, keys, starts, counts


SEGMENT_CASES = {   # run sizes, queries a segment
    "one": ([50], [20]),
    "empty_runs": ([0, 30, 0], [5, 10, 3]),
    "empty_segments": ([40, 30, 20, 10], [0, 12, 0, 0]),
    "one_key_runs": ([1, 1, 1, 60], [3, 1, 7, 9]),
    "staging_cap": ([STAGE_CAP - 1, STAGE_CAP, STAGE_CAP + 1], [300] * 3),
    "vsst_shape": ([2600] * 40, [10] * 40),
}


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segments_plain_matches_reference_per_segment(case):
    sizes, counts = SEGMENT_CASES[case]
    rng = np.random.default_rng(len(case) * 31 + sum(sizes))
    runs, keys, starts, counts = _segments(rng, sizes, counts, U32_TOP)
    found, rank = K.rank_probe_segments(col(keys), starts, counts,
                                        [col(r) for r in runs])
    assert found.shape == rank.shape == (int(counts.sum()),)
    for s, run in enumerate(runs):
        seg = slice(starts[s], starts[s] + counts[s])
        rfound, rrank = RK.rank_probe(keys[seg], run, mode="xla")
        assert_array_equal(found[seg].numpy(), rfound)
        assert_array_equal(rank[seg].numpy(), rrank)


@pytest.mark.parametrize("size", [1, 7, STAGE_CAP - 1, STAGE_CAP + 1])
def test_segments_plain_queries_every_run_key(size):
    """Queries equal to every key of the run: all found, ranks 0..N-1."""
    rng = np.random.default_rng(size)
    runs, keys, starts, counts = _segments(rng, [size, size], [0, 0],
                                           U32_TOP, every_key=True)
    found, rank = K.rank_probe_segments(col(keys), starts, counts,
                                        [col(r) for r in runs])
    assert found.numpy().all()
    assert_array_equal(rank.numpy(), np.concatenate(
        [np.arange(len(r)) for r in runs]))
    for s, run in enumerate(runs):
        seg = slice(starts[s], starts[s] + counts[s])
        assert_array_equal(rank[seg].numpy(),
                           RK.rank_probe(keys[seg], run, mode="xla")[1])


@pytest.mark.parametrize("nseg", [1, 2, 1200])
def test_segments_plain_on_u64_keys(nseg):
    """Keys over the whole u64 range (0, 2^63 and 2^64 - 1 among them),
    one to 1,200 segments, against NumPy's ``searchsorted``."""
    rng = np.random.default_rng(nseg)
    sizes = rng.integers(0, 60, nseg)
    counts = rng.integers(0, 12, nseg)
    runs, keys, starts, counts = _segments(rng, sizes, counts, 2**64 - 1)
    if len(keys) > 2:
        keys[2] = 2**63
    found, rank = K.rank_probe_segments(col(keys), starts, counts,
                                        [col(r) for r in runs])
    for s, run in enumerate(runs):
        seg = slice(starts[s], starts[s] + counts[s])
        want = np.searchsorted(run, keys[seg])
        assert_array_equal(rank[seg].numpy(), want)
        assert_array_equal(found[seg].numpy(), (want < len(run)) & (
            run[np.minimum(want, max(len(run) - 1, 0))] == keys[seg])
            if len(run) else np.zeros(counts[s], bool))


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segments_plain_values_at_the_keys_found(case):
    """With each run's values in a second row, the third output is the
    run's value at each key found (values up to 2^64 - 1) and 0
    elsewhere; found and rank stay those of the call without values."""
    sizes, counts = SEGMENT_CASES[case]
    rng = np.random.default_rng(len(case) * 7 + sum(counts))
    runs, keys, starts, counts = _segments(rng, sizes, counts, U32_TOP)
    vals = [rng.integers(1, 2**64 - 1, len(r), dtype=np.uint64,
                         endpoint=True) for r in runs]
    if len(vals[0]):
        vals[0][0] = 2**64 - 1
    args = (col(keys), starts, counts)
    found, rank, val = K.rank_probe_segments(
        *args, [torch.stack([col(r), col(v)]) for r, v in zip(runs, vals)],
        values=True)
    want_found, want_rank = K.rank_probe_segments(*args,
                                                  [col(r) for r in runs])
    assert_array_equal(found.numpy(), want_found.numpy())
    assert_array_equal(rank.numpy(), want_rank.numpy())
    got = val.numpy().view(np.uint64)
    for s, (run, v) in enumerate(zip(runs, vals)):
        seg = slice(starts[s], starts[s] + counts[s])
        hit = found[seg].numpy()
        assert_array_equal(got[seg][hit], v[rank[seg].numpy()[hit]])
        assert (got[seg][~hit] == 0).all()


def test_segments_may_share_and_skip_keys():
    """Segments may overlap and leave keys out: the output is segment
    after segment over the named slices."""
    run_a = np.array([2, 4, 6], np.uint64)
    run_b = np.array([1, 4, 9], np.uint64)
    keys = np.array([4, 9, 5, 1], np.uint64)
    found, rank = K.rank_probe_segments(col(keys), [0, 1], [3, 3],
                                        [col(run_a), col(run_b)])
    assert found.tolist() == [True, False, False, True, False, True]
    assert rank.tolist() == [1, 3, 2, 2, 2, 0]


def test_segments_wrapper_checks_its_plan():
    keys, run = col(np.arange(4)), col(np.arange(10))
    with pytest.raises(ValueError, match="segment outside"):
        K.rank_probe_segments(keys, [2], [3], [run])
    with pytest.raises(ValueError, match="segment outside"):
        K.rank_probe_segments(keys, [-1], [1], [run])
    with pytest.raises(ValueError, match="one start and count"):
        K.rank_probe_segments(keys, [0, 1], [1], [run])
    with pytest.raises(ValueError, match="int64"):
        K.rank_probe_segments(keys, [0], [1], [run.to(torch.int32)])
    with pytest.raises(ValueError, match="a key row, then a value row"):
        K.rank_probe_segments(keys, [0], [1], [run], values=True)
    with pytest.raises(ValueError, match="a key row, then a value row"):
        K.rank_probe_segments(keys, [0], [1], [torch.stack([run] * 3)],
                              values=True)
    with pytest.raises(ValueError, match=r"want \(n,\) runs"):
        K.rank_probe_segments(keys, [0], [1], [torch.stack([run, run])])
    found, rank = K.rank_probe_segments(keys, [], [], [])
    assert found.shape == rank.shape == (0,)


# ------------------------------------------------------- the store path
N_KEYS = 8192


def _store_run(pkg, engine, seen=None, **kw):
    """Loads N_KEYS keys of 1 KiB values (hundreds of small vSSTs),
    updates a quarter of them, then multi_gets a batch spread over every
    vSST, the keys whose newest values one vSST holds (the vSST holding
    the most), and scans.  -> (stats, multi_get vids, scan rows)."""
    store_kw = {"device": kw.pop("device")} if "device" in kw else {}
    cfg = pkg.EngineConfig.scaled(engine, 8 << 20, est_keys=N_KEYS, **kw)
    store = pkg.Store(cfg, **store_kw)
    rng = np.random.default_rng(17)
    keys = rng.permutation(np.unique(rng.integers(
        0, U32_TOP, N_KEYS + 512, dtype=np.uint64))[:N_KEYS])
    for i in range(0, N_KEYS, 1024):
        store.write(pkg.WriteBatch().puts(keys[i:i + 1024],
                                          np.full(1024, 1024)))
    store.write(pkg.WriteBatch().puts(keys[:N_KEYS // 4],
                                      np.full(N_KEYS // 4, 700)))
    store.drain()
    vids = [store.multi_get(keys[rng.integers(0, N_KEYS, 4096)])["vid"]
            .tolist()]
    live = []           # per vSST, its keys whose newest value it holds
    for t in store.version.value_files.values():
        _, newest, _ = store.latest.lookup_batch(t.keys)
        live.append(t.keys[newest == t.vids])
    if live:
        vids.append(store.multi_get(max(live, key=len))["vid"].tolist())
    starts = rng.integers(0, U32_TOP, 64).astype(np.int64)
    rows = store.multi_scan(starts, 20)
    return store.stats(), vids, rows


@pytest.mark.parametrize("engine", T.ENGINES)
def test_value_fetch_in_one_routed_find_matches_reference(engine,
                                                          monkeypatch):
    """Every op routed (``kernel_min_batch=1``): the spread batch's finds
    go to one segmented call over hundreds of vSSTs and the single
    vSST's to a call of one segment; stats, vids and scan rows equal the
    port's and the reference's with kernels off."""
    seen = []
    real = K.rank_probe_segments

    def spy(keys, starts, counts, runs, *vals, **kw):
        seen.append(len(runs))
        return real(keys, starts, counts, runs, *vals, **kw)
    monkeypatch.setattr(K, "rank_probe_segments", spy)
    got = _store_run(T, engine, device="cpu", kernel_min_batch=1)
    calls = list(seen)
    off = _store_run(T, engine, device="cpu", use_kernels=False)
    assert len(seen) == len(calls)          # kernels off: no routed find
    assert got == off
    assert got == _store_run(R, engine, use_kernels=False)
    if engine != "rocksdb":                 # rocksdb keeps no vSSTs
        assert max(calls) > 100 and 1 in calls, calls


@pytest.mark.parametrize("engine", ["scavenger", "titan"])
def test_value_fetch_routes_at_the_default_floor(engine, monkeypatch):
    """At the default ``kernel_min_batch`` the batch's total key count
    decides: the spread batch routes though each vSST gets a few keys;
    stats, vids and scan rows equal the reference's with kernels on."""
    seen = []
    real = K.rank_probe_segments

    def spy(keys, starts, counts, runs, *vals, **kw):
        seen.append((len(keys), int(np.max(counts))))
        return real(keys, starts, counts, runs, *vals, **kw)
    monkeypatch.setattr(K, "rank_probe_segments", spy)
    got = _store_run(T, engine, device="cpu")
    floor = T.EngineConfig.kernel_min_batch
    assert seen and all(n >= floor for n, _ in seen)
    assert any(most < floor for _, most in seen), seen
    assert got == _store_run(R, engine)


@pytest.mark.parametrize("min_batch", [1, 1 << 30])
def test_a_stale_locator_fails_the_strict_find(min_batch):
    """A multi_get's locator whose vid the vSST does not hold fails the
    strict check, whether the find routes (the vids come back from the
    call) or runs a ``find`` a vSST on the host; a scan's lenient find
    drops the keys it does not find."""
    from repro_torch.core.values import fetch
    cfg = T.EngineConfig.scaled("scavenger", 8 << 20, est_keys=N_KEYS,
                                kernel_min_batch=min_batch)
    store = T.Store(cfg, device="cpu")
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, U32_TOP, 4096, dtype=np.uint64))
    store.write(T.WriteBatch().puts(keys, np.full(len(keys), 1024)))
    store.drain()
    tabs = list(store.version.value_files.values())
    fsel = np.repeat([t.fid for t in tabs[:3]], 4)
    ksel = np.concatenate([t.keys[:4] for t in tabs[:3]])
    vsel = np.concatenate([t.vids[:4] for t in tabs[:3]])
    order, rank, pos = fetch.find_records(store, fsel, ksel, vsel, True)
    assert_array_equal(order, [t.fid for t in tabs[:3]])
    assert_array_equal(rank, np.repeat(np.arange(3), 4))
    assert_array_equal(pos, np.tile(np.arange(4), 3))
    stale = vsel.copy()
    stale[6] += np.uint64(1)
    with pytest.raises(AssertionError, match="stale locator"):
        fetch.find_records(store, fsel, ksel, stale, True)
    gone = ksel.copy()
    gone[5] = U32_TOP + 1
    order, rank, pos = fetch.find_records(store, fsel, gone, vsel, False)
    assert_array_equal(rank, np.delete(np.repeat(np.arange(3), 4), 5))
    assert_array_equal(pos, np.delete(np.tile(np.arange(4), 3), 5))
    with pytest.raises(AssertionError, match="stale locator"):
        fetch.find_records(store, fsel, gone, vsel, True)
