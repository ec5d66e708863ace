"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: each test skips (inside the ``cuda`` fixture, never at
collection) when no CUDA device is present.  On a machine with a card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integer outputs must be equal exactly.  This file imports nothing of the
JAX package, so it runs where JAX is not installed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.core import EngineConfig, Store, WriteBatch
from repro_torch.core.engine.keys import BloomFilter, hash_family

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _col(a, device):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.uint64)).view(np.int64)).to(device)


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("n,q,hi", [(0, 1, 2**20), (1, 1, 2**20),
                                    (1, 50, 8), (5000, 4096, 2**40),
                                    (3000, 999, 2**64 - 1)])
def test_probe_kernels_match_plain(cuda, n, q, hi):
    rng = np.random.default_rng(n + q)
    keys = np.unique(rng.integers(0, hi, n, dtype=np.uint64, endpoint=True))
    qs = rng.integers(0, hi, q, dtype=np.uint64, endpoint=True)
    if len(keys):
        qs[: q // 2] = keys[rng.integers(0, len(keys), q // 2)]
        qs[0], qs[-1] = keys[0], keys[-1]
    bf = BloomFilter(keys, 10)
    bit_idx = (hash_family(qs, bf.k) % np.uint64(bf.nbits)).T
    qt, rt = _col(qs, cuda), _col(keys, cuda)
    bt, wt = _col(bit_idx, cuda), _col(bf.bits, cuda)
    _equal(K.rank_probe(qt, rt), K.rank_probe_ref(qt, rt))
    _equal(K.lookup_probe(qt, rt, bt, wt), K.lookup_probe_ref(qt, rt, bt, wt))
    _equal((K.count_le(qt, rt),), (K.count_le_ref(qt, rt),))
    mins = np.unique(keys)            # one-key intervals [k, k]
    mt = _col(mins, cuda)
    _equal((K.interval_rank(qt, mt, mt),), (K.interval_rank_ref(qt, mt, mt),))
    rank = K.rank_probe(qt, rt)[1].cpu().numpy()
    assert (rank == np.searchsorted(keys, qs)).all()


@pytest.mark.parametrize("window", [None, 1, 3])
@pytest.mark.parametrize("m", [1, 2, 100, 4096, "cap", "cap+1", 20000])
def test_run_coalesce_matches_plain(cuda, m, window):
    from repro_torch.kernels.common import smem_sort_cap
    if isinstance(m, str):            # either side of the shared-memory sort
        m = smem_sort_cap() + (m == "cap+1")
    rng = np.random.default_rng(m)
    r = _col(rng.integers(0, max(2, m // 10), m), cuda)
    p = _col(rng.integers(0, max(2, m // 2), m), cuda)
    _equal(K.run_coalesce(r, p, window=window),
           K.run_coalesce_ref(r, p, window))


def _coalesce_pairs(rng, m, rank_bits, pos_bits):
    """m pairs below 2^bits each, the largest pinned so that exactly
    rank_bits + pos_bits key bits are in use (32 bits: below 2^32 - 1)."""
    def col(bits):
        hi = min(1 << bits, (1 << 32) - 1)
        c = rng.integers(0, hi, m)
        c[0] = hi - 1
        return c
    return col(rank_bits), col(pos_bits)


# the radix sort's key widths: u32 keys up to 32 bits (pos_bits 0 and 32
# at the ends), u64 keys from 33 bits to all 64; every pair (0, 0) takes no
# pass, every pair equal one pass or more
@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("m,rank_bits,pos_bits", [
    (1, 12, 16), (2, 12, 16), (3, 12, 16), (1000, 12, 16), (4096, 12, 16),
    ("cap", 12, 16), ("cap+1", 12, 16), (4096, 0, 0), (4096, 12, 20),
    (4096, 13, 20), (4096, 0, 32), (4096, 32, 0), (4096, 32, 32),
    ("cap", 32, 32), ("cap", 1, 1)])
def test_run_coalesce_key_widths_match_plain(cuda, m, rank_bits, pos_bits,
                                             window):
    from repro_torch.kernels.common import smem_sort_cap
    if isinstance(m, str):
        m = smem_sort_cap() + (m == "cap+1")
    rng = np.random.default_rng(m + 64 * rank_bits + pos_bits)
    r, p = _coalesce_pairs(rng, m, rank_bits, pos_bits)
    rt, pt = _col(r, cuda), _col(p, cuda)
    got = K.run_coalesce(rt, pt, window=window)
    _equal(got, K.run_coalesce_ref(rt, pt, window))
    order = np.lexsort((p, r))
    assert (got[0].cpu().numpy() == r[order]).all()
    assert (got[1].cpu().numpy() == p[order]).all()


@pytest.mark.parametrize("m", [2, 1000, 4096])
def test_run_coalesce_all_pairs_equal(cuda, m):
    r = _col(np.full(m, 7), cuda)
    p = _col(np.full(m, 123456), cuda)
    for window in (None, 1):
        rank_s, pos_s, keep, start = K.run_coalesce(r, p, window=window)
        _equal((rank_s, pos_s, keep, start),
               K.run_coalesce_ref(r, p, window))
        assert int(keep.sum()) == 1 and bool(keep[0]) and bool(start[0])


@pytest.mark.parametrize("m,slots", [(0, 8), (1, 1), (13, 7), (300, 64),
                                     (8192, 8192), (1024, 32768), (5, 0)])
def test_segment_sum_matches_plain(cuda, m, slots):
    rng = np.random.default_rng(m + slots)
    ids = torch.from_numpy(rng.integers(-1, slots + 2, m)).to(cuda)
    _equal((K.segment_sum(ids, slots),), (K.segment_sum_ref(ids, slots),))


# the index form's one launch: slot counts either side of a CTA's range
# ("r", kernels.cu kSegRange), no ids, ids outside the slots, an id column
# 8 bytes off a 16-byte boundary, the lifetime histogram's ids (one a row
# of 32), every id on one slot; the one launch at its caps (4,096 ids,
# 131,072 slots: kSegMaxIds, kSegMaxSlots) and the atomic form one past
# each, with no ids past the slot cap (the one launch writes the zeros),
# far more ids than slots, and a long column into many slots
SEGMENT_RANGE_CASES = [
    (1018, "r-1", "random"), (1018, "r", "random"), (1018, "r+1", "random"),
    (1018, "2r+1", "random"), (0, "r+1", "random"), (0, 1, "random"),
    (1, "r", "random"), (300, "r+1", "shift"), (301, 5001, "shift"),
    (1018, 32576, "tracker"), (4096, 1024, "one_slot"),
    (4096, 131072, "random"), (4097, 1000, "random"),
    (1018, 131073, "random"), (0, 131073, "random"), (4097, 131073, "shift"),
    (5000, 1024, "one_slot"), (50000, 17, "random"),
    (400000, 100000, "random"), (1 << 20, 1 << 25, "random")]


@pytest.mark.parametrize("p,slots,kind", SEGMENT_RANGE_CASES)
def test_segment_sum_ranges_match_plain(cuda, p, slots, kind):
    if isinstance(slots, str):
        from repro_torch.kernels.common import segment_range
        r = segment_range()
        slots = {"r-1": r - 1, "r": r, "r+1": r + 1, "2r+1": 2 * r + 1}[slots]
    rng = np.random.default_rng(p + slots)
    if kind == "tracker":
        ids = np.arange(p) * 32 + rng.integers(0, 32, p)
    elif kind == "one_slot":
        ids = np.full(p, slots // 2)
    else:
        ids = rng.integers(-3, slots + 3, p)
    t = torch.from_numpy(ids.astype(np.int64)).to(cuda)
    if kind == "shift":
        t = torch.cat([t[:1], t])[1:]
        assert t.data_ptr() % 16 == 8
    got = K.segment_sum(t, slots)
    _equal((got,), (K.segment_sum_ref(t, slots),))
    valid = ids[(ids >= 0) & (ids < slots)]
    assert (got.cpu().numpy() == np.bincount(valid, minlength=slots)).all()


@pytest.mark.parametrize("d,w,q", [(1, 1, 1), (2, 50, 33), (4, 100, 64),
                                   (3, 7, 1), (2, 4096, 4096)])
def test_gather_min64_matches_plain(cuda, d, w, q):
    rng = np.random.default_rng(d * 100 + w + q)
    vals = rng.random((d, w)) * 1e6
    vals[rng.random((d, w)) < 0.2] = 0.0
    vals[0, 0] = -0.0                     # sign bit set: above every value
    bits = torch.from_numpy(vals.view(np.int64).copy()).to(cuda)
    idx = torch.from_numpy(rng.integers(0, w, (q, d))).to(cuda)
    got = K.gather_min64(bits, idx)
    _equal((got,), (K.gather_min64_ref(bits, idx),))


# lookup_probe's level form: (run sizes, segment counts, k, key bound,
# rows shared as in L0); empty and one-key runs, zero-query segments,
# segments straddling tiles, a run past the fence cap, keys >= 2^63
LEVEL_CASES = {
    "one_file": ([5000], [3000], 7, 2**40, False),
    "empty_and_one_key_runs": ([0, 1, 300, 1, 0], [10, 20, 600, 1, 3], 7,
                               2**64, False),
    "zero_query_segments": ([100, 200, 300], [0, 257, 0], 7, 2**40, False),
    "many_files": ([12000] * 40, [51] * 40, 7, 2**64, False),
    "l0_shared_rows": ([12000, 9000, 5, 0], [4000] * 4, 7, 2**40, True),
    "past_fence_cap": ([2048 * 32 + 1], [2000], 7, 2**64, False),
    **{f"k{k}": ([900, 400], [300, 200], k, 2**64, k % 2 == 1)
       for k in range(1, 8)},
}


@pytest.mark.parametrize("tile,stride", [(512, 32), (64, 4), (1024, 1)])
@pytest.mark.parametrize("case", sorted(LEVEL_CASES))
def test_level_probe_matches_plain(cuda, case, tile, stride):
    sizes, counts, k, hi, shared = LEVEL_CASES[case]
    bpk = {1: 1, 2: 3, 3: 4, 4: 6, 5: 7, 6: 9, 7: 10}[k]
    rng = np.random.default_rng(len(case) * 100 + k)
    runs = [np.unique(rng.integers(0, hi - 1, n, dtype=np.uint64,
                                   endpoint=True)) for n in sizes]
    if shared and len(runs[0]):        # tables holding the same keys
        runs = [runs[0]] + [np.unique(np.concatenate([r, runs[0][:30]]))
                            for r in runs[1:]]
    blooms = [BloomFilter(r, bpk) for r in runs]
    pool = np.concatenate(runs + [np.zeros(1, np.uint64)])
    keys = np.concatenate([pool[rng.integers(0, len(pool), 3000)],
                           rng.integers(0, hi - 1, 3000, dtype=np.uint64,
                                        endpoint=True)])
    keys[:3] = [0, 2**63, hi - 1]
    counts = np.asarray(counts, np.int64)
    if shared:
        rows = np.sort(rng.choice(len(keys), counts.max(), replace=False))
        starts = np.zeros(len(counts), np.int64)
        counts = np.full(len(counts), len(rows), np.int64)
    else:
        rows = rng.integers(0, len(keys), counts.sum())
        starts = np.cumsum(counts) - counts
    args = (_col(keys, cuda), _col(hash_family(keys, k), cuda),
            rows.astype(np.int64), starts, counts,
            [_col(r, cuda) for r in runs],
            [_col(b.bits, cuda) for b in blooms], [b.nbits for b in blooms])
    n0 = K.lookup_probe.launches
    got = K.lookup_probe_segments(*args, _tile=tile, _stride=stride)
    assert K.lookup_probe.launches == n0 + 1
    _equal(got, K.lookup_probe_segments_ref(*args))
    rank = got[2].cpu().numpy()
    out = 0
    for s, run in enumerate(runs):
        q = keys[rows[starts[s]:starts[s] + counts[s]]]
        assert (rank[out:out + len(q)] == np.searchsorted(run, q)).all()
        out += len(q)


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("width", [1, 3, 4096, 4097])
def test_sketch_estimate_matches_plain(cuda, width, depth):
    from repro_torch.core.engine.keys import splitmix64
    rng = np.random.default_rng(width + depth)
    vals = rng.random((depth, width)) * 1e6
    vals[rng.random((depth, width)) < 0.2] = 0.0
    vals[0, 0] = -0.0
    seeds = splitmix64(np.uint64(7) + np.arange(1, depth + 1,
                                                 dtype=np.uint64))
    keys = rng.integers(0, 2**64 - 1, 6000, dtype=np.uint64, endpoint=True)
    keys[:3] = [0, 2**63, 2**64 - 1]
    bits = torch.from_numpy(vals.view(np.int64).copy()).to(cuda)
    kt, st = _col(keys, cuda), _col(seeds, cuda)
    n0 = K.gather_min64.launches
    got = K.sketch_estimate(bits, kt, st)
    assert K.gather_min64.launches == n0 + 1
    _equal((got,), (K.sketch_estimate_ref(bits, kt, st),))
    idx = (splitmix64(keys[None, :] ^ seeds[:, None])
           % np.uint64(width)).astype(np.int64)
    want = vals.view(np.uint64)[np.arange(depth)[:, None], idx].min(0)
    assert (got.cpu().numpy().view(np.uint64) == want).all()


def _bits64(t):
    return t.cpu().view(torch.int64)


# (depth, width, keys): one key, the store's sketch, widths not a power of
# two, more keys than slots, tables of 2^18 slots and just past
SKETCH_ADD_CASES = {"d1_w1": (1, 1, 300), "d2_w3": (2, 3, 1),
                    "store": (2, 4096, 4096), "d3_w4097": (3, 4097, 5000),
                    "d5_w1000": (5, 1000, 20000), "wide": (2, 131072, 4096),
                    "wider": (1, 262145, 4096), "d4_w70000": (4, 70000, 3000)}


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("keys_kind", ["uniform", "equal", "top_bit"])
@pytest.mark.parametrize("case", sorted(SKETCH_ADD_CASES))
def test_sketch_add_matches_plain(cuda, case, keys_kind, scaled):
    """Decayed fractional counters; every counter bit-identical to the
    plain version's; the scratch is zero again after the call."""
    from repro_torch.core.engine.keys import splitmix64
    d, w, q = SKETCH_ADD_CASES[case]
    rng = np.random.default_rng(d * 1000 + q)
    vals = rng.random((d, w)) * 1e3
    vals[rng.random((d, w)) < 0.3] = 0.0
    keys = rng.integers(0, 2**64 - 1, q, dtype=np.uint64, endpoint=True)
    if keys_kind == "equal":
        keys[:] = keys[0]
    elif keys_kind == "top_bit":
        keys |= np.uint64(1 << 63)
    seeds = splitmix64(np.uint64(3) + np.arange(1, d + 1, dtype=np.uint64))
    scale = 0.5 ** (37.0 / 1000.0) if scaled else None
    kt, st = _col(keys, cuda), _col(seeds, cuda)
    got = torch.from_numpy(vals.copy()).to(cuda)
    want = got.clone()
    scratch = torch.zeros(d * w, dtype=torch.int32, device=cuda)
    n0 = K.segment_sum.launches, K.sketch_add.launches
    K.sketch_add(got, kt, st, scale=scale, scratch=scratch)
    assert (K.segment_sum.launches, K.sketch_add.launches) == \
        (n0[0] + 1, n0[1] + 1)
    K.sketch_add_ref(want, kt, st, scale)
    assert torch.equal(_bits64(got), _bits64(want))
    assert not scratch.any()
    # the host's own arithmetic: counts * f, then + bincount per row
    idx = (splitmix64(keys[None, :] ^ seeds[:, None])
           % np.uint64(w)).astype(np.int64)
    host = vals * scale if scaled else vals.copy()
    for r in range(d):
        host[r] += np.bincount(idx[r], minlength=w)
    assert (got.cpu().numpy().view(np.int64) == host.view(np.int64)).all()


def test_sketch_add_scale_only(cuda):
    vals = np.random.default_rng(1).random((2, 4096)) * 9.0
    got = torch.from_numpy(vals.copy()).to(cuda)
    keys = torch.zeros(0, dtype=torch.int64, device=cuda)
    seeds = torch.zeros(2, dtype=torch.int64, device=cuda)
    n0 = K.sketch_add.launches
    K.sketch_add(got, keys, seeds)           # nothing to do: no launch
    assert K.sketch_add.launches == n0
    K.sketch_add(got, keys, seeds, scale=0.7)
    assert K.sketch_add.launches == n0 + 1
    assert (got.cpu().numpy().view(np.int64)
            == (vals * 0.7).view(np.int64)).all()


def test_resident_sketch_on_card_matches_host_and_does_not_wait(cuda):
    """A resident sketch on the card against the port's host sketch over
    decays, adds and estimates, bit for bit; an add returns while the card
    is still busy (it waits for nothing)."""
    from repro_torch.core.accel import KernelPolicy
    from repro_torch.core.adaptive.sketch import DecaySketch
    host = DecaySketch(4096, 2, 5000.0, seed=5)
    dev = DecaySketch(4096, 2, 5000.0, seed=5,
                      policy=KernelPolicy(True, 1000), device=cuda)
    assert dev._dev.is_cuda
    rng = np.random.default_rng(8)
    for i in range(20):
        keys = rng.integers(0, 1 << 40, int(rng.integers(1, 5000)),
                            dtype=np.uint64)
        for sk in (host, dev):
            sk.decay_to(float(i * 700))
            sk.add(keys)
        if i % 5 == 4:
            assert (dev.estimate(keys).view(np.int64)
                    == host.estimate(keys).view(np.int64)).all()
            assert dev.total_mass() == host.total_mass()
            assert dev.active_slots() == host.active_slots()
    assert (dev.counts.view(np.int64) == host.counts.view(np.int64)).all()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)           # ~0.1 s of spinning
    dev.decay_to(1e6)
    dev.add(np.arange(4096, dtype=np.uint64))
    assert not torch.cuda.current_stream().query()
    torch.cuda.synchronize()


@pytest.mark.parametrize("interval", [False, True])
@pytest.mark.parametrize("n", [0, 1, 7, 8, 95, "cap", "cap+1"])
def test_count_le_at_the_shared_memory_cap(cuda, n, interval):
    """count_le and interval_rank with the level's bounds in shared memory
    (8 files up to the cap) and in device memory (fewer, or past the cap);
    queries equal to every min and max, just either side of them, and at
    0 and 2^64 - 1."""
    from repro_torch.kernels.common import count_le_smem_files
    if isinstance(n, str):
        n = count_le_smem_files() + (n == "cap+1")
    rng = np.random.default_rng(n)
    edges = np.unique(rng.integers(1, 2**64 - 2, 2 * n, dtype=np.uint64))
    while len(edges) < 2 * n:
        edges = np.unique(np.concatenate([edges, rng.integers(
            1, 2**64 - 2, 2 * n, dtype=np.uint64)]))
    edges = edges[:2 * n]
    mins, maxs = edges[0::2], edges[1::2]
    maxs[: n // 3] = mins[: n // 3]          # some one-key intervals
    qs = np.concatenate([mins, maxs, mins - np.uint64(1),
                         maxs + np.uint64(1),
                         np.array([0, 2**63, 2**64 - 1], np.uint64),
                         rng.integers(0, 2**64 - 1, 10942, dtype=np.uint64,
                                      endpoint=True)])
    qt, mt, xt = _col(qs, cuda), _col(mins, cuda), _col(maxs, cuda)
    if interval:
        got, want = K.interval_rank(qt, mt, xt), \
            K.interval_rank_ref(qt, mt, xt)
    else:
        got, want = K.count_le(qt, mt), K.count_le_ref(qt, mt)
    _equal((got,), (want,))
    cnt = np.searchsorted(mins, qs, side="right")
    if interval:
        ok = (cnt > 0) & (qs <= maxs[np.maximum(cnt - 1, 0)]) if n else \
            np.zeros(len(qs), bool)
        cnt = np.where(ok, cnt - 1, -1)
    assert (got.cpu().numpy() == cnt).all()


def test_durable_adaptive_store_opens_on_card(cuda, tmp_path):
    """A durable scavenger_adaptive store on the card recovers on the card
    (``Store.open(..., device="cuda")``) to the CPU store's state."""
    def run(device, path):
        cfg = EngineConfig.scaled("scavenger_adaptive", 8 << 20,
                                  est_keys=4096, kernel_min_batch=1)
        store = Store(cfg, durability_dir=path, device=device)
        rng = np.random.default_rng(2)
        for i in range(6):
            if i == 3:
                store.checkpoint()
            keys = rng.integers(0, 4096, 512).astype(np.uint64)
            store.write(WriteBatch().puts(keys, np.full(512, 1024)))
            store.multi_get(keys[::3])
        store.close()
        rec = Store.open(path, device=device)
        assert rec.device.type == torch.device(device).type
        return rec.stats(), rec.multi_get(
            np.arange(4096, dtype=np.uint64))["vid"].tolist()
    assert run(cuda, tmp_path / "card") == run("cpu", tmp_path / "cpu")


@pytest.mark.parametrize("engine", ["titan", "scavenger",
                                    "scavenger_adaptive"])
def test_store_on_card_matches_cpu(cuda, engine):
    def run(device, **kw):
        cfg = EngineConfig.scaled(engine, 8 << 20, est_keys=4096, **kw)
        store = Store(cfg, device=device)
        rng = np.random.default_rng(1)
        vids = []
        for _ in range(4):
            keys = rng.integers(0, 4096, 512).astype(np.uint64) << 35
            store.write(WriteBatch().puts(keys, np.full(512, 1024)))
            vids.append(store.multi_get(keys[::2])["vid"].tolist())
        store.drain()
        return store.stats(), vids
    assert run(cuda, kernel_min_batch=1) == run("cpu", use_kernels=False)


@pytest.mark.parametrize("policy", ["range", "hash"])
def test_fleet_on_card_matches_cpu(cuda, policy):
    """A small replicated, elastic 3-shard fleet on the card (every probe
    routed) against the same fleet on the CPU with kernels off: stats,
    reads, scans, migrations, and the replica ``fail_primary`` promotes."""
    from repro_torch.core import ShardedStore

    def run(device, **kw):
        cfg = EngineConfig.scaled("scavenger", 4 << 20, est_keys=1024,
                                  replica_count=1, elastic_split_frac=0.5,
                                  elastic_cooldown_ops=512,
                                  migration_chunk_records=128, **kw)
        fleet = ShardedStore(cfg, n_shards=3, shard_policy=policy,
                             key_space=4096, device=device)
        rng = np.random.default_rng(3)
        vids, rows = [], []
        for i in range(8):
            if i == 4 and not fleet.migrations:   # hash: no hot shard
                assert fleet.split_shard(0) is not None
            keys = rng.integers(0, 1024, 512).astype(np.uint64)
            fleet.write(WriteBatch().puts(keys, rng.choice(
                [64, 600, 2000, 9000], 512).astype(np.int64)))
            vids.append(fleet.multi_get(keys[::2])["vid"].tolist())
            rows.append(fleet.multi_scan(
                rng.integers(0, 4096, 8).astype(np.int64), 20))
        promoted = fleet.fail_primary(0)
        assert promoted.device.type == torch.device(device).type
        fleet.drain()
        vids.append(fleet.multi_get(np.arange(4096, dtype=np.uint64))
                    ["vid"].tolist())
        return (fleet.stats(), promoted.stats(), fleet.migrations, vids,
                rows)
    card = run(cuda, kernel_min_batch=1)
    assert card[0]["n_migrations"] >= 1
    assert card == run("cpu", use_kernels=False)


def _u32(a, device):
    from repro_torch.kernels.common import u32_tensor
    return u32_tensor(np.asarray(a), device)


def _offpath_cases(kernel, device):
    """Operand tuples for one benchmark kernel: the reference bench's shapes
    and the edges (empty, one, ragged tiles, keys at the top of u32)."""
    from repro_torch.bench import kernels as B
    rng = np.random.default_rng(9)
    out = [B.operands(c, device) for c in B.bench_cases() if c.kernel == kernel]
    keys = np.sort(rng.choice(2**32 - 2, 3000, replace=False)).astype(
        np.uint32)
    keys[-1] = 0xFFFFFFFD
    if kernel == "gc_lookup":
        # runs around the search's round and window sizes, duplicate keys
        # (the first copy answers), and a key column 4 bytes off a 16-byte
        # boundary (the scalar loads)
        sizes = [(0, 5), (1, 1), (3000, 0), (3000, 4097)] + [
            (m, 600) for e in (3, 4, 5, 6, 10) for m in
            ((1 << e) - 1, 1 << e, (1 << e) + 1)]
        dup = np.sort(np.concatenate([keys, keys[::3]]))[:3000]
        for n, q in sizes + [("dup", 3000), ("shift", 3000)]:
            run = dup if n == "dup" else keys[:3000 if n == "shift" else n]
            qs = np.concatenate([run[:q // 2], [0xFFFFFFFD, 0xFFFFFFFE,
                                                0xFFFFFFFF, 0],
                                 rng.integers(0, 2**32, q, dtype=np.uint64)
                                 .astype(np.uint32)])[:q]
            cols = [_u32(a, device) for a in (qs, run, run + 1, run % 97)]
            if n == "shift":
                cols[1] = _u32(np.concatenate([[0], run]), device)[1:]
            out.append(tuple(cols))
    elif kernel == "bloom_probe":
        from repro_torch.kernels import bloom_build
        words, k, nbits = bloom_build(_u32(keys, device))
        for q in (0, 1, 4097):
            out.append((_u32(np.resize(keys, q), device), words, k, nbits))
    elif kernel == "merge_dedup":
        seq = rng.integers(0, 2**32, 3000, dtype=np.uint64).astype(np.uint32)
        for na, nb in ((0, 0), (0, 7), (7, 0), (1, 1), (3000, 3000)):
            a = (keys[:na], np.zeros(na, np.uint32), seq[:na])
            b = (keys[:nb], seq[:nb] | 1, seq[:nb])
            out.append(tuple(_u32(c, device) for c in (*a, *b)))
    elif kernel == "hot_cold_partition":
        # tiles cut either side of a record, three and a ragged fourth (all
        # hot, none, only the last tile's), and operands 4 bytes off a
        # 16-byte boundary (the scalar loads)
        from repro_torch.kernels.common import partition_tile
        tile = partition_tile()
        for n, share in ((0, .3), (1, 1.), (1025, 0.), (1025, 1.),
                         (5000, .3), (tile - 1, .3), (tile, .3),
                         (tile + 1, .3), (3 * tile + 5, 1.),
                         (3 * tile + 5, 0.), (3 * tile + 5, "last"),
                         (3 * tile + 5, "shift"), (tile - 3, "shift")):
            h = rng.random(n) < (.3 if isinstance(share, str) else share)
            if share == "last":
                h[:(n - 1) // tile * tile] = False
            cols = (np.resize(keys, n), np.arange(n), np.full(n, 7))
            if share == "shift":
                k, v, z = (_u32(np.concatenate([[0], c]), device)[1:]
                           for c in cols)
                hot = torch.from_numpy(np.concatenate([[True], h])).to(
                    device)[1:]
            else:
                k, v, z = (_u32(c, device) for c in cols)
                hot = torch.from_numpy(h).to(device)
            out.append((k, hot, v, z))
    else:
        for dtype, ps, d in ((torch.bfloat16, 3, 5), (torch.int32, 4, 256),
                             (torch.bfloat16, 16, 128)):
            pages = torch.from_numpy(rng.standard_normal((32, ps, d)) * 10)
            table = torch.from_numpy(rng.integers(0, 32, (3, 5)).astype(
                np.int32))
            out.append((table, pages.to(dtype).to(device)))
    return out


@pytest.mark.parametrize("kernel", ["gc_lookup", "bloom_probe", "merge_dedup",
                                    "hot_cold_partition", "page_gather"])
def test_benchmark_kernels_match_plain(cuda, kernel):
    fn = getattr(K, kernel)
    plain = getattr(K, kernel + "_ref")
    for args in _offpath_cases(kernel, cuda):
        got, want = fn(*args), plain(*args)
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        _equal(got, want)


def _unmix32(h: int) -> int:
    """The key whose murmur3 finalizer (``mix32``) is ``h``."""
    def unshift(x, s):
        y = x
        for _ in range(32 // s):
            y = x ^ (y >> s)
        return y & 0xFFFFFFFF
    x = unshift(h, 16)
    x = (x * pow(0xC2B2AE35, -1, 1 << 32)) & 0xFFFFFFFF
    x = unshift(x, 13)
    x = (x * pow(0x85EBCA6B, -1, 1 << 32)) & 0xFFFFFFFF
    return unshift(x, 16)


def _dense_words(rng, n):
    """n filter words with 7/8 of their bits set (so that some queries
    find every bit set at k up to 17)."""
    return np.bitwise_or.reduce(
        rng.integers(0, 1 << 32, (3, n), dtype=np.uint64)).astype(np.uint32)


# bloom_probe: k either side of the kernel's batch of 8 word loads and past
# two, query counts around a warp and a CTA, nbits below 32 * len(words)
# and no multiple of 32; and once with queries and words 4 bytes off a
# 16-byte boundary (the kernel loads 4-byte words only)
@pytest.mark.parametrize("k,q,shift", [
    *((k, q, 0) for k in (0, 1, 3, 7, 8, 9, 17)
      for q in (0, 1, 31, 33, 4097)), (7, 4097, 1)])
def test_bloom_probe_edges_match_plain(cuda, k, q, shift):
    rng = np.random.default_rng(100 * k + q + shift)
    words = _dense_words(rng, 1000)
    qs = rng.integers(0, 1 << 32, q, dtype=np.uint64).astype(np.uint32)
    qt = _u32(np.concatenate([np.zeros(shift, np.uint32), qs]), cuda)[shift:]
    wt = _u32(np.concatenate([np.zeros(shift, np.uint32), words]),
              cuda)[shift:]
    assert q == 0 or qt.data_ptr() % 16 == 4 * shift
    for nbits in (32 * 1000, 32 * 1000 - 5, 997):
        _equal((K.bloom_probe(qt, wt, k, nbits),),
               (K.bloom_probe_ref(qt, wt, k, nbits),))


def test_bloom_probe_at_the_top_of_u32(cuda):
    """nbits 2^32 - 1 (2^27 words, 512 MiB): the wrapping h1 + j*h2 and
    the fast modulo at the top of the u32 range, with queries whose h1 is
    2^32 - 1 (bit 0) and 2^32 - 2 (the filter's last bit)."""
    rng = np.random.default_rng(32)
    n_words = 1 << 27
    wt = torch.randint(-(1 << 31), 1 << 31, (n_words,), dtype=torch.int32,
                       device=cuda)
    for _ in range(2):
        wt |= torch.randint(-(1 << 31), 1 << 31, (n_words,),
                            dtype=torch.int32, device=cuda)
    qs = rng.integers(0, 1 << 32, 4097, dtype=np.uint64).astype(np.uint32)
    qs[:4] = [_unmix32(0xFFFFFFFF), _unmix32(0xFFFFFFFE), 0, 0xFFFFFFFF]
    qt = _u32(qs, cuda)
    for k in (1, 2, 7, 17):
        _equal((K.bloom_probe(qt, wt, k, (1 << 32) - 1),),
               (K.bloom_probe_ref(qt, wt, k, (1 << 32) - 1),))


# rank_probe's run form: runs either side of the staging threshold, at the
# whole-run staging cap and past it, at the fence cap of the wrapper's
# stride and past it (the fence stride widens), and long; the stride the
# wrapper picks (None), none (0), and given ones
@pytest.mark.parametrize("stride", [None, 0, 1, 8])
@pytest.mark.parametrize("n", [0, 1, 2, "min-1", "min", 631, 2047, 2048,
                               2049, 4097, "cap", "cap+1", 20000])
def test_rank_probe_run_form_matches_plain(cuda, n, stride):
    from repro_torch.kernels.lookup_probe.ops import (RUN_FENCE_STRIDE,
                                                     RUN_STAGE_MIN)
    if isinstance(n, str) and n.startswith("cap"):   # 2,048 fences
        n = 2048 * RUN_FENCE_STRIDE + (n == "cap+1")
    elif isinstance(n, str):
        n = RUN_STAGE_MIN - (n == "min-1")
    rng = np.random.default_rng(n * 7 + (stride or 0))
    run = np.unique(rng.integers(1, 2**64 - 2, n, dtype=np.uint64))
    qs = np.concatenate([run, run + np.uint64(1), run - np.uint64(1),
                         np.array([0, 2**63, 2**64 - 1], np.uint64),
                         rng.integers(0, 2**64 - 1, 10096, dtype=np.uint64,
                                      endpoint=True)])
    qt, rt = _col(qs, cuda), _col(run, cuda)
    n0 = K.rank_probe.launches
    got = K.rank_probe(qt, rt, _stride=stride)
    assert K.rank_probe.launches == n0 + 1
    _equal(got, K.rank_probe_ref(qt, rt))
    assert (got[1].cpu().numpy() == np.searchsorted(run, qs)).all()


# rank_probe's segmented form: (run sizes, queries a segment); empty runs
# and segments, one-key runs, runs at the staging cap and at the fence cap
# of the wrapper's stride and past it, vSST finds (hundreds of ~2,600-key
# runs, ~10 queries each, and the main run's 1,530 runs of 631 keys, ~3
# queries each), and a segment past one tile
RANK_SEGMENT_CASES = {
    "empty_runs_and_segments": ([0, 30, 0, 40, 1], [5, 10, 3, 0, 4]),
    "one_key_runs": ([1] * 50, [3] * 50),
    "staging_cap": ([2047, 2048, 2049], [700, 700, 700]),
    "fence_cap": ([2048 * 8, 2048 * 8 + 1, 2048 * 4 + 1], [500, 500, 500]),
    "vsst_finds": ([2600] * 400, [10] * 400),
    "vsst_finds_main_run": ([631] * 1530, [3] * 1530),
    "past_one_tile": ([20000, 5], [3000, 1500]),
    "many_segments": ([30] * 1200, [4] * 1200),
}


@pytest.mark.parametrize("tile,stride", [(None, None), (32, 2), (1024, 1),
                                         (64, 64), (None, 4)])
@pytest.mark.parametrize("case", sorted(RANK_SEGMENT_CASES))
def test_rank_probe_segments_matches_plain(cuda, case, tile, stride):
    sizes, counts = RANK_SEGMENT_CASES[case]
    rng = np.random.default_rng(len(case) * 13)
    runs = [np.unique(rng.integers(0, 2**64 - 1, n, dtype=np.uint64,
                                   endpoint=True)) for n in sizes]
    qs = []
    for run, c in zip(runs, counts):
        q = rng.integers(0, 2**64 - 1, c, dtype=np.uint64, endpoint=True)
        if len(run) and c:
            q[: c // 2] = run[rng.integers(0, len(run), c // 2)]
            q[: min(c, 3)] = np.array([0, 2**64 - 1, run[-1]],
                                      np.uint64)[: min(c, 3)]
        qs.append(q)
    keys = np.concatenate(qs)
    counts = np.array(counts, np.int64)
    starts = np.cumsum(counts) - counts
    args = (_col(keys, cuda), starts, counts, [_col(r, cuda) for r in runs])
    kw = {} if tile is None else {"_tile": tile}
    if stride is not None:
        kw["_stride"] = stride
    n0, s0 = K.rank_probe.launches, K.rank_probe_segments.launches
    got = K.rank_probe_segments(*args, **kw)
    assert K.rank_probe.launches == n0 + 1
    assert K.rank_probe_segments.launches == s0 + 1
    _equal(got, K.rank_probe_segments_ref(*args))
    rank = got[1].cpu().numpy()
    for s, run in enumerate(runs):
        seg = slice(starts[s], starts[s] + counts[s])
        assert (rank[seg] == np.searchsorted(run, keys[seg])).all()


@pytest.mark.parametrize("stride", [None, 1])
@pytest.mark.parametrize("case", sorted(RANK_SEGMENT_CASES))
def test_rank_probe_segments_values_match_plain(cuda, case, stride):
    """With each run's values in a second row (the vids the strict
    locator check compares), at the wrapper's stride and at stride 1: the
    value at each key found, 0 elsewhere, as the plain version gives
    it."""
    sizes, counts = RANK_SEGMENT_CASES[case]
    rng = np.random.default_rng(len(case) * 17)
    runs = [np.unique(rng.integers(0, 2**64 - 1, n, dtype=np.uint64,
                                   endpoint=True)) for n in sizes]
    vals = [rng.integers(0, 2**64 - 1, len(r), dtype=np.uint64,
                         endpoint=True) for r in runs]
    qs = [np.concatenate([r[rng.integers(0, len(r), c // 2)] if len(r)
                          else np.zeros(0, np.uint64),
                          rng.integers(0, 2**64 - 1, c - (c // 2 if len(r)
                                                          else 0),
                                       dtype=np.uint64, endpoint=True)])
          for r, c in zip(runs, counts)]
    counts = np.array([len(q) for q in qs], np.int64)
    starts = np.cumsum(counts) - counts
    args = (_col(np.concatenate(qs), cuda), starts, counts,
            [torch.stack([_col(r, cuda), _col(v, cuda)])
             for r, v in zip(runs, vals)])
    kw = {"values": True} | ({} if stride is None else {"_stride": stride})
    got = K.rank_probe_segments(*args, **kw)
    assert len(got) == 3
    _equal(got, K.rank_probe_segments_ref(*args, values=True))


def _merge_runs(rng, na, nb, kind):
    """Sorted runs of unique u32 keys (A's seqs even, B's odd) for the
    merge's tile edges: ``split``: a key's two copies on either side of a
    tile boundary; ``shared``: every key in both; ``equal``: every key in
    both with equal seqs; ``top``: key 0xFFFFFFFF in both."""
    space = np.arange(4 * (na + nb) + 4, dtype=np.uint32)
    ak = np.sort(rng.choice(space, na, replace=False))
    bk = np.sort(rng.choice(space, nb, replace=False))
    aseq = rng.integers(0, 1 << 30, na).astype(np.uint32) * 2
    bseq = rng.integers(0, 1 << 30, nb).astype(np.uint32) * 2 + 1
    if kind == "split":             # pair k at rows 2k - 1 and 2k
        ak = np.arange(na, dtype=np.uint32)
        bk = ak[1:nb + 1].copy()
        bseq = aseq[1:nb + 1] + 1
    elif kind in ("shared", "equal"):
        bk = ak.copy()
        bseq = aseq.copy() if kind == "equal" else aseq + 1
    elif kind == "top" and na and nb:
        ak[-1] = bk[-1] = 0xFFFFFFFF
    return (ak, aseq, ak * 3), (bk, bseq, bk * 5)


@pytest.mark.parametrize("items", [None, 1, 8])
@pytest.mark.parametrize("na,nb,kind", [
    (0, 1, ""), (1, 0, ""), (0, 4097, ""), (5000, 0, ""), (1, 1, ""),
    (3, 2044, ""), ("tile", "tile", ""), ("tile-1", "tile+1", ""),
    (2049, 2047, ""), (12345, 777, ""), (1 << 19, 1 << 19, ""),
    ("tile+1", "tile", "split"), (4097, 4096, "split"),
    (3000, 3000, "shared"), (3000, 3000, "equal"), (2500, 1700, "top")])
def test_merge_dedup_merge_path_matches_plain(cuda, na, nb, kind, items):
    """At the rows a thread the wrapper picks (None) and at each choice,
    with runs ending at the chosen tile's boundaries (8 rows a thread's
    where the wrapper picks)."""
    from repro_torch.kernels.common import merge_threads, u32_tensor
    tile = merge_threads() * (items or 8)
    na, nb = ({"tile": tile, "tile-1": tile - 1, "tile+1": tile + 1}.get(
        x, x) for x in (na, nb))
    if kind in ("shared", "equal"):
        nb = na
    a, b = _merge_runs(np.random.default_rng(na + 3 * nb), na, nb, kind)
    if kind == "split":
        nb = len(b[0])
    args = tuple(u32_tensor(c, cuda) for c in (*a, *b))
    n0 = K.merge_dedup.launches
    got = K.merge_dedup(*args, _items=items)
    assert K.merge_dedup.launches == n0 + 1
    _equal(got, K.merge_dedup_ref(*args))
    keys = got[0].cpu().numpy().view(np.uint32)
    assert (np.diff(keys.astype(np.int64)) >= 0).all()
    assert int(got[3].sum()) == len(np.union1d(a[0], b[0]))
