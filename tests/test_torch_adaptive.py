"""The port's adaptive subsystem against the reference's, on the CPU.

``DecaySketch``, ``LifetimeEstimator``, ``AccessTracker`` and
``TemperatureMap`` (``repro_torch.core.adaptive``) take the same
NumPy-seeded streams as ``repro.core.adaptive``, with kernel routing off
and on (the port's kernels run their plain torch versions on
``device="cpu"``, the reference's in ``xla`` mode).  Sketch counts,
lifetime histograms and estimates must be bit-identical: the float64
arrays are compared through their int64 views.  A ``scavenger_adaptive``
``Store`` is held against the reference's live run on the fixed parity
workload and on a Zipf(0.99) update stream, tracker on and off, kernels on
and off: every ``stats()`` field (ints exactly, floats within rel 1e-9 as
in ``tests/test_torch_store_parity.py``), every ``multi_get`` vid, every
scan row, and the tracker's arrays bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
from numpy.testing import assert_array_equal

from _hypothesis_support import HealthCheck, given, settings, st
from test_torch_store_parity import assert_same, replay

import repro.core as R
import repro.core.accel as racc
import repro.core.adaptive as RA
import repro_torch.core as T
import repro_torch.core.accel as tacc
import repro_torch.core.adaptive as TA
from repro.workloads import ZipfKeys

CPU = "cpu"


def bits(a: np.ndarray) -> np.ndarray:
    """int64 view of a float64 array: equal views = bit-identical."""
    return np.ascontiguousarray(a).view(np.int64)


def policies(routed: bool):
    """(reference, port) kernel policies: routing every batch, or none."""
    if routed:
        return racc.KernelPolicy(True, 1), tacc.KernelPolicy(True, 1)
    return None, None


# ================================================================= sketch
@pytest.mark.parametrize("routed", [False, True])
@pytest.mark.parametrize("width,depth,half_life", [
    (1, 1, None), (64, 2, 100.0), (4096, 2, 5000.0), (97, 4, None),
    (300, 3, 1e9)])
def test_sketch_matches_reference(width, depth, half_life, routed):
    rp, tp = policies(routed)
    ref = RA.DecaySketch(width, depth, half_life, seed=11, policy=rp)
    port = TA.DecaySketch(width, depth, half_life, seed=11, policy=tp,
                          device=CPU)
    rng = np.random.default_rng(width + depth)
    clock = 0.0
    for step in range(12):
        keys = rng.integers(0, 5000, rng.integers(0, 700)).astype(np.uint64)
        clock += float(rng.integers(1, 400))
        for sk in (ref, port):
            sk.decay_to(clock)
            sk.add(keys)
        if step % 4 == 3:                 # weighted adds take the host path
            w = rng.random(len(keys)) * 3
            ref.add(keys, w)
            port.add(keys, w)
        assert_array_equal(bits(port.counts), bits(ref.counts))
        q = np.concatenate([keys[:50], rng.integers(
            0, 10_000, 200).astype(np.uint64)])
        assert_array_equal(bits(port.estimate(q)), bits(ref.estimate(q)))
    assert port.total_mass() == ref.total_mass()
    assert port.active_slots() == ref.active_slots()


def test_sketch_routed_equals_host_path():
    """Kernel-on and kernel-off port sketches are bit-identical."""
    host = TA.DecaySketch(512, 2, 300.0, seed=3)
    routed = TA.DecaySketch(512, 2, 300.0, seed=3,
                            policy=tacc.KernelPolicy(True, 1), device=CPU)
    rng = np.random.default_rng(5)
    for i in range(10):
        keys = rng.integers(0, 3000, 900).astype(np.uint64)
        for sk in (host, routed):
            sk.decay_to(float(i * 250))
            sk.add(keys)
        assert_array_equal(bits(routed.counts), bits(host.counts))
        assert_array_equal(bits(routed.estimate(keys)),
                           bits(host.estimate(keys)))


keys_strategy = st.lists(st.integers(min_value=0, max_value=1 << 20),
                         min_size=1, max_size=300)


@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(keys=keys_strategy, width=st.integers(16, 256),
       depth=st.integers(1, 4), routed=st.booleans())
def test_sketch_never_undercounts(keys, width, depth, routed):
    """Without decay, estimate(k) >= exact count for every key."""
    sk = TA.DecaySketch(width, depth, None, policy=policies(routed)[1],
                        device=CPU)
    sk.add(np.array(keys, np.uint64))
    uniq, exact = np.unique(np.array(keys, np.uint64), return_counts=True)
    assert np.all(sk.estimate(uniq) >= exact)


@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(keys=keys_strategy, half_life=st.floats(1.0, 1e6),
       steps=st.lists(st.floats(0.0, 1e5), min_size=1, max_size=8))
def test_sketch_decay_is_monotone(keys, half_life, steps):
    """Advancing the clock without adds can only lower every estimate."""
    sk = TA.DecaySketch(64, 2, half_life, policy=policies(True)[1],
                        device=CPU)
    ks = np.array(keys, np.uint64)
    sk.add(ks)
    clock, prev = 0.0, sk.estimate(ks)
    for d in steps:
        clock += d
        sk.decay_to(clock)
        cur = sk.estimate(ks)
        assert np.all(cur <= prev) and np.all(cur >= 0)
        prev = cur


def test_sketch_rejects_bad_shape():
    for w, d in ((0, 1), (16, 0)):
        with pytest.raises(ValueError):
            TA.DecaySketch(w, d)


# =============================================================== lifetime
@pytest.mark.parametrize("routed", [False, True])
@pytest.mark.parametrize("n_groups,half_life", [(1, None), (64, 500.0),
                                                (1024, 8192.0)])
def test_lifetime_matches_reference(n_groups, half_life, routed):
    rp, tp = policies(routed)
    ref = RA.LifetimeEstimator(n_groups, half_life, 0.1, policy=rp)
    port = TA.LifetimeEstimator(n_groups, half_life, 0.1, policy=tp,
                                device=CPU)
    rng = np.random.default_rng(n_groups)
    now = 0.0
    for _ in range(25):
        g = rng.integers(0, n_groups, rng.integers(0, 400))
        now += float(rng.integers(1, 3000))
        ref.observe(g, now)
        port.observe(g, now)
        assert_array_equal(bits(port.hist), bits(ref.hist))
        assert_array_equal(bits(port.last_write), bits(ref.last_write))
    q = np.arange(n_groups)
    for t in (now, now + 5000.0):
        assert_array_equal(bits(port.residual(q, t)),
                           bits(ref.residual(q, t)))
    assert_array_equal(bits(port.mean_interval(q)),
                       bits(ref.mean_interval(q)))


def test_lifetime_residual_grows_once_overdue():
    est = TA.LifetimeEstimator(16, None, policy=policies(True)[1],
                               device=CPU)
    g = np.array([3], np.int64)
    now = 0.0
    for _ in range(32):
        now += 10
        est.observe(g, now)
    assert est.residual(g, now + 1000)[0] > 10 * est.residual(g, now)[0]
    assert est.residual(np.array([9], np.int64), now)[0] == np.inf


# ========================================================= tracker + temps
def _tracker_stream(seed: int):
    rng = np.random.default_rng(seed)
    zipf = ZipfKeys(20_000, 0.99, seed)
    for i in range(30):
        keys = zipf.sample(rng, int(rng.integers(1, 1500))).astype(np.uint64)
        yield ("w" if i % 3 else "r"), keys


@pytest.mark.parametrize("use_kernels", [False, True])
def test_tracker_and_temperature_match_reference(use_kernels):
    kw = dict(adaptive_half_life_ops=20_000.0, kernel_min_batch=64,
              use_kernels=use_kernels)
    rcfg = R.EngineConfig(engine="scavenger_adaptive", **kw)
    tcfg = T.EngineConfig(engine="scavenger_adaptive", **kw)
    ref = RA.AccessTracker.from_config(rcfg)
    port = TA.AccessTracker.from_config(tcfg, CPU)
    rtm = RA.TemperatureMap(ref, rcfg.temp_hot_mult, rcfg.temp_cold_mult)
    ttm = TA.TemperatureMap(port, tcfg.temp_hot_mult, tcfg.temp_cold_mult)
    for kind, keys in _tracker_stream(9):
        for tr in (ref, port):
            (tr.observe_writes if kind == "w" else tr.observe_reads)(keys)
        assert port.ops == ref.ops
        for a, b in ((port.writes.counts, ref.writes.counts),
                     (port.reads.counts, ref.reads.counts),
                     (port.lifetime.hist, ref.lifetime.hist)):
            assert_array_equal(bits(a), bits(b))
        assert_array_equal(bits(port.write_rate(keys)),
                           bits(ref.write_rate(keys)))
        assert_array_equal(bits(port.read_rate(keys)),
                           bits(ref.read_rate(keys)))
        assert_array_equal(bits(port.residual_lifetime(keys)),
                           bits(ref.residual_lifetime(keys)))
        assert_array_equal(ttm.classify(keys), rtm.classify(keys))
    assert port.mean_write_rate() == ref.mean_write_rate()


def test_temperature_classifies_zipf_head_hot_tail_cold():
    cfg = T.EngineConfig(engine="scavenger_adaptive",
                         adaptive_half_life_ops=1e9)
    tr = TA.AccessTracker.from_config(cfg, CPU)
    rng = np.random.default_rng(7)
    tr.observe_writes(rng.integers(0, 8, 4000).astype(np.uint64))
    cold = np.arange(100, 1100, dtype=np.uint64)
    tr.observe_writes(cold)
    tm = TA.TemperatureMap(tr, hot_mult=4.0, cold_mult=0.5)
    assert np.all(tm.classify(np.arange(8, dtype=np.uint64)) == TA.TEMP_HOT)
    assert np.all(tm.classify(cold[:64]) == TA.TEMP_COLD)
    with pytest.raises(ValueError):
        TA.TemperatureMap(tr, hot_mult=1.0, cold_mult=2.0)


def test_tracker_routes_on_the_device_it_is_given():
    """The device travels with the tracker, not with the config's cached
    kernel policy: one config serves a CPU tracker and another device."""
    cfg = T.EngineConfig(engine="scavenger_adaptive")
    tr = TA.AccessTracker.from_config(cfg, CPU)
    assert {tr.writes.device.type, tr.reads.device.type,
            tr.lifetime.device.type} == {"cpu"}
    meta = TA.AccessTracker.from_config(cfg, "meta")
    assert meta.writes.device.type == "meta"
    assert tacc.policy_of(cfg) is tacc.policy_of(cfg)
    assert not hasattr(tacc.policy_of(cfg), "device")


# ============================================================ store parity
@pytest.mark.parametrize("use_kernels", [False, True])
def test_tracker_off_matches_reference(use_kernels):
    kw = dict(adaptive_enabled=False, use_kernels=use_kernels)
    got = replay(T, "scavenger_adaptive", device=CPU, **kw)
    assert_same(got, replay(R, "scavenger_adaptive", **kw))


def test_tracker_off_equals_port_scavenger():
    got = replay(T, "scavenger_adaptive", device=CPU, adaptive_enabled=False)
    want = replay(T, "scavenger", device=CPU)
    got[0]["engine"] = want[0]["engine"]
    assert got == want


def _zipf_run(pkg, adaptive: bool, use_kernels: bool, **dev):
    n_keys, batch = 8192, 512
    cfg = pkg.EngineConfig.scaled(
        "scavenger_adaptive", 8 << 20, est_keys=n_keys,
        adaptive_enabled=adaptive, use_kernels=use_kernels)
    store = pkg.Store(cfg, **dev)
    rng = np.random.default_rng(21)
    zipf = ZipfKeys(n_keys, 0.99, 21)
    load = rng.permutation(n_keys).astype(np.uint64)
    for i in range(0, n_keys, batch):
        store.write(pkg.WriteBatch().puts(load[i:i + batch],
                                          np.full(batch, 1024)))
    vids, rows = [], []
    for i in range(16):
        keys = zipf.sample(rng, batch).astype(np.uint64)
        store.write(pkg.WriteBatch().puts(keys, np.full(batch, 1024)))
        if i % 4 == 3:
            vids.append(store.multi_get(
                zipf.sample(rng, 256).astype(np.uint64))["vid"].tolist())
            rows.append(store.multi_scan(
                rng.integers(0, n_keys, 4).astype(np.int64), 8))
    store.drain()
    vids.append(store.multi_get(np.arange(n_keys, dtype=np.uint64))
                ["vid"].tolist())
    return (store.stats(), vids, rows), store


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("adaptive", [True, False])
def test_zipf_update_stream_matches_reference(adaptive, use_kernels):
    got, ts = _zipf_run(T, adaptive, use_kernels, device=CPU)
    want, rs = _zipf_run(R, adaptive, use_kernels)
    assert_same(got, want)
    assert got[0]["n_gc_runs"] > 0
    if adaptive:
        tt, rt = ts.strategy.tracker, rs.strategy.tracker
        for a, b in ((tt.writes.counts, rt.writes.counts),
                     (tt.reads.counts, rt.reads.counts),
                     (tt.lifetime.hist, rt.lifetime.hist),
                     (tt.lifetime.last_write, rt.lifetime.last_write)):
            assert_array_equal(bits(a), bits(b))
        # file ids come from a process-wide counter in each package:
        # compare the score cache in insertion order, not by id
        assert list(ts.strategy._soon_cache.values()) \
            == list(rs.strategy._soon_cache.values())
        temps = [t.temperature for t in ts.version.value_files.values()]
        assert temps == [t.temperature
                         for t in rs.version.value_files.values()]


def test_adaptive_kernels_reached_on_the_store_path(monkeypatch):
    """With routing on, the adaptive store calls both segment-reduce ops
    (their plain versions, on the CPU)."""
    from repro_torch import kernels
    calls = {}
    for name in ("segment_sum", "gather_min64"):
        def spy(*a, _f=getattr(kernels, name), _n=name, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a, **k)
        monkeypatch.setattr(kernels, name, spy)
    replay(T, "scavenger_adaptive", device=CPU, kernel_min_batch=1)
    assert set(calls) == {"segment_sum", "gather_min64"}
