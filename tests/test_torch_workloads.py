"""The port's workload generators (``repro_torch.workloads``) against the
reference's ``repro.workloads``, on the CPU.

* Draw for draw, with the same seeds, the key distributions (``ZipfKeys``,
  ``UniformKeys``, ``HotspotKeys`` across hotspot shifts) and the value
  sizes (``Fixed``, ``Mixed``, ``Pareto``) equal the reference's, and so
  do the workload specs' sizes.
* ``Runner``'s load, update, read and scan phases and ``run_ycsb``'s six
  mixes, each package's on its own ``Store`` (the port's on the CPU), give
  the same phase results, oracles and ``stats()``.
* ``repro_torch.workloads.elastic`` holds the reference's elastic fleet
  drivers: ``hot_seed`` gives the elasticity benchmark's seed, and
  ``fleet_rounds``/``oracle_mismatch`` the fleet crash matrix's op stream
  and oracle check, on the port's fleet as the reference's do on its own.
"""

from __future__ import annotations

import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core as R
import repro.workloads as RW
import repro_torch.core as T
import repro_torch.workloads as TW
from repro_torch.workloads import elastic

REPO = Path(__file__).resolve().parent.parent


def _draws(pkg, make, rng_seed=3, sizes=(1, 7, 1000, 4096)):
    gen = make(pkg)
    rng = np.random.default_rng(rng_seed)
    return [gen.sample(rng, m) for m in sizes]


KEY_GENS = {
    "zipf": lambda w: w.ZipfKeys(50_000, theta=0.99, seed=4),
    "zipf_small": lambda w: w.ZipfKeys(100, theta=0.8, seed=0),
    "uniform": lambda w: w.UniformKeys(12_345),
    # shifts every 500 draws: the 5,104 draws cross ten hotspot phases
    "hotspot": lambda w: w.HotspotKeys(10_000, hot_n=64, hot_frac=0.9,
                                       shift_every=500, seed=2),
    "hotspot_default": lambda w: w.HotspotKeys(1 << 20, seed=9),
}
VALUE_DISTS = {
    "fixed": lambda w: w.Fixed(4096),
    "mixed": lambda w: w.Mixed(),
    "mixed_skewed": lambda w: w.Mixed(small_lo=10, small_hi=20, large=999,
                                      large_frac=0.2),
    "pareto": lambda w: w.Pareto(),
    "pareto_8k": lambda w: w.Pareto(mean_size=8192, shape=0.4),
}


@pytest.mark.parametrize("name", sorted(KEY_GENS) + sorted(VALUE_DISTS))
def test_generators_draw_for_draw(name):
    make = KEY_GENS.get(name) or VALUE_DISTS[name]
    got, want = _draws(TW, make), _draws(RW, make)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if name in VALUE_DISTS:
        assert make(TW).mean == make(RW).mean
        assert make(TW).name == make(RW).name


def test_hotspot_shifts_between_phases():
    """The hot set moves at each phase boundary, as the reference's."""
    gen = TW.HotspotKeys(1 << 16, hot_n=16, hot_frac=1.0, shift_every=256,
                         seed=5)
    rng = np.random.default_rng(0)
    ks = gen.sample(rng, 1024).reshape(4, 256)
    starts = [int(np.min(row)) for row in ks]
    assert len(set(starts)) == 4
    ref = RW.HotspotKeys(1 << 16, hot_n=16, hot_frac=1.0, shift_every=256,
                         seed=5).sample(np.random.default_rng(0), 1024)
    np.testing.assert_array_equal(ks.ravel(), ref)


@pytest.mark.parametrize("spec", ["mixed_8k", "pareto_1k", "fixed"])
def test_workload_specs_equal(spec):
    def make(w):
        if spec == "fixed":
            return w.fixed(512, dataset_bytes=3 << 20, update_factor=1.5)
        return getattr(w, spec)(dataset_bytes=5 << 20, seed=3)
    t, r = make(TW), make(RW)
    assert (t.name, t.n_keys, t.n_updates, t.dataset_bytes, t.zipf_theta,
            t.seed) == (r.name, r.n_keys, r.n_updates, r.dataset_bytes,
                        r.zipf_theta, r.seed)


def _store(core, engine):
    cfg = core.EngineConfig.scaled(engine, 2 << 20, est_keys=2048)
    return core.Store(cfg, device="cpu") if core is T else core.Store(cfg)


def _same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, float):
            assert math.isclose(got[k], w, rel_tol=1e-9, abs_tol=1e-12), k
        else:
            assert got[k] == w, k


def _runner_phases(core, w, engine):
    spec = w.pareto_1k(2 << 20, update_factor=1.0, seed=1)
    store = _store(core, engine)
    r = w.Runner(store, spec, batch=256)
    out = [r.load(), r.update(), r.read(2000), r.scan(200, max_len=50)]
    return out, r.oracle, store.stats()


@pytest.mark.parametrize("engine", ["scavenger", "titan"])
def test_runner_phases_match_reference(engine):
    got = _runner_phases(T, TW, engine)
    want = _runner_phases(R, RW, engine)
    for g, w in zip(got[0], want[0]):
        _same(g, w)
    assert got[1] == want[1]
    _same(got[2], want[2])


def _ycsb(core, w, workload):
    spec = w.mixed_8k(2 << 20, seed=2)
    store = _store(core, "scavenger")
    r = w.Runner(store, spec, batch=128)
    r.load()
    r.update(512)
    res = w.run_ycsb(store, spec, workload, 600, runner=r, batch=64)
    return res, r.oracle, store.stats()


@pytest.mark.parametrize("workload", sorted(TW.YCSB_MIX))
def test_ycsb_matches_reference(workload):
    assert TW.YCSB_MIX == RW.YCSB_MIX
    got, want = _ycsb(T, TW, workload), _ycsb(R, RW, workload)
    _same(got[0], want[0])
    assert got[1] == want[1]
    _same(got[2], want[2])


@pytest.mark.parametrize("n_keys", [1000, 4096, 5000, 10_000, 1 << 18])
def test_hot_seed_is_the_elasticity_benchmarks(n_keys):
    sys.path.insert(0, str(REPO))                 # for benchmarks/
    from benchmarks.elasticity import _hot_seed
    assert elastic.hot_seed(n_keys) == _hot_seed(n_keys)


def _reference_fleet_suite():
    """The reference's ``tests/test_elastic_fleet.py`` on the reference
    package, under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        "reference_elastic_fleet", REPO / "tests" / "test_elastic_fleet.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("engine", ["scavenger", "titan"])
def test_fleet_rounds_and_oracle_check_match_the_reference(engine):
    ref = _reference_fleet_suite()
    assert elastic.TINY_FLEET == ref.TINY
    assert elastic.FLEET_KEY_SPACE == ref.KEY_SPACE
    assert elastic.FLEET_VSIZES == ref.VSIZES
    want_fleet = R.ShardedStore(ref._cfg(engine), n_shards=2,
                                key_space=ref.KEY_SPACE)
    got_fleet = T.ShardedStore(
        T.EngineConfig(engine=engine, **elastic.TINY_FLEET), n_shards=2,
        key_space=elastic.FLEET_KEY_SPACE, device="cpu")
    want, got = {}, {}
    ref._workload(want_fleet, want, np.random.default_rng(11), rounds=7)
    elastic.fleet_rounds(got_fleet, got, np.random.default_rng(11), 7)
    assert got == want
    ref._assert_oracle(want_fleet, want)
    assert elastic.oracle_mismatch(got_fleet, got) is None
    keys = np.arange(elastic.FLEET_KEY_SPACE, dtype=np.uint64)
    assert got_fleet.multi_get(keys)["vid"].tolist() == \
        want_fleet.multi_get(keys)["vid"].tolist()


def test_oracle_mismatch_names_each_departure():
    fleet = T.ShardedStore(T.EngineConfig(engine="scavenger",
                                          **elastic.TINY_FLEET),
                           n_shards=2, key_space=elastic.FLEET_KEY_SPACE,
                           device="cpu")
    assert elastic.oracle_mismatch(fleet, {}) == "the oracle is empty"
    oracle: dict = {}
    elastic.fleet_rounds(fleet, oracle, np.random.default_rng(3), 4)
    live = sorted(oracle)
    never = next(k for k in range(elastic.FLEET_KEY_SPACE)
                 if k not in oracle)
    assert elastic.oracle_mismatch(fleet, {**oracle, never: 64}) \
        .startswith("lost keys: [")
    stale = {**oracle, live[0]: oracle[live[0]] + 1}
    assert elastic.oracle_mismatch(fleet, stale).startswith("stale values")
    # every key the fleet holds but the oracle lacks is a resurrection
    assert elastic.oracle_mismatch(fleet, {live[0]: oracle[live[0]]}) == \
        "resurrected deleted or never-written keys"
