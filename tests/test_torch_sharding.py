"""The port's fleet (``repro_torch.core.sharding``) against the reference's
live output, on the CPU.

* A seeded mixed put/delete/get/scan stream runs through both packages'
  ``ShardedStore`` (3 shards; ``scavenger``, ``titan`` and
  ``scavenger_adaptive``; ``hash`` and ``range`` routing; the ``fleet`` and
  ``round_robin`` schedulers), the port's shards on ``device="cpu"`` with
  kernels on (their plain torch versions).  Every ``stats()`` field must
  agree (ints and strings exactly, floats within ``rel=1e-9`` of the
  reference's live output), and so must every ``multi_get`` vid, every
  scan row, the router's ``state_dict()`` and the scheduler's.
* An elastic run: a static hotspot on a 2-shard range fleet with
  ``replica_count=1`` and auto-split, driven by each package's own
  ``Runner`` and ``HotspotKeys``.  The migration lists (kind, bounds,
  records, bytes, ``fence_us``) agree in order, and after ``fail_primary``
  the promoted shard's ``stats()`` too.
* A durable fleet directory written by either package opens with the
  other's ``ShardedStore.open`` to the same ``stats()`` and reads.
* Every ``Store`` a CPU fleet makes — shards, replicas, split
  destinations, the promoted replica, recovered shards and their re-seeded
  replicas — is on the CPU.
"""

from __future__ import annotations

import math
import shutil

import numpy as np
import pytest
import torch

import repro.core as R
import repro.workloads as RW
import repro_torch.core as T
import repro_torch.workloads as TW
from repro_torch.workloads.elastic import TINY_FLEET, hot_seed

N_KEYS = 4096
VSIZES = np.array([64, 600, 2000, 9000], np.int64)


def _cfgs(engine, **kw):
    """The same configuration for both packages: the port's from the
    reference's ``state_dict()``."""
    ref = R.EngineConfig(engine=engine, **TINY_FLEET, **kw)
    return ref, T.EngineConfig.from_state_dict(ref.state_dict())


def _fleet(pkg, cfg, **kw):
    if pkg is T:
        kw.setdefault("device", "cpu")
    return pkg.ShardedStore(cfg, **kw)


def assert_stats_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for f, w in want.items():
        g = got[f]
        if isinstance(w, float):
            assert math.isclose(g, w, rel_tol=1e-9, abs_tol=1e-12), \
                f"{f}: {g} != {w}"
        elif isinstance(w, list):
            assert len(g) == len(w), f
            for a, b in zip(g, w):
                assert math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-12), \
                    f"{f}: {g} != {w}"
        else:
            assert type(g) is type(w) and g == w, f"{f}: {g!r} != {w!r}"


def mixed_stream(pkg, fleet, seed=5, rounds=8):
    """Seeded puts, deletes, point reads and scans, then a flush and a
    drain -> (multi_get vids, scan rows)."""
    rng = np.random.default_rng(seed)
    vids, rows = [], []
    for _ in range(rounds):
        keys = rng.integers(0, N_KEYS, 256).astype(np.uint64)
        sizes = VSIZES[rng.integers(0, len(VSIZES), 256)]
        vids.append(fleet.write(pkg.WriteBatch().puts(keys, sizes)).tolist())
        fleet.write(pkg.WriteBatch().deletes(
            rng.integers(0, N_KEYS, 16).astype(np.uint64)))
        res = fleet.multi_get(rng.integers(0, N_KEYS, 128).astype(np.uint64))
        vids.append(res["vid"].tolist())
        vids.append(res["found"].tolist())
        starts = rng.integers(0, N_KEYS, 8).astype(np.int64)
        rows.append(fleet.multi_scan(starts, rng.integers(1, 60, 8)))
    fleet.flush()
    fleet.drain()
    res = fleet.multi_get(np.arange(N_KEYS, dtype=np.uint64))
    vids.append(res["vid"].tolist())
    rows.append(fleet.multi_scan(np.array([0, 1000, 4000], np.int64), 200))
    return vids, rows


@pytest.mark.parametrize("scheduler", ["fleet", "round_robin"])
@pytest.mark.parametrize("policy", ["hash", "range"])
@pytest.mark.parametrize("engine", ["scavenger", "titan",
                                    "scavenger_adaptive"])
def test_fleet_matches_reference(engine, policy, scheduler):
    rcfg, tcfg = _cfgs(engine)
    kw = dict(n_shards=3, shard_policy=policy, key_space=N_KEYS,
              scheduler=scheduler)
    ref, port = _fleet(R, rcfg, **kw), _fleet(T, tcfg, **kw)
    want, got = mixed_stream(R, ref), mixed_stream(T, port)
    assert got[0] == want[0]
    assert got[1] == want[1]
    ws = ref.stats()
    assert ws["n_gc_runs"] > 0 and ws["n_compactions"] > 0
    assert_stats_equal(port.stats(), ws)
    assert port.router.state_dict() == ref.router.state_dict()
    assert port.fleet.state_dict() == ref.fleet.state_dict()
    for ps, rs in zip(port.shards, ref.shards):
        assert_stats_equal(ps.stats(), rs.stats())


def elastic_run(pkg, wl, engine):
    """A hotspot on a 2-shard range fleet, auto-split, one replica a shard,
    through the package's own ``Runner``; then ``fail_primary`` on the
    shard with the largest space share -> (fleet, runner, promoted)."""
    spec = wl.pareto_1k(2 << 20, update_factor=1.0)
    ref_cfg = R.EngineConfig.scaled(
        engine, spec.dataset_bytes // 2, est_keys=spec.n_keys // 2,
        elastic_split_frac=0.55, elastic_cooldown_ops=512,
        elastic_max_shards=4, migration_chunk_records=256,
        replica_count=1, replica_lag_ops=4)
    cfg = ref_cfg if pkg is R else \
        T.EngineConfig.from_state_dict(ref_cfg.state_dict())
    fleet = _fleet(pkg, cfg, n_shards=2, shard_policy="range",
                   key_space=spec.n_keys)
    hot = wl.HotspotKeys(spec.n_keys, hot_n=spec.n_keys // 8, hot_frac=0.9,
                         shift_every=1 << 30,
                         seed=hot_seed(spec.n_keys))
    runner = wl.Runner(fleet, spec, batch=512, key_gen=hot)
    runner.load()
    runner.update()
    space = [s.version.total_bytes() for s in fleet.shards]
    promoted = fleet.fail_primary(int(np.argmax(space)))
    return fleet, runner, promoted


@pytest.mark.parametrize("engine", ["scavenger", "titan"])
def test_elastic_fleet_matches_reference(engine):
    ref, rr, rprom = elastic_run(R, RW, engine)
    port, pr, pprom = elastic_run(T, TW, engine)
    assert len(ref.migrations) >= 1 and len(ref.shards) > 2
    assert len(port.migrations) == len(ref.migrations)
    for pm, rm in zip(port.migrations, ref.migrations):
        assert set(pm) == set(rm)
        for f in ("kind", "src", "dst", "lo", "hi", "records", "bytes",
                  "epoch"):
            assert pm[f] == rm[f], f
        assert math.isclose(pm["fence_us"], rm["fence_us"], rel_tol=1e-9,
                            abs_tol=1e-12)
    assert pr.oracle == rr.oracle
    assert_stats_equal(pprom.stats(), rprom.stats())
    assert_stats_equal(port.stats(), ref.stats())
    assert port.router.state_dict() == ref.router.state_dict()
    keys = np.arange(0, rr.spec.n_keys, 7, dtype=np.uint64)
    assert pr.check_reads(keys) == 0
    assert port.multi_get(keys)["vid"].tolist() == \
        ref.multi_get(keys)["vid"].tolist()


def _durable_ops(pkg, fleet):
    """Writes, deletes and reads around a split and then a checkpoint, so
    the checkpoint holds the split topology."""
    rng = np.random.default_rng(9)
    for i in range(10):
        if i == 6:
            fleet.checkpoint()
        keys = rng.integers(0, N_KEYS, 192).astype(np.uint64)
        fleet.write(pkg.WriteBatch().puts(
            keys, VSIZES[rng.integers(0, len(VSIZES), 192)]))
        fleet.write(pkg.WriteBatch().deletes(
            rng.integers(0, N_KEYS, 16).astype(np.uint64)))
        fleet.multi_get(rng.integers(0, N_KEYS, 64).astype(np.uint64))
        if i == 4:
            assert fleet.split_shard(0) is not None


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_fleet_directory_crosses_packages(tmp_path, writer):
    """A durable fleet (a checkpoint, a split after it, replicas) written
    by one package recovers in the other to the same state."""
    rcfg, tcfg = _cfgs("scavenger", replica_count=1)
    src, dst = (R, T) if writer == "reference" else (T, R)
    cfg = rcfg if src is R else tcfg
    fleet = _fleet(src, cfg, n_shards=2, key_space=N_KEYS,
                   durability_dir=tmp_path / "fleet")
    _durable_ops(src, fleet)
    fleet.close()
    # each recovery appends to the directory: open two copies
    shutil.copytree(tmp_path / "fleet", tmp_path / "copy")
    other = dst.ShardedStore.open(tmp_path / "fleet",
                                  **({"device": "cpu"} if dst is T else {}))
    same = src.ShardedStore.open(tmp_path / "copy",
                                 **({"device": "cpu"} if src is T else {}))
    assert len(other.shards) == len(same.shards) == 3
    assert_stats_equal(other.stats(), same.stats())
    assert other.router.state_dict() == same.router.state_dict()
    keys = np.arange(N_KEYS, dtype=np.uint64)
    assert other.multi_get(keys)["vid"].tolist() == \
        same.multi_get(keys)["vid"].tolist()


@pytest.mark.parametrize("engine", ["scavenger", "scavenger_adaptive"])
def test_every_store_of_the_fleet_is_on_its_device(tmp_path, monkeypatch,
                                                   engine):
    """With ``device="cpu"`` every Store the fleet makes is on the CPU.  The
    check claims a card is present, so a path that dropped the device
    would build a CUDA store here rather than raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    _, cfg = _cfgs(engine, replica_count=1)
    fleet = T.ShardedStore(cfg, n_shards=2, key_space=N_KEYS,
                           durability_dir=tmp_path / "fleet", device="cpu")

    def on_cpu(stores):
        for s in stores:
            assert s.device.type == "cpu"
            tracker = getattr(s.strategy, "tracker", None)
            if tracker is not None:
                assert tracker.writes.device.type == "cpu"
        return len(stores)

    def replicas(f):
        return [r for rep in f.replicators.values() for r in rep.replicas]

    assert fleet.device.type == "cpu"
    assert on_cpu(fleet.shards) == 2 and on_cpu(replicas(fleet)) == 2
    _durable_ops(T, fleet)                       # checkpoint, then a split
    assert on_cpu(fleet.shards) == 3 and on_cpu(replicas(fleet)) == 3
    promoted = fleet.fail_primary(2)
    assert on_cpu([promoted]) == 1
    fleet.close()
    rec = T.ShardedStore.open(tmp_path / "fleet", device="cpu")
    assert rec.device.type == "cpu"
    assert on_cpu(rec.shards) == 3 and on_cpu(replicas(rec)) == 3
    assert on_cpu([rec.fail_primary(0)]) == 1
