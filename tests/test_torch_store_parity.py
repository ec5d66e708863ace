"""The port's Store against the reference's live output, on the CPU.

The fixed mixed op stream of ``tests/test_refactor_parity.py``
(``run_fixed_workload``: seeded writes, deletes, point reads and scans,
then a full drain) runs through both packages for every engine the port
has, with kernels off and on (the port's kernels running their plain torch
versions on ``device="cpu"``).  Integer stats must be equal, float stats
within the reference parity test's ``rel=1e-9`` (the host arithmetic is
the same NumPy in the same order, so they come out equal), and every
``multi_get`` vid and every scan row must be equal.  The floats are held
against the reference's live run, not its ``GOLDENS`` table.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T

INT_FIELDS = ("space_bytes", "valid_bytes", "user_write_bytes",
              "read_bytes", "write_bytes", "n_compactions", "n_gc_runs")
FLOAT_FIELDS = ("space_amp", "s_index", "exposed_over_valid", "write_amp",
                "cache_hit_ratio", "stall_s", "gc_time_s", "clock_s")
N_KEYS = 4096
VSIZES = np.array([64, 200, 600, 2000, 9000], np.int64)


def replay(pkg, engine: str, **kw):
    """``run_fixed_workload``'s op stream -> (stats, vids, scan rows)."""
    store_kw = {"device": kw.pop("device")} if "device" in kw else {}
    cfg = pkg.EngineConfig.scaled(engine, 8 << 20, est_keys=N_KEYS, **kw)
    store = pkg.Store(cfg, **store_kw)
    rng = np.random.default_rng(1234)
    vids, rows = [], []
    for _ in range(6):
        keys = rng.integers(0, N_KEYS, 256).astype(np.uint64)
        sizes = VSIZES[rng.integers(0, len(VSIZES), 256)]
        store.write(pkg.WriteBatch().puts(keys, sizes))
        dels = rng.integers(0, N_KEYS, 16).astype(np.uint64)
        store.write(pkg.WriteBatch().deletes(dels))
        gets = rng.integers(0, N_KEYS, 128).astype(np.uint64)
        res = store.multi_get(gets)
        for k, found, vid in zip(gets.tolist(), res["found"].tolist(),
                                 res["vid"].tolist()):
            cur = store.latest.get(int(k))
            assert (cur is not None) == bool(found)
            if cur is not None:
                assert cur[0] == vid
        vids.append(res["vid"].tolist())
        starts = rng.integers(0, N_KEYS, 8).astype(np.int64)
        rows.append(store.multi_scan(starts, 10))
    store.drain()
    return store.stats(), vids, rows


def assert_same(got, want):
    gs, gv, gr = got
    ws, wv, wr = want
    assert set(gs) == set(ws)
    assert gs["engine"] == ws["engine"]
    for f in INT_FIELDS:
        assert gs[f] == ws[f], f"{f}: {gs[f]} != {ws[f]}"
    for f in FLOAT_FIELDS:
        assert math.isclose(gs[f], ws[f], rel_tol=1e-9, abs_tol=1e-12), \
            f"{f}: {gs[f]} != {ws[f]}"
    assert gv == wv
    assert gr == wr


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("engine", T.ENGINES)
def test_store_matches_reference(engine, use_kernels):
    want = replay(R, engine, use_kernels=use_kernels)
    got = replay(T, engine, device="cpu", use_kernels=use_kernels)
    assert_same(got, want)


@pytest.mark.parametrize("engine", T.ENGINES)
def test_store_matches_reference_forced_routing(engine):
    """kernel_min_batch=1 routes even one-key probes through the ops."""
    want = replay(R, engine, use_kernels=False)
    got = replay(T, engine, device="cpu", kernel_min_batch=1)
    assert_same(got, want)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("window", [1, 3])
@pytest.mark.parametrize("engine", ["titan", "scavenger"])
def test_store_matches_reference_coalesce_window(engine, window,
                                                 use_kernels):
    want = replay(R, engine, use_kernels=use_kernels, coalesce_window=window)
    got = replay(T, engine, device="cpu", use_kernels=use_kernels,
                 coalesce_window=window)
    assert_same(got, want)


def test_kernel_routing_reaches_every_op(monkeypatch):
    """With routing forced, the store's read and fetch paths call all four
    ops (their plain versions, on the CPU)."""
    from repro_torch import kernels
    calls = {}
    for name in ("rank_probe", "lookup_probe", "interval_rank",
                 "run_coalesce"):
        def spy(*a, _f=getattr(kernels, name), _n=name, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a, **k)
        monkeypatch.setattr(kernels, name, spy)
    replay(T, "scavenger", device="cpu", kernel_min_batch=1)
    assert set(calls) == {"rank_probe", "lookup_probe", "interval_rank",
                          "run_coalesce"}


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("engine", T.ENGINES)
def test_store_matches_reference_on_u64_keys(engine, use_kernels):
    """Keys over the whole u64 range (the reference's routing declines
    past its u32 limit and takes the host path; the port's kernels take
    them): writes, deletes and multi_gets, stats and vids equal."""
    def run(pkg, **kw):
        store_kw = {"device": kw.pop("device")} if "device" in kw else {}
        cfg = pkg.EngineConfig.scaled(engine, 8 << 20, est_keys=N_KEYS,
                                      kernel_min_batch=1, **kw)
        store = pkg.Store(cfg, **store_kw)
        rng = np.random.default_rng(77)
        space = rng.integers(0, 2**64 - 1, N_KEYS, dtype=np.uint64,
                             endpoint=True)
        vids = []
        for _ in range(5):
            keys = space[rng.integers(0, N_KEYS, 256)]
            sizes = VSIZES[rng.integers(0, len(VSIZES), 256)]
            store.write(pkg.WriteBatch().puts(keys, sizes))
            store.write(pkg.WriteBatch().deletes(
                space[rng.integers(0, N_KEYS, 16)]))
            res = store.multi_get(space[rng.integers(0, N_KEYS, 192)])
            vids.append(res["vid"].tolist())
        store.drain()
        vids.append(store.multi_get(space)["vid"].tolist())
        return store.stats(), vids, []
    assert_same(run(T, device="cpu", use_kernels=use_kernels),
                run(R, use_kernels=use_kernels))
