"""Three places where the port once ran differently from the reference, on
the CPU.

* A strategy written as the reference writes its own,
  ``__init__(self, cfg)``, registers and runs in the port, and the store's
  device still reaches the adaptive tracker built inside such a
  constructor.
* A store that crashes at any of the five store crash points leaves the
  same ``stats()`` as the reference's crashed store (``mid_flush`` fires
  after the kSST's flush write is charged), with kernels off and on.
* When the WAL log call of ``multi_get`` or ``multi_scan`` raises, the
  user-op count is the reference's (it counts only after the log call).

Ints are compared exactly, floats at ``rel=1e-9`` against the reference's
live output.
"""

from __future__ import annotations

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.core.engines import registry as ref_registry
from repro_torch.core.engines import registry as port_registry

N_KEYS = 4096
VSIZES = np.array([64, 200, 600, 2000, 9000], np.int64)
STORE_POINTS = ("after_wal", "mid_flush", "mid_compaction", "gc_pre_chain",
                "gc_post_chain")


def _store(pkg, cfg, **kw):
    return pkg.Store(cfg, device="cpu", **kw) if pkg is T \
        else pkg.Store(cfg, **kw)


def _assert_stats_match(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, float):
            assert got[k] == pytest.approx(w, rel=1e-9), k
        else:
            assert got[k] == w, k


def _puts(pkg, store, n_batches: int = 16, crash=None) -> int | None:
    """``n_batches`` batches of 160 seeded puts, with ``crash`` armed
    (hits=2) before the first.  -> the batch the crash fired in, or None."""
    if crash is not None:
        store.arm_crash(crash, hits=2)
    rng = np.random.default_rng(0)
    for i in range(n_batches):
        keys = rng.integers(0, N_KEYS, 160).astype(np.uint64)
        sizes = VSIZES[rng.integers(0, len(VSIZES), 160)]
        try:
            store.write(pkg.WriteBatch().puts(keys, sizes))
        except pkg.CrashPoint:
            return i
    return None


# ================================================================== F1
def _cfg_only_engines(pkg, registry):
    """Two strategies with the reference's one-argument constructor: a
    plain one and a ``scavenger_adaptive`` subclass (its tracker is built
    inside the constructor)."""

    class CfgOnlyEngine(pkg.EngineStrategy):
        name = "cfg-only-init-test"

        def __init__(self, cfg):
            super().__init__(cfg)
            self.n_observed = 0

        def observe_batch(self, store, kind, keys, vsizes=None):
            self.n_observed += 1

    adaptive = registry.get_strategy_class("scavenger_adaptive")

    class CfgOnlyAdaptive(adaptive):
        name = "cfg-only-adaptive-test"

        def __init__(self, cfg):
            super().__init__(cfg)
            self.built = True

    return pkg.register_engine(CfgOnlyEngine), \
        pkg.register_engine(CfgOnlyAdaptive)


@pytest.fixture
def cfg_only_engines():
    names = [c.name for c in _cfg_only_engines(R, ref_registry)]
    _cfg_only_engines(T, port_registry)
    yield names
    for reg in (ref_registry, port_registry):
        for n in names:
            del reg._REGISTRY[n]


@pytest.mark.parametrize("use_kernels", [False, True])
def test_f1_strategy_with_cfg_only_constructor(cfg_only_engines,
                                               use_kernels):
    for name in cfg_only_engines:
        stats = []
        for pkg in (R, T):
            cfg = pkg.EngineConfig.scaled(name, 8 << 20, est_keys=N_KEYS,
                                          use_kernels=use_kernels)
            store = _store(pkg, cfg)
            assert _puts(pkg, store) is None
            store.multi_get(np.arange(N_KEYS, dtype=np.uint64))
            stats.append(store.stats())
            if pkg is T:
                strat = store.strategy
                assert strat.device == store.device
                if hasattr(strat, "n_observed"):
                    assert strat.n_observed == 17
                else:
                    assert strat.built
                    for part in (strat.tracker.writes, strat.tracker.reads,
                                 strat.tracker.lifetime):
                        assert part.device == store.device
        _assert_stats_match(stats[1], stats[0])


# ================================================================== F2
@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("point", STORE_POINTS)
def test_f2_crashed_store_stats_match_reference(point, use_kernels):
    out = []
    for pkg in (R, T):
        cfg = pkg.EngineConfig.scaled("scavenger", 8 << 20, est_keys=N_KEYS,
                                      use_kernels=use_kernels)
        store = _store(pkg, cfg)
        fired = _puts(pkg, store, crash=point)
        assert fired is not None, f"{point} never fired"
        out.append((fired, store.stats()))
    assert out[1][0] == out[0][0]
    _assert_stats_match(out[1][1], out[0][1])


# ================================================================== F3
class _LogFailed(RuntimeError):
    pass


def _failing_log(*args, **kwargs):
    raise _LogFailed("WAL append failed")


@pytest.mark.parametrize("op", ["multi_get", "multi_scan"])
def test_f3_user_ops_counted_after_the_wal_log(op, tmp_path):
    counts = []
    for pkg in (R, T):
        cfg = pkg.EngineConfig.scaled("scavenger", 8 << 20, est_keys=N_KEYS)
        store = _store(pkg, cfg, durability_dir=tmp_path / pkg.__name__)
        _puts(pkg, store, n_batches=2)
        before = store.n_user_ops
        if op == "multi_get":
            store.durability.log_reads = _failing_log
            with pytest.raises(_LogFailed):
                store.multi_get(np.arange(64, dtype=np.uint64))
        else:
            store.durability.log_scans = _failing_log
            with pytest.raises(_LogFailed):
                store.multi_scan(np.arange(4, dtype=np.int64), 8)
        counts.append((before, store.n_user_ops))
    assert counts[1] == counts[0]
    assert counts[0][1] == counts[0][0]     # the reference counts nothing
