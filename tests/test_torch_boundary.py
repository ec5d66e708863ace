"""Boundaries of the PyTorch port (``src/repro_torch``, ``chip_smoke.py``).

* The port imports neither JAX nor anything of the reference package:
  checked on the source (AST) and on a live import in a fresh interpreter.
* ``Store`` runs on CUDA unless told otherwise, and raises without it.
* A kernel wrapper given CUDA tensors launches its kernel or raises; it
  never runs the plain version.  No card here, so the tensors only report
  a CUDA device and the launch is mocked.
* The not-yet-ported surfaces (recording observers) raise; the ported
  seventh engine and durability do not.
* A reference ``EngineConfig.state_dict()`` carries over unchanged.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro_torch.kernels.lookup_probe import ops as probe_ops
from repro_torch.kernels.run_coalesce import ops as coalesce_ops
from repro_torch.kernels.segment_reduce import ops as segment_ops

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_no_jax_or_reference(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_port_import_and_run_load_no_jax_or_reference():
    """Import every port module and chip_smoke, drive a small durable
    adaptive store with kernels on through a checkpoint and a recovery,
    and list the modules a fresh interpreter then holds."""
    code = r"""
import importlib, json, pkgutil, sys, tempfile
import numpy as np
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
from repro_torch.core import EngineConfig, Store, WriteBatch
keys = np.arange(2000, dtype=np.uint64) * np.uint64(1 << 33)
with tempfile.TemporaryDirectory() as d:
    s = Store(EngineConfig.scaled("scavenger_adaptive", 1 << 20,
                                  kernel_min_batch=1),
              durability_dir=d, device="cpu")
    s.write(WriteBatch().puts(keys, np.full(2000, 1024, np.int64)))
    s.checkpoint()
    s.multi_get(keys)
    s.multi_scan(np.array([0], np.int64), 5)
    s.close()
    r = Store.open(d, device="cpu")
    r.multi_get(keys)
    r.close()
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
"""
    env = {"PYTHONPATH": f"{REPO / 'src'}:{REPO}", "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


# ------------------------------------------------------------- the device
def test_store_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = T.EngineConfig.scaled("scavenger", 1 << 20)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.Store(cfg)
    assert T.Store(cfg, device="cpu").device == torch.device("cpu")


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device (no card here); results of
    ops on it keep the subclass, so they report CUDA too."""

    @property
    def device(self):
        return torch.device("cuda")


def _cuda_looking(a) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a, np.int64))
    return torch.Tensor._make_subclass(_CudaLooking, t)


@pytest.fixture
def mocked_library(monkeypatch):
    """Record launches in place of the library; make the plain versions
    and CUDA allocation unreachable."""
    launched = []

    def launch(name, device, *args):
        assert device.type == "cuda"
        launched.append(name)

    def cpu_outputs(n, device, *dtypes):
        assert device.type == "cuda"
        return tuple(torch.zeros(n, dtype=d) for d in dtypes)

    def plain(*a, **k):
        raise AssertionError("a CUDA operand reached the plain version")

    for mod in (probe_ops, coalesce_ops, segment_ops):
        monkeypatch.setattr(mod, "launch", launch)
        monkeypatch.setattr(mod, "outputs", cpu_outputs)
    monkeypatch.setattr(coalesce_ops, "smem_sort_cap", lambda: 8192)
    for name in ("rank_probe_ref", "lookup_probe_ref", "count_le_ref",
                 "interval_rank_ref"):
        monkeypatch.setattr(probe_ops, name, plain)
    monkeypatch.setattr(coalesce_ops, "run_coalesce_ref", plain)
    for name in ("segment_sum_ref", "gather_min64_ref"):
        monkeypatch.setattr(segment_ops, name, plain)
    for fn in (probe_ops.rank_probe, probe_ops.lookup_probe,
               probe_ops.count_le, coalesce_ops.run_coalesce,
               segment_ops.segment_sum, segment_ops.gather_min64):
        monkeypatch.setattr(fn, "launches", 0)
    return launched


@pytest.mark.parametrize("kernel", ["rank_probe", "lookup_probe",
                                    "count_le", "run_coalesce",
                                    "segment_sum", "gather_min64"])
def test_cuda_operands_launch_the_kernel(mocked_library, kernel):
    q = _cuda_looking([3, 1, 2])
    run = _cuda_looking([1, 2, 5, 9])
    args = {"rank_probe": (q, run), "count_le": (q, run),
            "lookup_probe": (q, run, _cuda_looking(np.zeros((3, 7))), run),
            "run_coalesce": (q, q), "segment_sum": (q, 8),
            "gather_min64": (_cuda_looking(np.zeros((2, 5))),
                             _cuda_looking(np.zeros((3, 2))))}[kernel]
    mod = {"run_coalesce": coalesce_ops, "segment_sum": segment_ops,
           "gather_min64": segment_ops}.get(kernel, probe_ops)
    fn = getattr(mod, kernel)
    fn(*args)
    assert mocked_library == [kernel]
    assert fn.launches == 1


def test_interval_rank_on_cuda_launches_count_le(mocked_library):
    q = _cuda_looking([3, 1, 2])
    run = _cuda_looking([1, 2, 5, 9])
    probe_ops.interval_rank(q, run, run)
    assert mocked_library == ["count_le"]


def test_failed_launch_raises_and_never_falls_back(mocked_library,
                                                   monkeypatch):
    def refused(name, device, *args):
        raise RuntimeError(f"CUDA kernel {name} failed")
    monkeypatch.setattr(probe_ops, "launch", refused)
    with pytest.raises(RuntimeError, match="rank_probe failed"):
        probe_ops.rank_probe(_cuda_looking([1]), _cuda_looking([1]))
    assert probe_ops.rank_probe.launches == 0


def test_kernels_build_nothing_at_import():
    from repro_torch.kernels import common
    assert common.library.cache_info().currsize == 0


# --------------------------------------- engines, durability, observers
def test_all_seven_engines_registered():
    """The registry runs all seven reference engines, in the reference's
    order; an unknown name still raises."""
    assert T.available_engines() == T.ENGINES == R.ENGINES
    assert T.EngineConfig(engine="scavenger_adaptive").adaptive_enabled
    with pytest.raises(ValueError, match="unknown engine"):
        T.EngineConfig(engine="no_such_engine")


def test_durability_works_and_recording_observers_raise(tmp_path):
    """Durability is ported; recording observers still raise, on both the
    constructor and the recovery path."""
    cfg = T.EngineConfig.scaled("scavenger", 1 << 20)
    store = T.Store(cfg, durability_dir=tmp_path / "d", device="cpu")
    store.write(T.WriteBatch().puts(np.arange(4, dtype=np.uint64),
                                    np.full(4, 1024, np.int64)))
    store.checkpoint(tmp_path / "snap")
    store.close()
    assert T.Store.open(tmp_path / "snap", device="cpu").stats() \
        == store.stats()
    with pytest.raises(ValueError, match="unknown crash point"):
        store.arm_crash("nonsense")
    with pytest.raises(NotImplementedError, match="observer"):
        T.Store(T.EngineConfig.scaled("scavenger", 1 << 20,
                                      observer=object()), device="cpu")
    with pytest.raises(NotImplementedError, match="observer"):
        T.Store.open(tmp_path / "d", observer=object(), device="cpu")


def test_open_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = T.EngineConfig.scaled("scavenger_adaptive", 1 << 20)
    T.Store(cfg, durability_dir=tmp_path, device="cpu").close()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.Store.open(tmp_path)
    store = T.Store.open(tmp_path, device="cpu")
    assert store.device == torch.device("cpu")
    assert store.strategy.tracker.writes.device == torch.device("cpu")


# -------------------------------------------------- configuration carry
@pytest.mark.parametrize("engine", T.ENGINES)
@pytest.mark.parametrize("overrides", [
    {}, {"use_kernels": False, "kernel_interpret": True},
    {"coalesce_window": 3, "kernel_min_batch": 7, "gc_batch_files": 2,
     "space_quota_bytes": 123456}])
def test_config_from_reference_state_dict(engine, overrides):
    ref = R.EngineConfig.scaled(engine, 8 << 20, est_keys=4096, **overrides)
    port = T.EngineConfig.from_state_dict(ref.state_dict())
    assert port.state_dict() == ref.state_dict()
    assert port.kv_separated == ref.kv_separated
    assert port == T.EngineConfig.scaled(engine, 8 << 20, est_keys=4096,
                                         **overrides)


def test_config_from_state_dict_rejects_unknown_fields():
    d = T.EngineConfig().state_dict()
    d["no_such_knob"] = 1
    with pytest.raises(TypeError):
        T.EngineConfig.from_state_dict(d)


# ------------------------------------------------------- device columns
def test_device_cache_uploads_once_and_drops_with_the_host_array():
    import gc
    from repro_torch.kernels.common import DeviceCache
    cache = DeviceCache(torch.device("cpu"))
    a = np.array([1, 2**63, 2**64 - 1], np.uint64)
    t = cache.get(a)
    assert cache.get(a) is t                     # one copy per host array
    assert t.dtype == torch.int64
    assert (t.numpy().view(np.uint64) == a).all()   # same u64 bits
    assert t.data_ptr() != a.ctypes.data         # a copy, not a view
    assert len(cache._cache) == 1
    del a
    gc.collect()
    assert len(cache._cache) == 0                # dropped with the array


def test_kernel_outputs_come_back_with_one_synchronisation(monkeypatch):
    from repro_torch.kernels import common
    calls = []
    monkeypatch.setattr(common, "launch",
                        lambda name, device, *a: calls.append(name))
    may = _cuda_looking([1, 0, 1])
    rank = _cuda_looking([-1, 2**40, 2**62])
    got = common.to_host(may.bool(), rank)
    assert calls == ["scav_stream_sync"]          # one wait for all copies
    np.testing.assert_array_equal(got[0], [True, False, True])
    np.testing.assert_array_equal(got[1], [-1, 2**40, 2**62])
    calls.clear()
    common.to_host(torch.tensor([1, 2]))          # CPU: no device wait
    assert calls == []


def test_fetch_planning_checks_its_range_on_the_host():
    from repro_torch.core import accel
    store = T.Store(T.EngineConfig.scaled("scavenger", 1 << 20,
                                          kernel_min_batch=1), device="cpu")
    ok = np.array([0, 0, 1], np.int64)
    assert accel.plan_runs(store, ok, np.array([3, 3, 2**32 - 2])) is not None
    for ranks, pos in (([0, 1, 2**32 - 1], [0, 0, 0]), ([0, -1, 1], [0] * 3),
                       ([0, 0, 1], [0, 2**32 - 1, 0])):
        with pytest.raises(ValueError, match="2\\^32"):
            accel.plan_runs(store, np.array(ranks, np.int64),
                            np.array(pos, np.int64))
