"""The reference's store suites, replayed on the port on the CPU.

Six test modules of the reference package (``test_batch_api``,
``test_engine_units``, ``test_engines_registry``, ``test_store_property``,
``test_kernel_route`` and ``test_adaptive``) are loaded afresh from their
files under new module names, with every ``repro.X`` import they make
bound to the same name in ``repro_torch.X``.  The redirect sits in the
fresh module's own ``__import__``, so it covers the imports inside test
bodies too; the reference's modules themselves stay untouched and keep
testing ``repro``.  ``Store`` binds to a subclass of the port's ``Store``
that runs on the CPU (the port's default device is CUDA), and
``AccessTracker`` to one whose trackers route on the CPU.  A sibling test
module a suite imports helpers from (``test_refactor_parity``'s fixed
workload) is loaded the same way, so its helpers drive the port too.  A
module the port does not have yet binds the reference's
(``repro.workloads``, whose ``Runner`` only drives the store under test
through its public calls); a name the port's module lacks binds ``None``.

Each test function is exposed here as ``test_<suite>__<name>`` with its
parametrisation and hypothesis decorators, so each case runs once, against
the port.  Left out, because they need what the port does not have yet:

* ``test_kernel_route.py::test_kernel_us_histograms_reach_observer``:
  the recording observer (``repro.obs.Observer``) is not ported yet
  (ROADMAP §1 item 3).
"""

from __future__ import annotations

import builtins
import importlib
import importlib.util
import types
from pathlib import Path

import repro_torch.core as T
import repro_torch.core.adaptive as TA

SUITES = ("test_batch_api", "test_engine_units", "test_engines_registry",
          "test_store_property", "test_kernel_route", "test_adaptive")
# sibling test modules whose helpers a suite imports
HELPERS = ("test_refactor_parity",)
LEFT_OUT = {
    # the recording observer is not ported yet (ROADMAP §1 item 3)
    "test_kernel_route": ("test_kernel_us_histograms_reach_observer",),
}
_TESTS = Path(__file__).resolve().parent


class CpuStore(T.Store):
    """The port's ``Store`` on the CPU (its kernels' plain versions)."""

    def __init__(self, cfg, *args, **kwargs):
        kwargs.setdefault("device", "cpu")
        super().__init__(cfg, *args, **kwargs)

    @classmethod
    def open(cls, path, *args, **kwargs):
        kwargs.setdefault("device", "cpu")
        return super().open(path, *args, **kwargs)


class CpuAccessTracker(TA.AccessTracker):
    """The port's ``AccessTracker`` routing on the CPU (kernels on: its
    sketches' counters are CPU tensors, its kernels the plain versions)."""

    __slots__ = ()

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("device", "cpu")
        super().__init__(*args, **kwargs)

    @classmethod
    def from_config(cls, cfg, device="cpu") -> "CpuAccessTracker":
        return super().from_config(cfg, device)


BOUND = {"Store": CpuStore, "AccessTracker": CpuAccessTracker}
_HELPER_MODULES: dict[str, types.ModuleType] = {}


def _port_module(name: str) -> types.ModuleType:
    """``repro_torch.X`` for ``repro.X``; the reference's module where the
    port has none yet."""
    port = "repro_torch" + name[len("repro"):]
    try:
        return importlib.import_module(port)
    except ModuleNotFoundError as e:
        if not port.startswith(str(e.name)):
            raise
        return importlib.import_module(name)


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    if not level and name in HELPERS:
        if name not in _HELPER_MODULES:
            _HELPER_MODULES[name] = _load(name)
        return _HELPER_MODULES[name]
    if level or not (name == "repro" or name.startswith("repro.")):
        return builtins.__import__(name, globals, locals, fromlist, level)
    if not fromlist:
        raise ImportError(f"replay: use 'from {name} import ...', not "
                          f"'import {name}'")
    mod = _port_module(name)
    bound = types.ModuleType(mod.__name__)
    for attr in fromlist:
        if attr in BOUND:
            value = BOUND[attr]
        elif hasattr(mod, attr):
            value = getattr(mod, attr)
        else:       # a submodule, or a name the port does not have yet
            try:
                value = importlib.import_module(f"{mod.__name__}.{attr}")
            except ModuleNotFoundError:
                value = None
        setattr(bound, attr, value)
    return bound


def _load(suite: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(
        f"replay_on_port_{suite}", _TESTS / f"{suite}.py")
    module = importlib.util.module_from_spec(spec)
    module.__builtins__ = {**vars(builtins), "__import__": _port_import}
    spec.loader.exec_module(module)
    return module


MODULES = {suite: _load(suite) for suite in SUITES}
for _suite, _module in MODULES.items():
    for _name, _fn in vars(_module).items():
        if _name.startswith("test_") and callable(_fn) \
                and _name not in LEFT_OUT.get(_suite, ()):
            globals()[f"test_{_suite[len('test_'):]}__{_name}"] = _fn
del _suite, _module, _name, _fn


def test_replayed_suites_bind_the_port():
    """Every class, function and module a suite took from ``repro`` is the
    port's (``repro.workloads`` aside), ``Store`` is the CPU store and
    ``AccessTracker`` the CPU tracker, and a helper module's functions
    drive the port as well."""
    for suite, module in {**MODULES, **_HELPER_MODULES}.items():
        for name, value in BOUND.items():
            assert getattr(module, name, value) is value
        for name, value in vars(module).items():
            origin = getattr(value, "__module__", None) or \
                (value.__name__ if isinstance(value, types.ModuleType)
                 else "")
            if origin.startswith("repro.") and \
                    not origin.startswith("repro.workloads"):
                raise AssertionError(f"{suite}.{name} is {origin}'s")
    assert MODULES["test_adaptive"].run_fixed_workload is \
        _HELPER_MODULES["test_refactor_parity"].run_fixed_workload
    assert MODULES["test_engines_registry"].engreg._REGISTRY is \
        importlib.import_module("repro_torch.core.engines.registry")._REGISTRY
