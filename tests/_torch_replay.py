"""Machinery that replays the reference's test suites on the port.

A suite (a test module of the reference package) is loaded afresh from
its file under a new module name, with every ``repro.X`` import it makes
bound to the same name in ``repro_torch.X``.  The redirect sits in the
fresh module's own ``__import__``, so it covers the imports inside test
bodies too; the reference's modules themselves stay untouched and keep
testing ``repro``.  ``Store`` and ``ShardedStore`` bind to subclasses of
the port's that run on the CPU (the port's default device is CUDA), and
``AccessTracker`` to one whose trackers route on the CPU.  A sibling test
module a suite imports helpers from (``HELPERS``) is loaded the same way,
so its helpers drive the port too.  A module the port does not have yet
binds the reference's; a name the port's module lacks binds ``None``.

``expose`` puts each test function of the loaded suites into a test
module's namespace as ``test_<suite>__<name>``, with its parametrisation
and hypothesis decorators, so each case runs once, against the port;
``assert_binds_port`` checks what a suite took from ``repro``: the
port's, but for names of a module the port does not have, which a test
module exempts by name together with the cases it leaves out.
"""

from __future__ import annotations

import builtins
import importlib
import importlib.util
import types
from pathlib import Path

import repro_torch.core as T
import repro_torch.core.adaptive as TA

# sibling test modules whose helpers a suite imports
HELPERS = ("test_refactor_parity",)
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


class CpuShardedStore(T.ShardedStore):
    """The port's ``ShardedStore`` on the CPU: every shard, replica and
    recovered shard it makes runs there."""

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


BOUND = {"Store": CpuStore, "ShardedStore": CpuShardedStore,
         "AccessTracker": CpuAccessTracker}
HELPER_MODULES: dict[str, types.ModuleType] = {}


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
        if name not in HELPER_MODULES:
            HELPER_MODULES[name] = load(name)
        return HELPER_MODULES[name]
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


def load(suite: str) -> types.ModuleType:
    """The reference's ``tests/<suite>.py``, loaded afresh on the port."""
    spec = importlib.util.spec_from_file_location(
        f"replay_on_port_{suite}", _TESTS / f"{suite}.py")
    module = importlib.util.module_from_spec(spec)
    module.__builtins__ = {**vars(builtins), "__import__": _port_import}
    spec.loader.exec_module(module)
    return module


def expose(namespace: dict, modules: dict, left_out: dict) -> None:
    """Each test function of ``modules`` ({suite: module}) into
    ``namespace`` as ``test_<suite>__<name>``, but those ``left_out``
    names ({suite: names})."""
    for suite, module in modules.items():
        for name, fn in vars(module).items():
            if name.startswith("test_") and callable(fn) \
                    and name not in left_out.get(suite, ()):
                namespace[f"test_{suite[len('test_'):]}__{name}"] = fn


def assert_binds_port(modules: dict, exempt: dict | None = None) -> None:
    """Every class, function and module the ``modules`` took from
    ``repro`` is the port's, ``Store`` and ``ShardedStore`` are the CPU
    stores and ``AccessTracker`` the CPU tracker.  The names ``exempt``
    gives ({suite: names}) are exactly those the reference still provides,
    because the port has no module for them."""
    exempt = exempt or {}
    for suite, module in modules.items():
        for name, value in BOUND.items():
            assert getattr(module, name, value) is value
        reference = set()
        for name, value in vars(module).items():
            origin = getattr(value, "__module__", None) or \
                (value.__name__ if isinstance(value, types.ModuleType)
                 else "")
            if origin.startswith("repro."):
                reference.add(name)
        assert reference == set(exempt.get(suite, ())), \
            f"{suite} takes {sorted(reference)} from the reference"
