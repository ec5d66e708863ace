"""Engine strategy registry (DESIGN.md §7).

``EngineConfig`` resolves its engine name here; adding an engine is one
``@register_engine`` class in a new module (imported from
``engines/__init__``) — no core-layer edits.
"""

from __future__ import annotations

from .base import EngineStrategy

_REGISTRY: dict[str, type[EngineStrategy]] = {}

def register_engine(cls: type[EngineStrategy]) -> type[EngineStrategy]:
    """Class decorator: register a strategy under its ``name``."""
    if not cls.name or cls.name == "base":
        raise ValueError("engine strategy must set a unique name")
    if cls.name in _REGISTRY:
        raise ValueError(
            f"engine {cls.name!r} is already registered "
            f"(by {_REGISTRY[cls.name].__qualname__}); strategy names "
            f"must be unique")
    _REGISTRY[cls.name] = cls
    return cls


def get_strategy_class(name: str) -> type[EngineStrategy]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; registered engines: "
            f"{', '.join(sorted(_REGISTRY))}") from None


def make_strategy(cfg, device=None) -> EngineStrategy:
    """The strategy ``cfg`` names; routed state (the adaptive tracker's
    batches) runs on ``device``.

    Strategies take the reference's constructor, ``__init__(self, cfg)``,
    so the device is set on the new object before its ``__init__`` runs:
    a constructor that builds routed state reads ``self.device``."""
    cls = get_strategy_class(cfg.engine)
    strat = cls.__new__(cls)
    strat.device = device
    strat.__init__(cfg)
    return strat


def available_engines() -> tuple[str, ...]:
    return tuple(_REGISTRY)
