"""Pluggable engine strategies (see DESIGN.md §7).

Importing this package registers the built-in engines; registration order
defines the canonical ``available_engines()`` order (the five paper engines
first, then ``hybrid``, then ``scavenger_adaptive``).
"""

from .base import EngineStrategy
from .registry import (available_engines, get_strategy_class, make_strategy,
                       register_engine)
from . import paper      # noqa: F401  (registers the five paper engines)
from . import hybrid     # noqa: F401  (registers the hybrid engine)
from ..adaptive import engine as _adaptive   # noqa: F401  (scavenger_adaptive)

__all__ = [
    "EngineStrategy", "available_engines", "get_strategy_class",
    "make_strategy", "register_engine",
]
