from .ops import gc_lookup
from .ref import gc_lookup_ref

__all__ = ["gc_lookup", "gc_lookup_ref"]
