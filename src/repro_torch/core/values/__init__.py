"""Value-store layer: vSST build, coalesced fetch planning, inheritance
resolution, garbage exposure (see DESIGN.md §7)."""

from .build import build_value_files
from .fetch import read_values_batch
from .garbage import expose_garbage
from .resolve import GCGroup, resolve_value_fids, resolve_value_file

__all__ = ["GCGroup", "build_value_files", "expose_garbage",
           "read_values_batch", "resolve_value_fids", "resolve_value_file"]
