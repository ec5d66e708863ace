"""Read layer: vectorized lookups and scan merge planning (DESIGN.md §7)."""

from .lookup import lookup_entries, read_block, read_entry_blocks
from .scan import scan_once, scan_retry

__all__ = ["lookup_entries", "read_block", "read_entry_blocks",
           "scan_once", "scan_retry"]
