"""Hybrid placement engine: size-tiered KV separation (sixth engine).

Following the hybrid-placement line of work (Xanthakis et al., "Parallax:
Balancing Garbage Collection vs I/O Amplification"), values are placed by
size *tier* instead of a single separation threshold:

  * small  (< ``sep_threshold``)          — always inline in the LSM-tree:
    relocating them would cost more index I/O than their bytes save.
  * medium (``sep_threshold`` .. ``hybrid_large_threshold``) — separated
    only when write-*cold*.  Hot medium values stay inline: rewriting them
    through compaction is cheaper than the GC churn their garbage would
    cause in the value store (the GC-vs-I/O-amplification balance).
  * large  (>= ``hybrid_large_threshold``) — always separated: their I/O
    amplification under compaction dominates any GC cost.

Hotness reuses the DropCache write-hotness signal (keys recently
over-written, §III-B.3).  The engine is *pure strategy*: it only overrides
``separation_mask`` and inherits inheritance-GC, compensated compaction,
lazy read and the decoupled index from the shared hook implementations —
zero edits to the core read/values layers (the extension recipe in
DESIGN.md §7).
"""

from __future__ import annotations

from ..engine.tables import ETYPE_INLINE
from .base import EngineStrategy
from .registry import register_engine


@register_engine
class HybridEngine(EngineStrategy):
    name = "hybrid"
    kv_separated = True
    gc_schemes = ("inherit", "writeback")
    compensated_compaction = True
    lazy_read = True
    index_decoupled = True
    hotcold_write = True

    def separation_mask(self, store, keys, ety, vsizes):
        cfg = self.cfg
        inline = ety == ETYPE_INLINE
        large = vsizes >= cfg.hybrid_large_threshold
        medium = (vsizes >= cfg.sep_threshold) & ~large
        cold = ~store.dropcache.is_hot(keys)
        return inline & (large | (medium & cold))
