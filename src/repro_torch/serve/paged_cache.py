"""Scavenger-style paged KV-cache manager (serving substrate).

Mapping of the paper onto HBM cache management (DESIGN.md §3/§4):
  pages               <-> value records
  extents (page runs) <-> vSSTs (allocation/GC granularity)
  page table          <-> index LSM-tree
  finished sequences  <-> overwritten keys (garbage)
  HBM budget          <-> the 1.5x space quota

Scavenger mechanics:
  * lazy validity — extent liveness is decided from the page table alone
    (never touching page bytes), the §III-B.1 idea;
  * hotness-aware placement (§III-B.3) — sequences hinted long-lived
    (shared prefixes / system prompts) allocate from cold extents, decode
    bursts from hot extents, so extents die together;
  * GC (§III-B) — when free pages run low, the manager first reclaims
    fully-dead extents (free), then *relocates* live pages out of the
    garbage-heaviest extents (copy cost = live fraction), exactly the
    paper's ratio-triggered GC;
  * throttling (§III-D) — admission blocks when a request's worst-case
    page need exceeds what GC can free.

The manager is policy + bookkeeping over a page pool array (NumPy, copied
from the reference package).  As in the reference, the serving engine keeps
a dense per-slot cache and never gathers pages through the table
(``page_table_array`` has no caller on the serving path); the gather kernel
is ``repro_torch.kernels.paged_gather``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Extent:
    eid: int
    start: int                 # first page index in the pool
    n_pages: int
    hot: bool
    live: int = 0
    dead: int = 0

    def garbage_ratio(self) -> float:
        used = self.live + self.dead
        return self.dead / used if used else 0.0


class PagedKVCacheManager:
    def __init__(self, n_pages: int, page_size: int,
                 extent_pages: int = 64, gc_threshold: float = 0.2):
        assert n_pages % extent_pages == 0
        self.n_pages = n_pages
        self.page_size = page_size
        self.extent_pages = extent_pages
        self.gc_threshold = gc_threshold
        self.extents: list[Extent] = [
            Extent(i, i * extent_pages, extent_pages, hot=False)
            for i in range(n_pages // extent_pages)]
        self.free_extents = list(range(len(self.extents)))
        self.active: dict[int, Extent] = {}        # hot-> open extent
        self.page_owner = np.full(n_pages, -1, np.int64)   # seq id or -1
        self.page_tables: dict[int, list[int]] = {}        # seq -> pages
        self.seq_hot: dict[int, bool] = {}
        self.next_free_in_extent: dict[int, int] = {}
        # stats
        self.pages_relocated = 0
        self.gc_runs = 0
        self.admission_blocks = 0

    # ----------------------------------------------------------- allocation
    def _open_extent(self, hot: bool) -> Extent | None:
        ext = self.active.get(hot)
        if ext is not None and self.next_free_in_extent[ext.eid] \
                < ext.n_pages:
            return ext
        if not self.free_extents:
            return None
        ext = self.extents[self.free_extents.pop(0)]
        ext.hot, ext.live, ext.dead = hot, 0, 0
        self.active[hot] = ext
        self.next_free_in_extent[ext.eid] = 0
        return ext

    def _alloc_page(self, seq: int, hot: bool) -> int | None:
        ext = self._open_extent(hot)
        if ext is None:
            self.run_gc()
            ext = self._open_extent(hot)
            if ext is None:
                return None
        slot = self.next_free_in_extent[ext.eid]
        self.next_free_in_extent[ext.eid] += 1
        page = ext.start + slot
        ext.live += 1
        self.page_owner[page] = seq
        return page

    def admit(self, seq: int, n_pages: int, hot: bool = True) -> bool:
        """Reserve pages for a sequence; False if HBM can't hold it."""
        if self.free_pages() < n_pages:
            self.run_gc()
        if self.free_pages() < n_pages:
            self.admission_blocks += 1
            return False
        self.page_tables[seq] = []
        self.seq_hot[seq] = hot
        for _ in range(n_pages):
            p = self._alloc_page(seq, hot)
            if p is None:
                self.finish(seq)
                self.admission_blocks += 1
                return False
            self.page_tables[seq].append(p)
        return True

    def extend(self, seq: int, n_pages: int = 1) -> bool:
        """Grow a sequence during decode."""
        for _ in range(n_pages):
            p = self._alloc_page(seq, self.seq_hot.get(seq, True))
            if p is None:
                return False
            self.page_tables[seq].append(p)
        return True

    def finish(self, seq: int) -> None:
        """Sequence done: its pages become garbage (lazy — page table only,
        no page bytes touched)."""
        for p in self.page_tables.pop(seq, []):
            ext = self.extents[p // self.extent_pages]
            ext.live -= 1
            ext.dead += 1
            self.page_owner[p] = -1
        self.seq_hot.pop(seq, None)

    # ------------------------------------------------------------------ GC
    def free_pages(self) -> int:
        n = len(self.free_extents) * self.extent_pages
        for hot, ext in self.active.items():
            if ext is not None:
                n += ext.n_pages - self.next_free_in_extent[ext.eid]
        return n

    def run_gc(self) -> int:
        """Reclaim dead extents; relocate live pages out of garbage-heavy
        extents (copy cost tracked).  Returns pages reclaimed."""
        self.gc_runs += 1
        reclaimed = 0
        for ext in self.extents:
            if ext in self.active.values():
                # an open extent that is fully dead resets in place
                if ext.live == 0 and ext.dead > 0:
                    reclaimed += self.next_free_in_extent[ext.eid]
                    ext.dead = 0
                    self.next_free_in_extent[ext.eid] = 0
                continue
            used = ext.live + ext.dead
            if used == 0 or ext.eid in self.free_extents:
                continue
            if ext.live == 0:
                ext.dead = 0
                self.free_extents.append(ext.eid)
                reclaimed += ext.n_pages
            elif ext.garbage_ratio() >= self.gc_threshold:
                moved = self._relocate(ext)
                if moved is not None:
                    reclaimed += ext.n_pages
        return reclaimed

    def _relocate(self, ext: Extent) -> int | None:
        live_pages = [p for p in range(ext.start, ext.start + ext.n_pages)
                      if self.page_owner[p] >= 0]
        # need room elsewhere first
        if self.free_pages() - (ext.n_pages - len(live_pages)) \
                < len(live_pages):
            return None
        for p in live_pages:
            seq = int(self.page_owner[p])
            np_ = self._alloc_page(seq, self.seq_hot.get(seq, True))
            if np_ is None:
                return None
            pt = self.page_tables[seq]
            pt[pt.index(p)] = np_
            self.page_owner[p] = -1
            self.pages_relocated += 1
        ext.live = ext.dead = 0
        self.free_extents.append(ext.eid)
        return len(live_pages)

    # ----------------------------------------------------------- interface
    def page_table_array(self, seqs: list[int], max_pages: int,
                         zero_page: int = 0) -> np.ndarray:
        """(B, max_pages) int32 table for kernels.paged_gather."""
        out = np.full((len(seqs), max_pages), zero_page, np.int32)
        for i, s in enumerate(seqs):
            pt = self.page_tables.get(s, [])[:max_pages]
            out[i, :len(pt)] = pt
        return out

    def stats(self) -> dict:
        live = sum(e.live for e in self.extents)
        dead = sum(e.dead for e in self.extents)
        return {"free_pages": self.free_pages(), "live_pages": live,
                "dead_pages": dead, "gc_runs": self.gc_runs,
                "pages_relocated": self.pages_relocated,
                "admission_blocks": self.admission_blocks,
                "frag_amp": (live + dead) / max(live, 1)}
