"""Engine strategy layer: one pluggable policy object per engine
(DESIGN.md §7).

``EngineStrategy`` bundles everything that makes the paper's engines differ
while sharing one substrate (memtable / SSTables / simulated device):

  * flush separation policy      -> ``separation_mask``
  * compaction scoring           -> ``level_weight`` / ``file_weight`` /
                                    ``rank_compaction_inputs``
  * relocation / writeback hooks -> ``on_compaction_kept`` / ``gc_finalize``
  * GC scheme                    -> ``gc_read_candidate`` /
                                    ``gc_refine_valid`` / ``gc_value_read``

Class attributes declare the engine's *defaults*: ``EngineConfig`` resolves
any ablation flag left as ``None`` from the registered strategy class, and
validates a ``gc_scheme`` override against ``gc_schemes``.  The default hook
implementations are config-driven (they branch on ``cfg.gc_scheme`` /
``cfg.lazy_read``), so a new engine that simply declares a supported scheme
inherits the correct behaviour without overriding any GC hook — see
``engines/hybrid.py`` for the extension recipe.
"""

from __future__ import annotations

import numpy as np

from ..engine import io as sio
from ..engine.cache import BlockCache
from ..engine.tables import ETYPE_INLINE


class EngineStrategy:
    """Base policy bundle; concrete engines override attributes + hooks."""

    name: str = "base"
    kv_separated: bool = True
    gc_schemes: tuple[str, ...] = ("inherit",)    # first entry = default
    # ablation-flag defaults (EngineConfig fields left as None resolve here)
    compensated_compaction: bool = False
    lazy_read: bool = False
    index_decoupled: bool = False
    hotcold_write: bool = False
    adaptive_enabled: bool = False    # workload tracker (core/adaptive/)
    # the store's device, for routed state; ``make_strategy`` sets it on
    # the instance before ``__init__`` runs
    device = None

    def __init__(self, cfg):
        self.cfg = cfg

    # ============================================== workload observation
    def observe_batch(self, store, kind: str, keys, vsizes=None) -> None:
        """Foreground-traffic observation hook, called once per columnar
        batch from the write path (``kind="write"``, puts *and* deletes —
        both end a value's lifetime) and ``multi_get`` (``kind="read"``).
        Observation is modeling state only: it must cost no simulated
        device time.  Default: no tracking."""

    def gc_candidate_score(self, store, t) -> float:
        """Score of one vSST as a GC candidate; compared against the GC
        threshold for eligibility and used to rank candidates (and, via the
        ``FleetScheduler``, GC jobs fleet-wide).  Default: the raw garbage
        ratio — the static-threshold policy of the paper engines.  Adaptive
        engines fold in predicted dead-byte yield (``adaptive/engine.py``)."""
        return t.garbage_ratio()

    def rewrite_temperature(self, store, keys) -> np.ndarray | None:
        """Temperature class per record (TEMP_COLD/WARM/HOT) for vSST
        construction, or None to fall back to the binary DropCache hot/cold
        split (``cfg.hotcold_write``).  Drives temperature-partitioned
        vSSTs in ``values/build.py``."""
        return None

    # ==================================================== flush separation
    def separation_mask(self, store, keys: np.ndarray, ety: np.ndarray,
                        vsizes: np.ndarray) -> np.ndarray | None:
        """Mask of flushed entries whose values go to vSSTs (None = none)."""
        if not self.cfg.kv_separated:
            return None
        return (ety == ETYPE_INLINE) & (vsizes >= self.cfg.sep_threshold)

    # =================================================== compaction scoring
    def level_weight(self, version, i: int) -> int:
        """Bytes a level counts for against its target (paper §III-C)."""
        if self.cfg.compensated_compaction:
            return version.level_compensated_bytes(i)
        return version.level_bytes(i)

    def file_weight(self, t) -> int:
        if self.cfg.compensated_compaction:
            return t.compensated_bytes
        return t.file_bytes

    def rank_compaction_inputs(self, store, files: list, level: int) -> list:
        """Order candidate input files for an L>=1 compaction job."""
        if self.cfg.compensated_compaction:
            # push the highest value-density files down first (§III-C)
            return sorted(files, key=lambda t: t.compensated_bytes
                          / max(t.file_bytes, 1), reverse=True)
        cur = store.compact_cursor.get(level, 0) % len(files)
        store.compact_cursor[level] = cur + 1
        return files[cur:] + files[:cur]

    def on_compaction_kept(self, store, kept: tuple) -> tuple:
        """Hook over the surviving merged columns (BlobDB relocation)."""
        return kept

    # ========================================================== GC scheme
    def wants_standalone_gc(self) -> bool:
        return self.cfg.gc_scheme in ("inherit", "writeback")

    def gc_read_candidate(self, store, t) -> None:
        """Read phase for one GC candidate vSST (paper §II-C, §III-B.1)."""
        cfg, io = self.cfg, store.io
        if cfg.lazy_read and t.layout == "rtable":
            # Lazy read: dense-index blocks only (§III-B.1).
            for b in range(t.n_index_blocks):
                store.read_block(t, "ib", b, sio.CAT_GC_READ,
                                 BlockCache.PRI_HIGH, t.index_block_bytes())
        elif cfg.gc_scheme == "writeback":
            # Titan: direct (uncached) full-file scan.
            if cfg.readahead_gc:
                io.seq_read(t.data_bytes, sio.CAT_GC_READ)
            else:
                for b in range(t.n_data_blocks):
                    io.rand_read(t.data_block_bytes(0, b), sio.CAT_GC_READ)
        else:
            # TerarkDB: full scan through the block cache.
            if cfg.readahead_gc:
                io.seq_read(t.data_bytes, sio.CAT_GC_READ)
            else:
                for b in range(t.n_data_blocks):
                    store.read_block(t, "d0", b, sio.CAT_GC_READ,
                                     BlockCache.PRI_LOW)

    def gc_refine_valid(self, store, candidates, cand_of, res, all_keys,
                        all_vids, valid: np.ndarray) -> np.ndarray:
        """Scheme-specific validity: is the entry's locator really *this*
        candidate's record?"""
        from ..values.resolve import resolve_value_fids
        cand_fids = np.array([t.fid for t in candidates], np.int64)
        if self.cfg.gc_scheme == "inherit":
            # resolve the entry's file number through inheritance chains and
            # compare with the candidate being collected (§II-B).  Fast path:
            # the entry usually points directly at the (live) candidate; the
            # rest resolve in one grouped vectorized pass.
            direct = res["vfile"] == cand_fids[cand_of]
            chained = np.nonzero(valid & ~direct)[0]
            if len(chained):
                heads = resolve_value_fids(store, res["vfile"][chained],
                                           all_keys[chained],
                                           all_vids[chained])
                valid[chained] &= heads == cand_fids[cand_of[chained]]
        else:  # writeback: exact locator match
            valid &= res["vfile"] == cand_fids[cand_of]
        return valid

    def gc_value_read(self, store, candidates, cand_of,
                      valid: np.ndarray) -> None:
        """Value-record reads after GC-Lookup (Scavenger lazy read only:
        eager schemes already scanned the whole file)."""
        cfg, io = self.cfg, store.io
        if not cfg.lazy_read:
            return
        for ci, t in enumerate(candidates):
            pos = np.nonzero(valid & (cand_of == ci))[0]
            if len(pos) == 0:
                continue
            local = pos - int(np.searchsorted(cand_of, ci, side="left"))
            runs = np.split(local, np.nonzero(np.diff(local) != 1)[0] + 1)
            for r in runs:
                nbytes = int(t.rec_bytes[r].sum())
                if cfg.readahead_gc:
                    io.seq_read(nbytes, sio.CAT_GC_READ)
                else:
                    io.rand_read(nbytes, sio.CAT_GC_READ)

    def gc_finalize(self, store, candidates, new_files, vkeys, vvids, vvsz,
                    new_fid_per_rec) -> None:
        """Retire candidates; record inheritance or write back locators."""
        from ..values.resolve import GCGroup
        if self.cfg.gc_scheme == "inherit":
            group = GCGroup(new_files)
            for t in candidates:
                store.version.retire_value_file(t.fid, None)
                store.chains[t.fid] = group
                store.cache.erase_file(t.fid)
            store._log_edit("chain_update",
                            retired=[t.fid for t in candidates],
                            group=[t.fid for t in new_files])
        else:  # titan writeback: index rewrites as one batched write
            store.writeback_index_batch(vkeys, vvids, vvsz, new_fid_per_rec)
            for t in candidates:
                store.version.retire_value_file(t.fid, None)
                store.cache.erase_file(t.fid)
        for t in candidates:
            store.obs.on_space(store, "retire", t.file_bytes)
        if store.durability is not None:
            for t in candidates:
                store._log_edit("retire_value_file", fid=t.fid)
