"""The five paper engines as registered strategies (paper §II, §IV;
DESIGN.md §7).

Each class is *pure declaration*: the shared hook implementations in
``EngineStrategy`` are config-driven, so an engine is its attribute block
plus (for BlobDB) the one hook that genuinely differs.
"""

from __future__ import annotations

import numpy as np

from ..engine import io as sio
from .base import EngineStrategy
from .registry import register_engine


@register_engine
class RocksDBEngine(EngineStrategy):
    """Vanilla leveled LSM-tree: no KV separation, no GC."""

    name = "rocksdb"
    kv_separated = False
    gc_schemes = ("none",)


@register_engine
class BlobDBEngine(EngineStrategy):
    """RocksDB BlobDB: KV separation with compaction-triggered relocation;
    blob files die only when fully exhausted (§II-C)."""

    name = "blobdb"
    kv_separated = True
    gc_schemes = ("compaction",)

    def on_compaction_kept(self, store, kept):
        """During compaction, rewrite values whose blob files are old or
        garbage-heavy; blob files die only when fully exhausted."""
        cfg = self.cfg
        keys, seqs, ety, vids, vsz, vf = kept
        from ..engine.tables import ETYPE_REF
        refs = np.nonzero(ety == ETYPE_REF)[0]
        if len(refs) == 0:
            return kept
        live = sorted(store.version.value_files)
        if not live:
            return kept
        cutoff_i = live[int(len(live) * cfg.blobdb_age_cutoff)] \
            if len(live) > 1 else live[0]
        reloc_rows = []
        for i in refs.tolist():
            t = store.version.value_files.get(int(vf[i]))
            if t is None:
                continue
            # RocksDB BlobDB default: relocation by age cutoff only
            # (garbage-ratio forcing is disabled) — blob files must exhaust
            # their data through compaction before being reclaimed (§II-C).
            if t.fid <= cutoff_i:
                reloc_rows.append(i)
        if not reloc_rows:
            return kept
        rows = np.array(reloc_rows, np.int64)
        # relocation is its own cause class in the attribution ledger
        # (§13): blobdb moves bytes during compaction, not GC.  The
        # age-cutoff pick survives the nested vsst_build op override, so
        # relocated vSST writes stay attributable to relocation.
        with store.obs.cause(store, op="blob_reloc", pick="age_cutoff"):
            # read old values
            for i in rows.tolist():
                t = store.version.value_files[int(vf[i])]
                store.io.rand_read(int(cfg.value_rec_bytes(int(vsz[i]))),
                                   sio.CAT_GC_READ)
            new_files, nfids = store.build_value_files(keys[rows],
                                                       vids[rows], vsz[rows],
                                                       sio.CAT_GC_WRITE)
            # retire refs from the old files
            for i, nf in zip(rows.tolist(), nfids.tolist()):
                t = store.version.value_files.get(int(vf[i]))
                if t is not None:
                    pos = int(t.find(np.array([keys[i]], np.uint64))[0])
                    if pos >= 0 and int(t.vids[pos]) == int(vids[i]):
                        t.garbage_bytes += int(t.rec_bytes[pos])
                        t.live_refs -= 1
                        if t.live_refs <= 0:
                            store.version.retire_value_file(t.fid, None)
                            store.cache.erase_file(t.fid)
                            store._log_edit("retire_value_file", fid=t.fid)
                            store.obs.on_space(store, "retire", t.file_bytes)
                vf[i] = nf
        return (keys, seqs, ety, vids, vsz, vf)


@register_engine
class TitanEngine(EngineStrategy):
    """Titan: standalone GC rewriting locators through the foreground
    write path (Write-Index, §II-C)."""

    name = "titan"
    kv_separated = True
    gc_schemes = ("writeback",)


@register_engine
class TerarkDBEngine(EngineStrategy):
    """TerarkDB: file-number inheritance, no writeback (§II-B).  The
    ``writeback`` scheme is also accepted for ablations."""

    name = "terarkdb"
    kv_separated = True
    gc_schemes = ("inherit", "writeback")


@register_engine
class ScavengerEngine(EngineStrategy):
    """Scavenger: inheritance GC plus the paper's four features (§III):
    compensated compaction, lazy read, decoupled index, hot/cold split."""

    name = "scavenger"
    kv_separated = True
    gc_schemes = ("inherit", "writeback")
    compensated_compaction = True
    lazy_read = True
    index_decoupled = True
    hotcold_write = True
