"""Garbage collection orchestration (paper §II-C, §III-B; DESIGN.md §7).

``run_gc`` is the scheme-agnostic skeleton — read candidates, GC-Lookup,
validity, lazy value read, write, retire — with every scheme-specific step
delegated to the store's engine strategy (``repro_torch.core.engines``):

  * inherit (TerarkDB / Scavenger / hybrid): no index writeback; GC output
    files inherit from the candidates they merged; reads resolve via the
    chain (``core/values/resolve.py``).
      - TerarkDB read step: full vSST scan through the block cache.
      - Scavenger read step ("lazy read", §III-B.1): RTable dense-index
        blocks only, then — after GC-Lookup — only the *valid* records,
        coalesced into runs.
      - Scavenger write step (§III-B.3): hotness-aware hot/cold vSST split
        via DropCache.
  * writeback (Titan): full blob scan with *uncached* reads, validity by
    exact locator, valid records rewritten and the new locator written back
    through the foreground path (Write-Index) — extra WAL/memtable/compaction
    load, the paper's ~38% GC-latency step.
  * compaction (BlobDB): no standalone GC — relocation happens inside
    compaction (``engines/paper.py:BlobDBEngine.on_compaction_kept``); blob
    files are reclaimed only once every reference has been rewritten or
    dropped.
"""

from __future__ import annotations

import numpy as np

from .engine import io as sio
from .engine.tables import ETYPE_REF, SSTable


def gc_candidates(store, threshold: float) -> list[SSTable]:
    """Eligible candidate vSSTs, best first.

    Eligibility and ranking go through the engine strategy's
    ``gc_candidate_score`` — the raw garbage ratio for the paper engines
    (static-threshold policy), predicted dead-byte yield for
    ``scavenger_adaptive`` (DESIGN.md §8)."""
    strat = store.strategy
    scores = {t.fid: strat.gc_candidate_score(store, t)
              for t in store.version.value_files.values() if t.n > 0}
    cands = [t for t in store.version.value_files.values()
             if t.n > 0 and scores[t.fid] >= threshold]
    cands.sort(key=lambda t: scores[t.fid], reverse=True)
    return cands


def gc_batch(store, cands: list[SSTable]) -> list[SSTable]:
    """Batch candidates per GC run: up to ``gc_batch_files`` target-size
    outputs worth of input (one run models TerarkDB's multi-file GC job)."""
    budget = store.cfg.gc_batch_files * store.cfg.vsst_bytes
    batch, acc = [], 0
    for t in cands:
        batch.append(t)
        acc += t.file_bytes
        if acc >= budget or len(batch) >= store.cfg.gc_batch_cap:
            break
    return batch


def has_pending(store, threshold: float) -> bool:
    if not store.strategy.wants_standalone_gc():
        return False
    return bool(gc_candidates(store, threshold))


def run_gc(store, candidates: list[SSTable]) -> None:
    strat = store.strategy
    store.in_gc = True
    try:
        # ---------------------------------------------------- 1. Read phase
        for t in candidates:
            strat.gc_read_candidate(store, t)

        # ------------------------------------------------ 2. GC-Lookup phase
        all_keys = np.concatenate([t.keys for t in candidates])
        all_vids = np.concatenate([t.vids for t in candidates])
        all_vsz = np.concatenate([t.vsizes for t in candidates])
        cand_of = np.concatenate([np.full(t.n, i, np.int64)
                                  for i, t in enumerate(candidates)])
        res = store.lookup_entries(all_keys, sio.CAT_GC_LOOKUP)

        valid = res["found"] & (res["etype"] == ETYPE_REF) & \
            (res["vid"] == all_vids)
        valid = strat.gc_refine_valid(store, candidates, cand_of, res,
                                      all_keys, all_vids, valid)

        # ------------------------------------- 3. lazy value read (Scavenger)
        strat.gc_value_read(store, candidates, cand_of, valid)

        # ---------------------------------------------------- 4. Write phase
        vkeys = all_keys[valid]
        vvids = all_vids[valid]
        vvsz = all_vsz[valid]
        order = np.argsort(vkeys, kind="stable")
        vkeys, vvids, vvsz = vkeys[order], vvids[order], vvsz[order]
        new_files, new_fid_per_rec = store.build_value_files(
            vkeys, vvids, vvsz, sio.CAT_GC_WRITE)
        store._crashpoint("gc_pre_chain")    # outputs written, chains /
        #                                      registry not yet updated

        # --------------------------------- 5. retire candidates / writeback
        strat.gc_finalize(store, candidates, new_files, vkeys, vvids, vvsz,
                          new_fid_per_rec)
        store._crashpoint("gc_post_chain")   # chain update durable in the
        #                                      MANIFEST, run counter not yet

        store.n_gc_runs += 1
        rewrite = sum(t.file_bytes for t in new_files)
        reclaimed = sum(t.file_bytes for t in candidates) - rewrite
        store.gc_reclaimed_bytes += reclaimed
        # per-job observability (DESIGN.md §11): the distribution of
        # rewrite/reclaim bytes per GC run is the paper's Fig.3 axis
        store.obs.on_op(store, "gc_rewrite_bytes", rewrite)
        store.obs.on_op(store, "gc_reclaimed_bytes", reclaimed)
        store.obs.on_op(store, "gc_input_files", len(candidates))
        # space-event ledger (§13): rewrite/reclaim bytes by cause
        store.obs.on_space(store, "gc_rewrite", rewrite)
        store.obs.on_space(store, "gc_reclaim", reclaimed)
    finally:
        store.in_gc = False
