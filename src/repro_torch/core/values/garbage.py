"""Garbage exposure: entries dropped during compaction expose value-store
garbage (Hidden -> Exposed, paper §II-D; DESIGN.md §7).

Vectorized: one chain-resolution pass for the whole dropped column, one
``find`` + vid-match per touched vSST.  Rows are *not* de-duplicated —
each dropped index entry exposes its record exactly once, matching the
scalar semantics (a Titan writeback can leave two entries for one record;
both expose)."""

from __future__ import annotations

import numpy as np

from ..engine.tables import ETYPE_REF
from .resolve import resolve_value_fids


def expose_garbage(store, keys, ety, vids, vsizes, vfiles) -> None:
    cfg = store.cfg
    refm = ety == ETYPE_REF
    if not refm.any():
        return
    keys = np.asarray(keys, np.uint64)[refm]
    vids = np.asarray(vids, np.uint64)[refm]
    vfiles = np.asarray(vfiles, np.int64)[refm]
    fids = resolve_value_fids(store, vfiles, keys, vids)
    ok = fids >= 0                      # record already dropped by a GC
    if not ok.any():
        return
    fsel, ksel, vsel = fids[ok], keys[ok], vids[ok]
    uniq, first = np.unique(fsel, return_index=True)
    # one vSST per unique fid — structure-bounded  # scavlint: allow-loop
    for fid in uniq[np.argsort(first)].tolist():    # first-occurrence order
        t = store.version.value_files.get(fid)
        if t is None:
            continue    # defensive: fids were resolved against the live
            #             set and each file is visited once, so this does
            #             not trigger today
        m = fsel == fid
        pos = t.find(ksel[m])
        hit = pos >= 0
        safe = np.where(hit, pos, 0)
        hit &= t.vids[safe] == vsel[m]
        nhit = int(hit.sum())
        if nhit == 0:
            continue
        exposed = int(t.rec_bytes[pos[hit]].sum())
        t.garbage_bytes += exposed
        store.obs.on_space(store, "expose", exposed)
        if cfg.gc_scheme == "compaction":
            t.live_refs -= nhit
            if t.live_refs <= 0:
                store.version.retire_value_file(t.fid, None)
                store._log_edit("retire_value_file", fid=t.fid)
                store.obs.on_space(store, "retire", t.file_bytes)
                store.cache.erase_file(t.fid)
