"""vSST construction: cut sorted value records into target-size files,
temperature-partitioned when the engine's write policy asks for it.

Partitioning policy, in precedence order:

  * ``EngineStrategy.rewrite_temperature`` (adaptive engines, DESIGN.md §8)
    — three-way hot/warm/cold classes from the decayed write-rate tracker,
    applied at flush separation *and* GC rewrite: hot records group with
    hot records (their files turn to garbage together), cold records stop
    riding along through rewrite after rewrite.
  * ``cfg.hotcold_write`` (Scavenger §III-B.3) — binary DropCache split.
  * neither — one undifferentiated stream.
"""

from __future__ import annotations

import numpy as np

from ..engine.tables import (TEMP_COLD, TEMP_HOT, TEMP_WARM, SSTable,
                             build_vsst)

TEMP_NAMES = {TEMP_HOT: "hot", TEMP_WARM: "warm", TEMP_COLD: "cold"}


def build_value_files(store, keys, vids, vsizes, cat: str):
    """Build vSST(s) from sorted records, temperature-split when enabled.

    Returns (files, fid_per_record)."""
    cfg = store.cfg
    n = len(keys)
    fid_per_rec = np.zeros(n, np.int64)
    files: list[SSTable] = []
    if n == 0:
        return files, fid_per_rec
    temps = store.strategy.rewrite_temperature(store, keys)
    if temps is not None:
        classes = [(temps == c, c) for c in (TEMP_HOT, TEMP_WARM, TEMP_COLD)]
    elif cfg.hotcold_write:
        hot = store.dropcache.is_hot(keys)
        classes = [(hot, TEMP_HOT), (~hot, TEMP_COLD)]
    else:
        classes = [(np.ones(n, bool), TEMP_COLD)]
    for mask, temp in classes:
        idx = np.nonzero(mask)[0]
        if len(idx) == 0:
            continue
        # per-temperature cause scope: vSST writes decompose by
        # temperature class in the attribution ledger (§13)
        with store.obs.cause(store, op="vsst_build", temp=TEMP_NAMES[temp]):
            rec = cfg.value_rec_bytes(vsizes[idx]).astype(np.int64)
            cum = np.cumsum(rec) - rec
            fno = cum // cfg.vsst_bytes
            for f in np.unique(fno):
                m = idx[fno == f]
                t = build_vsst(cfg, keys[m], np.full(len(m), store.seq,
                                                     np.uint64),
                               vids[m], vsizes[m], is_hot=temp == TEMP_HOT,
                               temperature=temp)
                store.version.add_value_file(t)
                store.io.seq_write(t.file_bytes, cat)
                store._log_edit("add_value_file", fid=t.fid,
                                nbytes=t.file_bytes, temperature=int(temp))
                store.obs.on_space(store, "vsst_add", t.file_bytes)
                fid_per_rec[m] = t.fid
                files.append(t)
    return files, fid_per_rec
