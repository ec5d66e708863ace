"""Leveled compaction with dynamic level sizing and the paper's
compensated-size strategy (paper §III-C; DESIGN.md §7).

Vanilla mode scores levels by *physical* bytes — which, after KV separation,
are tiny (the paper measures 211KB kSSTs vs 64MB), delaying compaction and
inflating the index LSM-tree's space amplification (hidden garbage).

Compensated mode scores levels, picks files, and cuts output files by
``file_bytes + referenced value bytes`` — "converting a separated LSM-tree
into a non-separated one": the index tree re-acquires the vanilla multi-level
shape (S_index -> ~1.11 at ratio 10) and pushes high-density files down so
hidden garbage is exposed promptly.
"""

from __future__ import annotations

import numpy as np

from .engine import io as sio
from .engine.tables import ETYPE_REF, ETYPE_TOMB, SSTable, KIND_KEY


def compute_targets(store):
    """RocksDB dynamic-level-bytes: data targets the bottom level; level
    targets derived from the actual last-level size; returns
    (targets, base_level).  Level weights come from the engine strategy
    (compensated bytes under the paper's §III-C scoring)."""
    cfg = store.cfg
    v = store.version
    last = cfg.max_levels - 1
    s_last = store.strategy.level_weight(v, last)
    targets = [0] * cfg.max_levels
    t = float(max(s_last, cfg.base_level_bytes))
    targets[last] = t
    base_level = last
    for i in range(last - 1, 0, -1):
        t = t / cfg.level_ratio
        if t < cfg.base_level_bytes / cfg.level_ratio:
            break
        targets[i] = max(t, 1.0)
        base_level = i
    return targets, base_level


def level_scores(store):
    """-> list of (score, level). L0 scores by file count; others by
    (compensated) bytes / target."""
    cfg = store.cfg
    v = store.version
    targets, base_level = compute_targets(store)
    scores = [(len(v.levels[0]) / cfg.l0_trigger, 0)]
    last = cfg.max_levels - 1
    for i in range(base_level, last):
        if not v.levels[i]:
            continue
        size = store.strategy.level_weight(v, i)
        if targets[i] > 0:
            scores.append((size / targets[i], i))
    return scores, base_level


def pick_compaction(store):
    scores, base_level = level_scores(store)
    score, level = max(scores, key=lambda s: s[0])
    if score < 1.0:
        return None
    return level, base_level


def _merge_inputs(store, inputs: list[SSTable], drop_tombstones: bool):
    """Merge sorted runs newest-wins; returns (kept arrays, dropped arrays)."""
    keys = np.concatenate([t.keys for t in inputs])
    seqs = np.concatenate([t.seqs for t in inputs])
    ety = np.concatenate([t.etype for t in inputs])
    vids = np.concatenate([t.vids for t in inputs])
    vsz = np.concatenate([t.vsizes for t in inputs])
    vf = np.concatenate([t.vfiles for t in inputs])
    # sort by (key asc, seq desc): lexsort uses last key as primary
    order = np.lexsort((np.iinfo(np.uint64).max - seqs, keys))
    keys, seqs, ety, vids, vsz, vf = (a[order] for a in
                                      (keys, seqs, ety, vids, vsz, vf))
    first = np.ones(len(keys), bool)
    first[1:] = keys[1:] != keys[:-1]
    kept = first.copy()
    dropped = ~first
    if drop_tombstones:
        kept &= ety != ETYPE_TOMB
    return ((keys[kept], seqs[kept], ety[kept], vids[kept], vsz[kept],
             vf[kept]),
            (keys[dropped], ety[dropped], vids[dropped], vsz[dropped],
             vf[dropped]))


def _cut_outputs(store, arrays):
    """Cut merged entries into kSSTs at the *physical* target size.

    Compensation affects level scores and input-file selection (paper
    §III-C / RocksDB compensated_file_size semantics), never the physical
    output file size."""
    cfg = store.cfg
    keys, seqs, ety, vids, vsz, vf = arrays
    n = len(keys)
    if n == 0:
        return []
    rec = np.where(ety == ETYPE_REF, cfg.ref_rec_bytes(),
                   np.where(ety == ETYPE_TOMB, cfg.tomb_rec_bytes(),
                            cfg.inline_rec_bytes(vsz)))
    weight = rec.astype(np.int64)
    cum = np.cumsum(weight)
    file_no = ((cum - weight) // cfg.ksst_bytes).astype(np.int64)
    outs = []
    for f in np.unique(file_no):
        m = file_no == f
        t = SSTable(cfg, KIND_KEY, cfg.ksst_layout, keys[m], seqs[m],
                    ety[m], vids[m], vsz[m], vf[m])
        t.compensated_extra = int(vsz[m][ety[m] == ETYPE_REF].sum())
        outs.append(t)
    return outs


def run_compaction(store, level: int, base_level: int) -> None:
    cfg = store.cfg
    v = store.version
    last = cfg.max_levels - 1

    if level == 0:
        ups = list(v.levels[0])
        if not ups:
            return
        out_level = base_level
        lo = min(t.min_key for t in ups)
        hi = max(t.max_key for t in ups)
    else:
        files = v.levels[level]
        if not files:
            return
        # One job models a round of parallel subcompactions: move enough
        # files to bring the level back under target (cap 8 per job).
        targets, _ = compute_targets(store)
        sz = store.strategy.file_weight
        overshoot = sum(sz(t) for t in files) - targets[level]
        ranked = store.strategy.rank_compaction_inputs(store, files, level)
        ups, moved = [], 0
        for t in ranked:
            ups.append(t)
            moved += sz(t)
            if moved >= overshoot or len(ups) >= cfg.compaction_pick_cap:
                break
        out_level = level + 1
        lo = min(t.min_key for t in ups)
        hi = max(t.max_key for t in ups)

    downs = v.overlapping(out_level, lo, hi)
    inputs = ups + downs
    drop_tomb = out_level == last
    kept, dropped = _merge_inputs(store, inputs, drop_tomb)

    # ---- I/O ----
    in_bytes = sum(t.file_bytes for t in inputs)
    if cfg.readahead_compaction:
        store.io.seq_read(in_bytes, sio.CAT_COMPACT_READ)
    else:
        for t in inputs:
            for b in range(t.n_data_blocks):
                store.io.rand_read(cfg.block_size, sio.CAT_COMPACT_READ)

    # ---- engine hook: compaction-triggered relocation (BlobDB) ----
    kept = store.strategy.on_compaction_kept(store, kept)

    outs = _cut_outputs(store, kept)
    for t in outs:
        store.io.seq_write(t.file_bytes, sio.CAT_COMPACT_WRITE)
    store._crashpoint("mid_compaction")   # outputs written, version not yet
    #                                       updated (DESIGN.md §9)

    # ---- version update ----
    if level == 0:
        v.levels[0] = []
    else:
        v.levels[level] = [t for t in v.levels[level] if t not in ups]
        v._bounds_cache.pop(level, None)
    remain = [t for t in v.levels[out_level] if t not in downs]
    v.set_level(out_level, remain + outs)
    for t in inputs:
        store.cache.erase_file(t.fid)
    if store.durability is not None:
        for t in inputs:
            store._log_edit("drop_file", fid=t.fid)
        for t in outs:
            store._log_edit("add_file", fid=t.fid, level=out_level,
                            nbytes=t.file_bytes)

    # ---- garbage exposure + DropCache (paper §II-D, §III-B.3) ----
    dk, de, dvid, dvsz, dvf = dropped
    store.expose_garbage(dk, de, dvid, dvsz, dvf)
    if cfg.hotcold_write and len(dk):
        store.dropcache.record(dk)
    store.n_compactions += 1


def maybe_compact(store, max_rounds: int = 10_000) -> None:
    for _ in range(max_rounds):
        pick = pick_compaction(store)
        if pick is None:
            return
        run_compaction(store, *pick)
