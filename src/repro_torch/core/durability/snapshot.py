"""Store snapshots: full-state checkpoint encode/restore (port of
``repro.core.durability.snapshot``, DESIGN.md §9).

A snapshot captures *everything* a ``Store`` needs to resume byte-identical
to an uninterrupted run: the engine config, sequence/vid watermarks, every
reachable SSTable (level files, the value-file registry in insertion order,
and tables referenced only through GC inheritance groups), the inheritance
graph itself (with GCGroup identity sharing preserved), memtable and
immutable contents, both caches' LRU order and hit counters, the simulated
device's per-category clocks and byte counters, the stats oracle's runs,
and — for ``scavenger_adaptive`` — the tracker's decayed sketches, lifetime
histograms, and the GC score cache.  Restoring then replaying the WAL tail
therefore reproduces the reference run's ``stats()`` to the last byte
(asserted by the crash matrix in ``tests/test_torch_durability.py``).
The format is the reference package's: either package restores the
other's snapshots.

On disk a snapshot is one record log in the shared CRC framing
(``records.py``): a JSON ``meta`` record, one packed-array record per
column, and an ``end`` completeness marker (a snapshot without it was torn
mid-write and is rejected, so recovery falls back to the previous one).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from ..engine.config import EngineConfig
from ..engine.io import DeviceModel, SimIO
from ..engine.memtable import Memtable
from ..engine.tables import KIND_VALUE, SSTable
from .records import append_record, pack_array, scan_records, unpack_array

FORMAT = 1

_MT_COLS = ("keys", "seqs", "ety", "vids", "vsz", "vf")
_MT_DTYPES = (np.uint64, np.uint64, np.uint8, np.uint64, np.int64, np.int64)
_TBL_COLS = ("keys", "seqs", "etype", "vids", "vsizes", "vfiles")


# ============================================================== capture
def _memtable_arrays(mt: Memtable) -> dict[str, np.ndarray]:
    n = len(mt.entries)
    keys = np.fromiter(mt.entries.keys(), np.uint64, count=n)
    vals = list(mt.entries.values())
    cols = [keys] + [
        np.fromiter((v[i] for v in vals), dt, count=n)
        for i, dt in enumerate(_MT_DTYPES[1:])]
    return dict(zip(_MT_COLS, cols))


def _collect_tables(store) -> dict[int, SSTable]:
    tables: dict[int, SSTable] = {}
    for t in store.version.all_kssts():
        tables[t.fid] = t
    for fid, t in store.version.value_files.items():
        tables[fid] = t
    for g in store.chains.values():
        for t in g.files:                 # may include retired tables
            tables.setdefault(t.fid, t)
    return tables


def snapshot_state(store) -> tuple[dict, dict]:
    """-> (meta, arrays): the complete serializable state of a Store."""
    assert not store.in_batch_write and not store.in_gc, \
        "checkpoint inside a write batch or GC run"
    arrays: dict[str, np.ndarray] = {}

    tables = _collect_tables(store)
    tmeta = []
    for fid, t in tables.items():
        ent = {"fid": fid, "kind": t.kind, "layout": t.layout,
               "is_hot": bool(t.is_hot), "temperature": int(t.temperature),
               "compensated_extra": int(t.compensated_extra),
               "merged_into": t.merged_into}
        if t.kind == KIND_VALUE:
            ent["garbage_bytes"] = int(t.garbage_bytes)
            ent["live_refs"] = int(t.live_refs)
        tmeta.append(ent)
        for c in _TBL_COLS:
            arrays[f"t{fid}_{c}"] = getattr(t, c)

    # GC inheritance groups, identity-shared (one GCGroup per GC run is
    # referenced by every candidate it retired)
    groups: list[list[int]] = []
    gid_of: dict[int, int] = {}
    chain_of: dict[str, int] = {}
    for fid, g in store.chains.items():
        gid = gid_of.get(id(g))
        if gid is None:
            gid = len(groups)
            gid_of[id(g)] = gid
            groups.append([t.fid for t in g.files])
        chain_of[str(fid)] = gid

    for name, mt in [("mt", store.memtable)] + [
            (f"imm{i}", m) for i, m in enumerate(store.immutables)]:
        for c, a in _memtable_arrays(mt).items():
            arrays[f"{name}_{c}"] = a

    o = store.latest
    for c, a in (("bkeys", o.bkeys), ("bvids", o.bvids),
                 ("bvsizes", o.bvsizes), ("dkeys", o.dkeys),
                 ("dvids", o.dvids), ("dvsizes", o.dvsizes)):
        arrays[f"or_{c}"] = a

    adaptive = None
    tracker = getattr(store.strategy, "tracker", None)
    if tracker is not None:
        adaptive = {
            "ops": float(tracker.ops),
            "writes_clock": float(tracker.writes.clock),
            "reads_clock": float(tracker.reads.clock),
            "soon_cache": {str(fid): list(v) for fid, v in
                           getattr(store.strategy, "_soon_cache",
                                   {}).items()},
        }
        arrays["ad_wcounts"] = tracker.writes.counts
        arrays["ad_rcounts"] = tracker.reads.counts
        arrays["ad_lt_last"] = tracker.lifetime.last_write
        arrays["ad_lt_hist"] = tracker.lifetime.hist

    io = store.io
    dev = dataclasses.asdict(io.device)
    meta = {
        "format": FORMAT,
        # state_dict, not asdict: the live observer hook is process
        # state, never snapshot payload
        "cfg": store.cfg.state_dict(),
        "seq": int(store.seq),
        "next_vid": int(store.next_vid),
        "wal_index": int(store.wal_index),
        "compact_cursor": {str(k): v for k, v in
                           store.compact_cursor.items()},
        "counters": {
            "user_write_bytes": int(store.user_write_bytes),
            "n_user_ops": int(store.n_user_ops),
            "n_compactions": int(store.n_compactions),
            "n_gc_runs": int(store.n_gc_runs),
            "gc_reclaimed_bytes": int(store.gc_reclaimed_bytes),
            "stall_us": float(store.stall_us),
            "oracle_valid_bytes": int(store.latest.valid_bytes),
        },
        "io": {
            "lanes": dict(io.lanes),
            "read_bytes": dict(io.read_bytes),
            "write_bytes": dict(io.write_bytes),
            "read_ops": dict(io.read_ops),
            "write_ops": dict(io.write_ops),
            "time_us": dict(io.time_us),
            "device": dev,
        },
        "cache": {
            "low": [[k[0], k[1], k[2], nb]
                    for k, nb in store.cache._low.items()],
            "high": [[k[0], k[1], k[2], nb]
                     for k, nb in store.cache._high.items()],
            "hits": int(store.cache.hits),
            "misses": int(store.cache.misses),
        },
        "dropcache": {
            "keys": list(store.dropcache._lru.keys()),
            "record_count": int(store.dropcache.record_count),
        },
        "tables": tmeta,
        "version": {
            "levels": [[t.fid for t in lvl]
                       for lvl in store.version.levels],
            "value_files": list(store.version.value_files.keys()),
            "chain": {str(k): v for k, v in store.version._chain.items()},
        },
        "chains": {"groups": groups, "chain_of": chain_of},
        "n_immutables": len(store.immutables),
        "adaptive": adaptive,
    }
    return meta, arrays


def write_snapshot(store, path: Path | str) -> Path:
    meta, arrays = snapshot_state(store)
    path = Path(path)
    with open(path, "wb") as fh:
        append_record(fh, "meta", json.dumps(meta, sort_keys=True).encode())
        for name, a in arrays.items():
            append_record(fh, f"a:{name}", pack_array(np.asarray(a)))
        append_record(fh, "end", b"")
        fh.flush()
    return path


# ============================================================== restore
def read_snapshot(path: Path | str) -> tuple[dict, dict]:
    meta, arrays, complete = None, {}, False
    for _, key, payload in scan_records(path):
        if key == b"meta":
            meta = json.loads(payload)
        elif key.startswith(b"a:"):
            arrays[key[2:].decode()] = unpack_array(payload)
        elif key == b"end":
            complete = True
    if meta is None or not complete:
        raise IOError(f"truncated or corrupt snapshot: {path}")
    return meta, arrays


def _restore_memtable(cfg, arrays, prefix: str) -> Memtable:
    mt = Memtable(cfg)
    cols = [arrays[f"{prefix}_{c}"] for c in _MT_COLS]
    keys = cols[0]
    vals = list(zip(*(c.tolist() for c in cols[1:])))
    total = 0
    for k, v in zip(keys.tolist(), vals):
        mt.entries[k] = v
        total += mt._entry_bytes(v[1], v[3])
    mt.bytes = total
    return mt


def restore_store(meta, arrays, io: SimIO | None = None, cls=None,
                  device=None):
    """Rebuild a live Store (or ``cls`` subclass) on ``device`` from a
    decoded snapshot."""
    from ..store import Store          # lazy: snapshot <- store cycle
    from ..values.resolve import GCGroup

    if meta.get("format") != FORMAT:
        raise ValueError(f"unsupported snapshot format {meta.get('format')}")
    cfg = EngineConfig.from_state_dict(meta["cfg"])
    if io is None:
        dev = dict(meta["io"]["device"])
        dev["lane_parallelism"] = dict(dev["lane_parallelism"])
        io = SimIO(DeviceModel(**dev))
    store = (cls or Store)(cfg, io=io, device=device)

    # ---- io ----
    mio = meta["io"]
    io.lanes.update(mio["lanes"])
    for field in ("read_bytes", "write_bytes", "read_ops", "write_ops",
                  "time_us"):
        getattr(io, field).update(mio[field])

    # ---- tables ----
    tables: dict[int, SSTable] = {}
    max_fid = 0
    for ent in meta["tables"]:
        fid = int(ent["fid"])
        cols = [arrays[f"t{fid}_{c}"] for c in _TBL_COLS]
        t = SSTable(cfg, ent["kind"], ent["layout"], *cols,
                    is_hot=ent["is_hot"], temperature=ent["temperature"])
        t.fid = fid
        t.compensated_extra = int(ent["compensated_extra"])
        t.merged_into = ent["merged_into"]
        if ent["kind"] == KIND_VALUE:
            t.garbage_bytes = int(ent["garbage_bytes"])
            t.live_refs = int(ent["live_refs"])
        tables[fid] = t
        max_fid = max(max_fid, fid)
    # keep the process-global fid counter ahead of every restored fid so
    # post-recovery allocations preserve creation order (BlobDB ages files
    # by fid)
    SSTable._next_fid = max(SSTable._next_fid, max_fid + 1)

    v = store.version
    for i, fids in enumerate(meta["version"]["levels"]):
        v.levels[i] = [tables[f] for f in fids]
    v.value_files = {f: tables[f] for f in meta["version"]["value_files"]}
    v._chain = {int(k): vv for k, vv in meta["version"]["chain"].items()}

    groups = [GCGroup([tables[f] for f in fids])
              for fids in meta["chains"]["groups"]]
    store.chains = {int(fid): groups[gid]
                    for fid, gid in meta["chains"]["chain_of"].items()}

    # ---- memtables ----
    store.memtable = _restore_memtable(cfg, arrays, "mt")
    store.immutables = [_restore_memtable(cfg, arrays, f"imm{i}")
                        for i in range(meta["n_immutables"])]

    # ---- caches ----
    for pool, items in (("_low", meta["cache"]["low"]),
                        ("_high", meta["cache"]["high"])):
        d = getattr(store.cache, pool)
        total = 0
        for fid, stream, block, nb in items:
            d[(int(fid), stream, int(block))] = int(nb)
            total += int(nb)
        setattr(store.cache, "low_bytes" if pool == "_low" else "high_bytes",
                total)
    store.cache.hits = int(meta["cache"]["hits"])
    store.cache.misses = int(meta["cache"]["misses"])
    for k in meta["dropcache"]["keys"]:
        store.dropcache._lru[int(k)] = None
    store.dropcache.record_count = int(meta["dropcache"]["record_count"])

    # ---- oracle ----
    o = store.latest
    o.bkeys, o.bvids, o.bvsizes = (arrays["or_bkeys"], arrays["or_bvids"],
                                   arrays["or_bvsizes"])
    o.dkeys, o.dvids, o.dvsizes = (arrays["or_dkeys"], arrays["or_dvids"],
                                   arrays["or_dvsizes"])

    # ---- scalars ----
    c = meta["counters"]
    store.seq = int(meta["seq"])
    store.next_vid = int(meta["next_vid"])
    store.wal_index = int(meta["wal_index"])
    store.compact_cursor = {int(k): vv for k, vv in
                            meta["compact_cursor"].items()}
    store.user_write_bytes = c["user_write_bytes"]
    store.n_user_ops = c["n_user_ops"]
    store.n_compactions = c["n_compactions"]
    store.n_gc_runs = c["n_gc_runs"]
    store.gc_reclaimed_bytes = c["gc_reclaimed_bytes"]
    store.stall_us = c["stall_us"]
    o.valid_bytes = c["oracle_valid_bytes"]

    # ---- adaptive tracker ----
    ad = meta.get("adaptive")
    tracker = getattr(store.strategy, "tracker", None)
    if ad is not None and tracker is not None:
        # the sketches' setters upload resident counters to their device;
        # the lifetime arrays stay host NumPy
        tracker.ops = ad["ops"]
        tracker.writes.counts = arrays["ad_wcounts"]
        tracker.writes.clock = ad["writes_clock"]
        tracker.reads.counts = arrays["ad_rcounts"]
        tracker.reads.clock = ad["reads_clock"]
        tracker.lifetime.last_write = arrays["ad_lt_last"]
        tracker.lifetime.hist = arrays["ad_lt_hist"]
        store.strategy._soon_cache = {int(k): tuple(vv) for k, vv in
                                      ad["soon_cache"].items()}
    return store


def restore(path: Path | str, io: SimIO | None = None, cls=None,
            device=None):
    meta, arrays = read_snapshot(path)
    return restore_store(meta, arrays, io=io, cls=cls, device=device)
