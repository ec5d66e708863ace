"""KVStore facade (port of ``repro.core.store``): seven selectable engines
over one layered substrate.

``Store(EngineConfig(engine=...))`` gives RocksDB-, BlobDB-, Titan-,
TerarkDB-, Scavenger-, hybrid- or adaptive-Scavenger-semantics over the
same deterministic simulated device, so every paper comparison is
apples-to-apples.  The store's ``device`` (CUDA unless the caller names
another) holds the immutable key columns the batched probes run on
(``core/accel.py``) and runs the adaptive tracker's routed batches.
Durability (``durability_dir``, ``checkpoint``, ``Store.open``) writes the
reference's on-disk format.  A ``ShardedStore`` (``core/sharding/``) runs
many of these as shards under one fleet scheduler.  Recording observers
are not ported yet.

The facade owns scheduling and the write path; everything else is layered
(DESIGN.md §7):

  * ``read/``    — vectorized point lookups + scan merge planning
  * ``values/``  — vSST build, coalesced fetch planning, inheritance-chain
                   resolution, garbage exposure
  * ``engines/`` — one pluggable strategy object per engine (flush
                   separation, GC scheme, relocation/writeback hooks,
                   compaction scoring), resolved from a registry

Scheduling model (see DESIGN.md §3): user operations advance the foreground
lane; flush/compaction/GC jobs run on a sequential background lane that
models 16 background threads saturating one SSD.  Background debt surfaces
as foreground write stalls through the standard RocksDB triggers (immutable
memtable cap, L0 slowdown/stop) — this is what reproduces the paper's
delayed-compaction -> hidden-garbage -> space-amplification chain.

All reads return the value's ``vid`` (the identity the store wrote into both
the index entry and the value record — the stand-in for real value bytes);
tests compare vids against an external oracle.
"""

from __future__ import annotations

import numpy as np

from ..kernels.common import DeviceCache
from ..obs import NULL_OBSERVER
from . import accel
from . import compaction as comp
from . import gc as gcmod
from .batch import OP_PUT, ScalarOps, WriteBatch
from .engine import io as sio
from .engine.cache import BlockCache, DropCache
from .engine.config import EngineConfig
from .engine.io import SimIO
from .engine.memtable import Memtable
from .engine.tables import ETYPE_INLINE, ETYPE_REF, ETYPE_TOMB, SSTable
from .engine.version import Version
from .engines import make_strategy
from .oracle import LatestOracle
from .read import lookup as rlookup
from .read import scan as rscan
from .values import build as vbuild
from .values import fetch as vfetch
from .values import garbage as vgarbage
from .values import resolve as vresolve

__all__ = ["Store"]


class Store(ScalarOps):
    def __init__(self, cfg: EngineConfig, io: SimIO | None = None,
                 durability_dir=None, *, device=None):
        if cfg.observer is not None:
            raise NotImplementedError("recording observers are not ported "
                                      "yet; leave EngineConfig.observer None")
        self.cfg = cfg
        # CUDA unless the caller names a device; raises without one
        self.device = accel.resolve_device(device)
        # device copies of immutable key columns, one per host array
        self.dev_cache = DeviceCache(self.device)
        self.strategy = make_strategy(cfg, self.device)
        self.io = io or SimIO()
        self.cache = BlockCache(cfg.cache_bytes, cfg.cache_high_frac)
        self.dropcache = DropCache(cfg.dropcache_keys)
        self.version = Version(cfg.max_levels)
        self.memtable = Memtable(cfg)
        self.immutables: list[Memtable] = []
        self.chains: dict[int, vresolve.GCGroup] = {}
        self.seq = 0
        self.next_vid = 1
        self.in_gc = False
        self.in_batch_write = False
        self.compact_cursor: dict[int, int] = {}
        self._last_bg = "gc"
        # When this store is a shard of a ShardedStore, the fleet scheduler
        # owns background scheduling: pump() delegates to it so GC/compaction
        # service is ranked across the whole fleet, not per shard.
        self.scheduler = None
        # Durability (DESIGN.md §9): off by default — None costs one
        # attribute check per event and zero simulated device time.
        self.durability = None
        self.wal_index = 0              # monotone journal-record watermark
        self._crash_hooks: dict | None = None
        if durability_dir is not None:
            from .durability import Durability
            self.durability = Durability.create(durability_dir, cfg)

        # stats / bookkeeping
        self.latest = LatestOracle()         # measurement-only oracle for
        #                                      space-amp denominators
        self.user_write_bytes = 0
        self.n_user_ops = 0
        self.n_compactions = 0
        self.n_gc_runs = 0
        self.gc_reclaimed_bytes = 0
        self.stall_us = 0.0

        # Observability: the NullObserver no-ops every hook and never
        # touches the simulated device, as the reference's observer-off runs.
        self.obs = NULL_OBSERVER
        self.obs_label = self.obs.register_store(self)

    @property
    def valid_bytes(self) -> int:
        return self.latest.valid_bytes

    # ================================================================== API
    # The public API is batched and columnar (write / multi_get /
    # multi_scan); scalar put/get/delete/scan are the one-record ScalarOps
    # shims shared with ShardedStore.

    # ------------------------------------------------------- batched writes
    def write(self, batch: WriteBatch) -> np.ndarray:
        """Apply a WriteBatch atomically: one admission check, one
        sequence-number range, one group-committed WAL append, chunked
        vectorized memtable insertion.  Returns the vid per record (0 for
        deletes), in batch order."""
        kinds, keys, vsizes = batch.arrays()
        return self._write_arrays(kinds, keys, vsizes)

    def _write_arrays(self, kinds: np.ndarray, keys: np.ndarray,
                      vsizes: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        n = len(keys)
        vids_out = np.zeros(n, np.uint64)
        if n == 0:
            return vids_out
        # the span covers every foreground advance this batch causes —
        # admission stalls, the WAL append, memtable stalls, delayed-write
        # throttling — so fg-track spans tile the fg lane clock (§11)
        with self.obs.span(self, "write", n=n):
            self._write_pressure()
            is_put = kinds == OP_PUT
            recs = np.where(is_put,
                            cfg.key_bytes + vsizes + cfg.wal_rec_overhead,
                            cfg.key_bytes
                            + cfg.wal_rec_overhead).astype(np.int64)
            total = int(recs.sum())
            seqs = np.uint64(self.seq + 1) + np.arange(n, dtype=np.uint64)
            self.seq += n
            nput = int(is_put.sum())
            vids_out[is_put] = (np.uint64(self.next_vid)
                                + np.arange(nput, dtype=np.uint64))
            self.next_vid += nput
            self.io.seq_write(total, sio.CAT_WAL)  # one group-committed
            #                                        append
            self.obs.instant(self, "wal_append", nbytes=total, n=n)
            if self.durability is not None:
                # host-side persistence of the same batch the simulated WAL
                # append just charged; costs zero simulated time (§9)
                self.wal_index += 1
                self.durability.log_batch(self.wal_index, self.seq - n + 1,
                                          kinds, keys, vsizes)
            if self._crash_hooks is not None:
                self._crashpoint("after_wal")
            self.user_write_bytes += total
            self.n_user_ops += n

            ety = np.where(is_put, ETYPE_INLINE, ETYPE_TOMB).astype(np.uint8)
            vsz = np.where(is_put, vsizes, 0).astype(np.int64)
            vf = np.full(n, -1, np.int64)
            entry_bytes = self.memtable.entry_bytes_batch(ety, vsz)
            self.in_batch_write = True
            try:
                i = 0
                while i < n:
                    i += self.memtable.put_batch(keys[i:], seqs[i:], ety[i:],
                                                 vids_out[i:], vsz[i:],
                                                 vf[i:], entry_bytes[i:])
                    if self.memtable.full and i < n:
                        self.immutables.append(self.memtable)
                        self.memtable = Memtable(cfg)
                        self.pump()
                        self._stall_while(
                            lambda: len(self.immutables) > cfg.max_immutables,
                            trigger="memtable_stall")
            finally:
                self.in_batch_write = False

            self.latest.apply_batch(is_put, keys, vids_out, vsz)
            # workload observation (adaptive tracker; no-op for paper
            # engines, costs no simulated time)
            self.strategy.observe_batch(self, "write", keys, vsz)
            self._after_write(total)
        self.obs.on_op(self, "put_batch_n", n)
        self.obs.on_op(self, "put_batch_bytes", total)
        self.obs.tick(self)
        return vids_out

    def ingest_batch(self, kinds: np.ndarray, keys: np.ndarray,
                     vids: np.ndarray, vsizes: np.ndarray) -> None:
        """Apply records that already own their value identity: WAL
        replay of an ``"i"`` record (``durability/wal.py``), and the
        fleet's shard migration and replica-log replay
        (``sharding/store.py``, ``sharding/migrate.py``; DESIGN.md §14).

        Same simulated device costs and memtable path as ``write`` — one
        group-committed WAL append, chunked insertion, write-pressure
        stalls — and fresh sequence numbers, but the given ``vids`` are
        preserved and nothing is counted as a *user* write
        (``user_write_bytes`` feeds write-amp denominators; migrated bytes
        are amplification, not ingest)."""
        cfg = self.cfg
        kinds = np.asarray(kinds, np.uint8)
        keys = np.asarray(keys, np.uint64)
        vids = np.asarray(vids, np.uint64)
        vsizes = np.asarray(vsizes, np.int64)
        n = len(keys)
        if n == 0:
            return
        if self.durability is not None:
            self.wal_index += 1
            self.durability.log_ingest(self.wal_index, kinds, keys, vids,
                                       vsizes)
        with self.obs.span(self, "ingest", n=n):
            is_put = kinds == OP_PUT
            recs = np.where(is_put,
                            cfg.key_bytes + vsizes + cfg.wal_rec_overhead,
                            cfg.key_bytes
                            + cfg.wal_rec_overhead).astype(np.int64)
            total = int(recs.sum())
            seqs = np.uint64(self.seq + 1) + np.arange(n, dtype=np.uint64)
            self.seq += n
            if is_put.any():
                # keep future mints ahead of every preserved vid so an
                # ingested record and a later local write never collide on
                # the same (key, vid)
                self.next_vid = max(self.next_vid,
                                    int(vids[is_put].max()) + 1)
            self.io.seq_write(total, sio.CAT_WAL)
            self.obs.instant(self, "ingest_append", nbytes=total, n=n)
            ety = np.where(is_put, ETYPE_INLINE, ETYPE_TOMB).astype(np.uint8)
            vsz = np.where(is_put, vsizes, 0).astype(np.int64)
            use_vids = np.where(is_put, vids, 0).astype(np.uint64)
            vf = np.full(n, -1, np.int64)
            entry_bytes = self.memtable.entry_bytes_batch(ety, vsz)
            self.in_batch_write = True
            try:
                i = 0
                while i < n:
                    i += self.memtable.put_batch(keys[i:], seqs[i:], ety[i:],
                                                 use_vids[i:], vsz[i:],
                                                 vf[i:], entry_bytes[i:])
                    if self.memtable.full and i < n:
                        self.immutables.append(self.memtable)
                        self.memtable = Memtable(cfg)
                        self.pump()
                        self._stall_while(
                            lambda: len(self.immutables) > cfg.max_immutables,
                            trigger="memtable_stall")
            finally:
                self.in_batch_write = False
            self.latest.apply_batch(is_put, keys, use_vids, vsz)
            self.strategy.observe_batch(self, "write", keys, vsz)
            self._after_write(total)
        self.obs.on_op(self, "ingest_batch_n", n)
        self.obs.on_op(self, "ingest_batch_bytes", total)
        self.obs.tick(self)

    # -------------------------------------------------------- batched reads
    def multi_get(self, keys: np.ndarray) -> dict:
        """Columnar point lookups for a whole key array.

        Pushes the batch through the vectorized ``lookup_entries`` path and
        coalesces vSST record fetches into adjacent runs (the lazy-read GC's
        run-coalescing, §III-B.1); the batch issues at NVMe queue depth
        ``min(len(keys), fg_qd_max)``, amortizing per-op latency floors.
        Returns parallel arrays: ``found`` bool, ``vid``/``vsize`` (0 where
        not found), ``etype``."""
        keys = np.atleast_1d(np.asarray(keys, np.uint64))
        n = len(keys)
        if self.durability is not None:
            # reads are journaled too: under the two-lane clock they move
            # background scheduling, so byte-identical recovery must replay
            # them (DESIGN.md §9)
            self.wal_index += 1
            self.durability.log_reads(self.wal_index, keys)
        self.n_user_ops += n
        with self.obs.span(self, "multi_get", n=n), self.io.batched(n):
            res = self.lookup_entries(keys, sio.CAT_FG_READ)
            live = res["found"] & (res["etype"] != ETYPE_TOMB)
            refs = np.nonzero(live & (res["etype"] == ETYPE_REF))[0]
            if len(refs):
                self._read_values_batch(keys[refs], res["vid"][refs],
                                        res["vfile"][refs],
                                        res["vsize"][refs], sio.CAT_FG_READ,
                                        strict=True)
        self.strategy.observe_batch(self, "read", keys)
        self.pump()
        self.obs.on_op(self, "get_batch_n", n)
        self.obs.tick(self)
        return {"found": live,
                "vid": np.where(live, res["vid"], 0).astype(np.uint64),
                "vsize": np.where(live, res["vsize"], 0),
                "etype": res["etype"]}

    def multi_scan(self, starts: np.ndarray, count) -> list:
        """Batched range queries: one result list of (key, vid) pairs per
        start key, each up to ``count`` entries (scalar or per-start
        array).  Scans share one deep-queue I/O window, so block fetches
        amortize across the batch."""
        starts = np.atleast_1d(np.asarray(starts)).astype(np.int64)
        counts = np.broadcast_to(np.asarray(count, np.int64),
                                 starts.shape)
        if self.durability is not None:
            self.wal_index += 1
            self.durability.log_scans(self.wal_index, starts, counts)
        self.n_user_ops += len(starts)
        out = []
        with self.obs.span(self, "multi_scan", n=len(starts)), \
                self.io.batched(len(starts)):
            for s, c in zip(starts.tolist(), counts.tolist()):
                out.append(rscan.scan_retry(self, int(s), int(c)))
        self.pump()
        self.obs.tick(self)
        return out

    # ===================================================== background lanes
    def next_compact_job(self):
        """Work-finder for the flush/compaction pool (16 threads)."""
        if self.immutables:
            return ("flush",)
        pick = comp.pick_compaction(self)
        if pick is not None:
            return ("compact", pick)
        return None

    def next_gc_job(self):
        """Work-finder for the dedicated GC pool (1-2 threads — Titan/
        TerarkDB defaults; GC lags ingest, which is the source of the
        paper's space-amplification backlog)."""
        if not self.strategy.wants_standalone_gc():
            return None
        if self.in_batch_write:
            # A WriteBatch applies atomically over one preassigned seq
            # range; GC (whose Titan writebacks mint fresh seqs) must not
            # interleave with it or a written-back locator could outrank a
            # not-yet-inserted batch record.  GC resumes at batch end.
            return None
        cands = gcmod.gc_candidates(self, self._gc_threshold())
        if cands:
            return ("gc", gcmod.gc_batch(self, cands))
        return None

    def _job_pick(self, kind: str) -> str:
        """Policy decision that selects work of this kind (ledger §13)."""
        if kind == "flush":
            return "memtable_rotation"
        if kind == "compact":
            return ("compensated_size" if self.cfg.compensated_compaction
                    else "physical_size")
        return ("adaptive_dead_byte" if self.cfg.adaptive_enabled
                else "garbage_ratio")

    def run_job(self, job, lane: str, trigger: str = "lane_budget",
                policy: str | None = None) -> None:
        prev_lane = self.io.lane
        self.io.lane = lane
        cause = {"trigger": trigger, "pick": self._job_pick(job[0])}
        if policy is not None:
            cause["policy"] = policy
        try:
            # span on the job's lane: an injected CrashPoint still records
            # the partial span (the with-block exits), keeping lane tiling
            with self.obs.span(self, job[0], lane=lane, cause=cause):
                if job[0] == "flush":
                    self._flush_job()
                elif job[0] == "compact":
                    comp.run_compaction(self, *job[1])
                else:
                    gcmod.run_gc(self, job[1])
        finally:
            self.io.lane = prev_lane

    def pump(self) -> None:
        """Run background jobs that fit before the foreground clock."""
        if self.scheduler is not None:
            self.scheduler.pump()
            return
        while self.io.bg_clock_us < self.io.fg_clock_us:
            job = self.next_compact_job()
            if job is None:
                break
            self.run_job(job, "bg", trigger="lane_budget")
        while self.io.gc_clock_us < self.io.fg_clock_us:
            job = self.next_gc_job()
            if job is None:
                break
            self.run_job(job, "gc", trigger="lane_budget")

    def _stall_while(self, cond, prefer_gc: bool = False,
                     trigger: str = "write_stall") -> None:
        """Foreground blocked on background progress."""
        t0 = self.io.fg_clock_us
        while cond():
            if prefer_gc:
                job, lane = self.next_gc_job(), "gc"
                if job is None:
                    job, lane = self.next_compact_job(), "bg"
            else:
                job, lane = self.next_compact_job(), "bg"
                if job is None:
                    job, lane = self.next_gc_job(), "gc"
            if job is None:
                break
            t_lane = self.io.lanes[lane]
            self.io.lanes[lane] = max(t_lane, self.io.fg_clock_us)
            # the bg/gc jump is outside any job span — record it so the
            # lane track still tiles; the fg jump below is inside the
            # caller's write span, which already covers it (§11)
            self.obs.lane_sync(self, lane, t_lane)
            self.run_job(job, lane, trigger=trigger)
            self.io.lanes["fg"] = max(self.io.fg_clock_us,
                                      self.io.lanes[lane])
        stalled = self.io.fg_clock_us - t0
        self.stall_us += stalled
        self.obs.on_stall(self, stalled, "write_stall")

    def settle(self) -> None:
        """Let background catch up to the foreground clock (no fg time)."""
        self.pump()

    def drain(self) -> None:
        """Run ALL pending background work and synchronize lanes."""
        while True:
            job = self.next_compact_job()
            lane = "bg"
            if job is None:
                job, lane = self.next_gc_job(), "gc"
            if job is None:
                break
            self.run_job(job, lane, trigger="drain")
        m = max(self.io.lanes.values())
        for k in self.io.lanes:
            t0 = self.io.lanes[k]
            self.io.lanes[k] = m
            self.obs.lane_sync(self, k, t0)

    # ========================================= durability (DESIGN.md §9)
    def checkpoint(self, path=None):
        """Write a full-state snapshot.

        With a durable store (``durability_dir``) and no ``path``: snapshot
        into the store directory, roll the WAL, and record the checkpoint
        in the MANIFEST.  With ``path``: write a standalone snapshot file
        (restorable via ``Store.open(path)``), usable without a durable
        directory."""
        if path is not None:
            from .durability import snapshot as dsnap
            self.obs.instant(self, "checkpoint", path=str(path))
            return dsnap.write_snapshot(self, path)
        if self.durability is None:
            raise ValueError("store has no durability directory; pass a "
                             "snapshot path or open with durability_dir")
        self.obs.instant(self, "checkpoint", seq=int(self.seq))
        return self.durability.checkpoint(self)

    @classmethod
    def open(cls, path, io: SimIO | None = None, observer=None, *,
             device=None) -> "Store":
        """Recover a store: restore the latest checkpoint snapshot, then
        replay the WAL tail through the columnar write path (``path`` may
        also be a bare snapshot file — restore only).  The recovered store
        runs on ``device``: CUDA unless the caller names one, raising
        without it, as ``Store(...)`` does.  The directory may have been
        written by either package."""
        if observer is not None:
            raise NotImplementedError("recording observers are not ported "
                                      "yet; leave observer None")
        from .durability import recover_store
        return recover_store(path, io=io, cls=cls, device=device)

    def close(self) -> None:
        """Flush and close durable logs (no-op for in-memory stores)."""
        if self.durability is not None:
            self.durability.close()

    def _log_edit(self, kind: str, **data) -> None:
        """Append a MANIFEST VersionEdit (no-op when durability is off).

        The host-side byte cost of the edit is reported to the observer
        (ledger §13: MANIFEST bytes decompose by cause like device bytes)."""
        if self.durability is not None:
            before = self.durability.manifest.bytes_written
            self.durability.log_edit(kind, **data)
            self.obs.on_edit(self, kind,
                             self.durability.manifest.bytes_written - before)

    def arm_crash(self, point: str, hits: int = 1) -> None:
        """Crash-injection: raise ``CrashPoint`` at the ``hits``-th pass
        through the named hook (see ``durability.CRASH_POINTS``; the four
        fleet points fire only in a ``ShardedStore``)."""
        from .durability import CRASH_POINTS
        if point not in CRASH_POINTS:
            raise ValueError(f"unknown crash point {point!r} "
                             f"(want one of {CRASH_POINTS})")
        if self._crash_hooks is None:
            self._crash_hooks = {}
        self._crash_hooks[point] = int(hits)

    def _crashpoint(self, point: str) -> None:
        hooks = self._crash_hooks
        if hooks is None:
            return
        left = hooks.get(point)
        if left is None:
            return
        if left <= 1:
            del hooks[point]            # disarm: the process died here once
            from .durability import CrashPoint
            raise CrashPoint(point)
        hooks[point] = left - 1

    # ------------------------------------------------------ write pressure
    def _after_write(self, rec_bytes: int) -> None:
        cfg = self.cfg
        if self.memtable.full:
            self.immutables.append(self.memtable)
            self.memtable = Memtable(cfg)
        self.pump()
        self._stall_while(lambda: len(self.immutables) > cfg.max_immutables,
                          trigger="memtable_stall")
        self._stall_while(
            lambda: len(self.version.levels[0]) >= cfg.l0_stop,
            trigger="l0_stop")
        if len(self.version.levels[0]) >= cfg.l0_slowdown:
            delay = rec_bytes / cfg.delayed_write_rate   # us at MB/s
            self.io.stall(delay)
            self.stall_us += delay
            self.obs.on_stall(self, delay, "delayed_write")
            self.pump()

    def _write_pressure(self) -> None:
        """Space-aware throttling (paper §III-D)."""
        cfg = self.cfg
        if cfg.space_quota_bytes is None:
            return
        space = self.version.total_bytes()
        soft = cfg.soft_quota_frac * cfg.space_quota_bytes
        if space < soft:
            return
        if space >= cfg.space_quota_bytes:
            seen = 0

            def over():
                nonlocal seen
                seen += 1
                return (seen < cfg.quota_stall_rounds
                        and self.version.total_bytes()
                        >= cfg.space_quota_bytes)
            self._stall_while(over, prefer_gc=True, trigger="quota_stall")
        else:
            self.io.stall(cfg.slowdown_us_per_write)
            self.stall_us += cfg.slowdown_us_per_write
            self.obs.on_stall(self, cfg.slowdown_us_per_write,
                              "quota_slowdown")
            self.pump()

    def _gc_threshold(self) -> float:
        cfg = self.cfg
        if cfg.space_quota_bytes is None:
            return cfg.gc_garbage_ratio
        space = self.version.total_bytes()
        if space >= cfg.soft_quota_frac * cfg.space_quota_bytes:
            return cfg.gc_aggressive_ratio
        return cfg.gc_garbage_ratio

    # ================================================================ flush
    def _flush_job(self) -> None:
        if not self.immutables:
            return
        mt = self.immutables.pop(0)
        cfg = self.cfg
        keys, seqs, ety, vids, vsz, vf = mt.sorted_arrays()
        sep = self.strategy.separation_mask(self, keys, ety, vsz)
        if sep is not None and sep.any():
            idx = np.nonzero(sep)[0]
            _, fids = self.build_value_files(keys[idx], vids[idx],
                                             vsz[idx], sio.CAT_FLUSH)
            ety = ety.copy()
            vf = vf.copy()
            ety[idx] = ETYPE_REF
            vf[idx] = fids
        t = SSTable(cfg, "k", cfg.ksst_layout, keys, seqs, ety, vids, vsz, vf)
        t.compensated_extra = int(vsz[ety == ETYPE_REF].sum())
        self.io.seq_write(t.file_bytes, sio.CAT_FLUSH)
        self._crashpoint("mid_flush")   # vSSTs cut, kSST not yet live
        self.version.add_l0(t)
        self._log_edit("add_file", fid=t.fid, level=0, nbytes=t.file_bytes)

    def rotate_memtable(self) -> None:
        """Force the active memtable immutable (no background work)."""
        if len(self.memtable):
            self.immutables.append(self.memtable)
            self.memtable = Memtable(self.cfg)

    def flush(self) -> None:
        """Force-rotate the memtable and drain all background work."""
        if self.durability is not None:
            self.wal_index += 1
            self.durability.log_flush(self.wal_index)
        self.rotate_memtable()
        self.drain()

    # ======================================================= lookup machinery
    def lookup_entries(self, keys: np.ndarray, cat: str) -> dict:
        """Vectorized newest-wins point lookup (read layer)."""
        return rlookup.lookup_entries(self, keys, cat)

    def _read_entry_blocks(self, t: SSTable, pos: np.ndarray,
                           ety: np.ndarray, cat: str) -> None:
        rlookup.read_entry_blocks(self, t, pos, ety, cat)

    def read_block(self, t: SSTable, stream: str, block_id: int, cat: str,
                   priority: int, nbytes: int | None = None) -> None:
        rlookup.read_block(self, t, stream, block_id, cat, priority, nbytes)

    # ========================================================== value store
    def resolve_value_file(self, fid: int, key: int,
                           vid: int) -> SSTable | None:
        """Follow GC inheritance chains to the live file holding (key, vid)."""
        return vresolve.resolve_value_file(self, fid, key, vid)

    def _read_values_batch(self, keys, vids, vfiles, vsizes, cat,
                           strict: bool = False) -> None:
        vfetch.read_values_batch(self, keys, vids, vfiles, vsizes, cat,
                                 strict=strict)

    def build_value_files(self, keys, vids, vsizes, cat: str):
        """Build vSST(s) from sorted records (values layer).

        Returns (files, fid_per_record)."""
        return vbuild.build_value_files(self, keys, vids, vsizes, cat)

    # ===================================================== garbage exposure
    def expose_garbage(self, keys, ety, vids, vsizes, vfiles) -> None:
        """Entries dropped during compaction expose value-store garbage
        (Hidden -> Exposed, paper §II-D)."""
        vgarbage.expose_garbage(self, keys, ety, vids, vsizes, vfiles)

    # ============================================================ writeback
    def writeback_index(self, key: int, vid: int, vsize: int,
                        vfile: int) -> None:
        """Titan Write-Index for one locator (shim over the batched path)."""
        self.writeback_index_batch(np.array([key], np.uint64),
                                   np.array([vid], np.uint64),
                                   np.array([vsize], np.int64),
                                   np.array([vfile], np.int64))

    def writeback_index_batch(self, keys, vids, vsizes, vfiles) -> None:
        """Titan Write-Index: new locators through the foreground write
        path, group-committed as one WriteBatch (Titan batches its GC index
        rewrites internally).

        The WAL append is batched, but each writeback still pays the
        per-record commit-queue cost competing with foreground writes —
        this unamortized step is why the paper measures ~38% of Titan's GC
        latency in Write-Index."""
        n = len(keys)
        if n == 0:
            return
        rec = self.cfg.ref_rec_bytes()
        seqs = np.uint64(self.seq + 1) + np.arange(n, dtype=np.uint64)
        self.seq += n
        self.io.seq_write(n * rec, sio.CAT_GC_WRITE_INDEX)
        self.io.stall(n * self.io.device.seq_op_us, sio.CAT_GC_WRITE_INDEX)
        keys = np.asarray(keys, np.uint64)
        ety = np.full(n, ETYPE_REF, np.uint8)
        vids = np.asarray(vids, np.uint64)
        vsz = np.asarray(vsizes, np.int64)
        vf = np.asarray(vfiles, np.int64)
        i = 0
        while i < n:
            i += self.memtable.put_batch(keys[i:], seqs[i:], ety[i:],
                                         vids[i:], vsz[i:], vf[i:])
            if self.memtable.full:
                self.immutables.append(self.memtable)
                self.memtable = Memtable(self.cfg)

    # ================================================================ stats
    def space_bytes(self) -> int:
        return self.version.total_bytes()

    def space_amplification(self) -> float:
        return self.space_bytes() / max(self.valid_bytes, 1)

    def s_index(self) -> float:
        """Space amp of the index LSM-tree: total kSST / last-level kSST."""
        last = self.version.last_nonempty_level()
        lb = self.version.level_bytes(last)
        tot = self.version.ksst_total_bytes()
        return tot / max(lb, 1)

    def exposed_over_valid(self) -> float:
        ref_valid = max(self.valid_value_bytes(), 1)
        return self.version.value_garbage_bytes() / ref_valid

    def valid_value_bytes(self) -> int:
        """Bytes of live (non-garbage) data in the value store."""
        return sum(t.total_value_bytes - t.garbage_bytes
                   for t in self.version.value_files.values())

    def hidden_garbage_bytes(self) -> int:
        """Value bytes referenced by stale index entries whose records are
        still physically present (not yet exposed/reclaimed) — the paper's
        G_H.  Uses the stats oracle ``latest`` — measurement only, never an
        engine decision input.  Vectorized: one oracle lookup + one chain
        resolution for the whole REF column."""
        cols = [(t.keys[m], t.vids[m], t.vsizes[m], t.vfiles[m])
                for t in self.version.all_kssts()
                if (m := (t.etype == ETYPE_REF)).any()]
        if not cols:
            return 0
        keys = np.concatenate([c[0] for c in cols])
        vids = np.concatenate([c[1] for c in cols])
        vsz = np.concatenate([c[2] for c in cols])
        vf = np.concatenate([c[3] for c in cols])
        found, lvids, _ = self.latest.lookup_batch(keys)
        stale = ~(found & (lvids == vids))      # live version is not garbage
        if not stale.any():
            return 0
        keys, vids, vsz, vf = keys[stale], vids[stale], vsz[stale], vf[stale]
        # de-duplicate (key, vid), keeping the FIRST occurrence in table
        # order (a Titan writeback can leave two locators for one record;
        # the scalar walk resolved whichever it met first)
        order = np.lexsort((np.arange(len(keys)), vids, keys))
        k, v = keys[order], vids[order]
        first = np.ones(len(k), bool)
        first[1:] = (k[1:] != k[:-1]) | (v[1:] != v[:-1])
        rows = np.sort(order[first])
        heads = vresolve.resolve_value_fids(self, vf[rows], keys[rows],
                                            vids[rows])
        return int(vsz[rows][heads >= 0].sum())

    def stats(self) -> dict:
        wal = self.io.write_bytes.get(sio.CAT_WAL, 0)
        return {
            "engine": self.cfg.engine,
            "clock_s": self.io.clock_us / 1e6,
            "space_bytes": self.space_bytes(),
            "valid_bytes": self.valid_bytes,
            "user_write_bytes": self.user_write_bytes,
            "space_amp": self.space_amplification(),
            "s_index": self.s_index(),
            "exposed_over_valid": self.exposed_over_valid(),
            "write_amp": (self.io.total_write_bytes() - wal)
            / max(self.user_write_bytes, 1),
            "read_bytes": self.io.total_read_bytes(),
            "write_bytes": self.io.total_write_bytes(),
            "n_compactions": self.n_compactions,
            "n_gc_runs": self.n_gc_runs,
            "cache_hit_ratio": self.cache.hit_ratio(),
            "stall_s": self.stall_us / 1e6,
            "gc_time_s": self.io.gc_time_us() / 1e6,
        }
