"""ShardedStore (port of ``repro.core.sharding.store``): N independent
Store shards behind one batched Store API (DESIGN.md §6), with live
elasticity — online shard split/merge, N-way replication, and primary
failover (DESIGN.md §14).

The keyspace is partitioned across shards by a router (hash or range,
``router.py``); the PR-1 batched API (``write`` / ``multi_get`` /
``multi_scan``) is routed by one vectorized scatter-by-shard pass and
results are reassembled in original batch order.  Background GC/compaction
service is *not* per-shard: every shard's ``pump()`` delegates to one
``FleetScheduler`` (``fleet.py``) that ranks pending jobs fleet-wide under
shared lane and space budgets.

Semantics:

  * A ``WriteBatch`` splits into per-shard sub-batches, each applied
    atomically by its shard (one seq range / WAL append per shard touched).
    Records of the same key always land on the same shard, so last-write-
    wins inside a batch is preserved.
  * ``multi_scan`` is exact under the range policy (owning shard, spilling
    into successor *slices* in cut order until ``count`` is filled); under
    the hash policy keys interleave across shards, so each scan fans out to
    every shard and merges — correct but N-fold the I/O (this is why range
    is the policy for scan-heavy workloads).
  * ``n_shards=1`` is byte-identical to a plain ``Store`` — same clocks,
    stats, and scheduling decisions (asserted by the reference's
    ``tests/test_sharding.py`` on all engines, replayed on this
    package).  Elasticity off keeps every fleet byte-identical to the
    pre-elastic ShardedStore.

Elasticity (§14): an ``ElasticityManager`` (``migrate.py``) gets one step
per fleet op — always *between* shard sub-batches, never inside one — so
router-epoch bumps only happen at dispatch boundaries.  Dispatch is
epoch-stamped: each write/read worklist snapshots ``router.epoch``, and a
bump observed mid-batch re-routes the not-yet-applied rows
(``redispatches`` counts these).  All shard-level ops flow through the
``_shard_*`` wrappers, which also feed each primary's replication log
(``replica.py``) so ``fail_primary`` can promote a caught-up replica.

Stats aggregate across shards: sums for byte/op counters (including
merge-retired shards, whose history remains part of the fleet's), ratios
recomputed from fleet-wide numerators/denominators, ``clock_s`` as the max
shard clock (shards run concurrently).

Device: every ``Store`` the fleet makes — its shards, split destinations,
replicas, the replica ``fail_primary`` promotes and the shards ``open``
restores — runs on the fleet's ``device``, CUDA unless the caller names
another (raising without one, as ``Store`` does), so each shard's batched
probes run the CUDA kernels (``core/accel.py``).  Recording observers are
not ported: the fleet runs with the null observer, as its shards do.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import accel
from ..batch import ScalarOps, WriteBatch
from ..engine.config import EngineConfig
from ..engine.tables import ETYPE_NONE
from ..store import Store
from .fleet import FleetScheduler
from .migrate import ElasticityManager
from .replica import ShardReplicator
from .router import HashRouter, make_router, restore_router, scatter


class FleetClock:
    """Read-only SimIO facade over the shard SimIOs (Runner/benchmark
    contract): clocks are the slowest shard's (shards run concurrently);
    byte/op/time counters sum across shards."""

    def __init__(self, shards):
        self._shards = shards

    @property
    def clock_us(self) -> float:
        return max(s.io.clock_us for s in self._shards)

    @property
    def fg_clock_us(self) -> float:
        return max(s.io.fg_clock_us for s in self._shards)

    def _summed(self, field: str) -> dict:
        out: dict = {}
        for s in self._shards:
            for k, v in getattr(s.io, field).items():
                out[k] = out.get(k, 0) + v
        return out

    @property
    def time_us(self) -> dict:
        return self._summed("time_us")

    @property
    def read_bytes(self) -> dict:
        return self._summed("read_bytes")

    @property
    def write_bytes(self) -> dict:
        return self._summed("write_bytes")

    @property
    def read_ops(self) -> dict:
        return self._summed("read_ops")

    @property
    def write_ops(self) -> dict:
        return self._summed("write_ops")

    def total_read_bytes(self) -> int:
        return sum(s.io.total_read_bytes() for s in self._shards)

    def total_write_bytes(self) -> int:
        return sum(s.io.total_write_bytes() for s in self._shards)

    def gc_time_us(self) -> float:
        return sum(s.io.gc_time_us() for s in self._shards)


class ShardedStore(ScalarOps):
    def __init__(self, cfg: EngineConfig, n_shards: int = 1,
                 shard_policy: str = "range", key_space: int | None = None,
                 scheduler: str = "fleet", aging_rate: float = 0.05,
                 durability_dir=None, *, device=None):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        # CUDA unless the caller names a device; raises without one
        self.device = accel.resolve_device(device)
        self.cfg = cfg
        self.n_shards = int(n_shards)
        self.shard_policy = shard_policy
        self.key_space = key_space
        self.scheduler_policy = scheduler
        self.aging_rate = float(aging_rate)
        # fleet-wide space quota: shards run quota-free, the fleet enforces
        # the shared budget (single-shard stores keep Store's own path so
        # n_shards=1 stays byte-identical to Store)
        fleet_quota = None
        shard_cfg = cfg
        if self.n_shards > 1 and cfg.space_quota_bytes is not None:
            fleet_quota = cfg.space_quota_bytes
            shard_cfg = dataclasses.replace(cfg, space_quota_bytes=None)
        self._shard_cfg = shard_cfg
        self.shards = [Store(dataclasses.replace(shard_cfg),
                             device=self.device)
                       for _ in range(self.n_shards)]
        # stable identity per shard machine (durability dir, replication
        # log, migration edits): survives position shifts from merges
        self.next_shard_id = self.n_shards
        for i, s in enumerate(self.shards):
            s.shard_id = i
        # merge-retired shards: out of routing/scheduling, kept for fleet
        # counter continuity (their history happened on this fleet)
        self.retired: list[Store] = []
        self._all_shards = list(self.shards)    # live + retired, for io
        elastic_on = (cfg.elastic_split_frac is not None
                      or cfg.elastic_merge_frac > 0)
        if self.n_shards == 1 and key_space is None and not elastic_on:
            self.router = HashRouter(1)
        else:
            self.router = make_router(shard_policy, self.n_shards,
                                      key_space)
        self.fleet = FleetScheduler(
            self.shards, policy=scheduler, aging_rate=aging_rate,
            space_quota_bytes=fleet_quota,
            soft_quota_frac=cfg.soft_quota_frac)
        self.io = FleetClock(self._all_shards)
        # Fleet-level observability hook (DESIGN.md §11): shares the shards'
        # observer (same ref after dataclasses.replace) but is NOT registered
        # as a store — FleetClock has no lanes to tile; per-shard spans carry
        # the timing, the fleet only emits fleet-scoped op metrics.
        self.obs = self.shards[0].obs
        self.obs_label = "fleet"
        # Elasticity bookkeeping (§14)
        self.migrations: list[dict] = []
        self.redispatches = 0
        self._crash_hooks: dict | None = None
        # Fleet durability (DESIGN.md §9): one fleet-level op journal (the
        # scheduler is fleet-wide, so replay must re-route batches through
        # the fleet, not per shard) + one manifest/snapshot dir per shard.
        self.durability = None
        self.wal_index = 0
        if durability_dir is not None:
            from ..durability import Durability
            from pathlib import Path
            root = Path(durability_dir)
            self.durability = Durability.create(
                root, cfg, wal=True,
                meta={"fleet": {"n_shards": self.n_shards,
                                "shard_policy": shard_policy,
                                "key_space": key_space,
                                "scheduler": scheduler,
                                "aging_rate": aging_rate}})
            for s in self.shards:
                s.durability = Durability.create(
                    root / f"shard-{s.shard_id:02d}", s.cfg, wal=False)
        # N-way replication (§14): one replicator per live primary
        self.replicators: dict[int, ShardReplicator] = {}
        if cfg.replica_count > 0:
            for s in self.shards:
                self.replicators[s.shard_id] = self._make_replicator(s)
        self.elastic = ElasticityManager(self)

    def _make_replicator(self, shard) -> ShardReplicator:
        root = self.durability.root if self.durability is not None else None
        epoch = self.durability.epoch if self.durability is not None else 0
        return ShardReplicator(
            shard.cfg, self.cfg.replica_count, self.cfg.replica_lag_ops,
            durability_root=root, shard_id=shard.shard_id, wal_epoch=epoch,
            device=self.device)

    # ================================================================== API
    # (scalar put/get/delete/scan come from the shared ScalarOps shims)

    # ------------------------------------------------- shard-op dispatchers
    # Every op a primary shard runs flows through these wrappers: they feed
    # the shard's replication log, give the elasticity manager its write
    # mirror + traffic signal, and are the units the epoch-stamped dispatch
    # loops retry (§14).
    def _rep(self, pos: int) -> ShardReplicator | None:
        if not self.replicators:
            return None
        return self.replicators.get(self.shards[pos].shard_id)

    def _shard_write(self, pos, kinds, keys, vsizes) -> np.ndarray:
        vids = self.shards[pos]._write_arrays(kinds, keys, vsizes)
        rep = self._rep(pos)
        if rep is not None:
            rep.log_batch(kinds, keys, vsizes)
            rep.poll()
        if self.elastic is not None:
            self.elastic.note_write(pos, kinds, keys, vids, vsizes)
            self.elastic.note_traffic(pos, len(keys))
        return vids

    def _shard_ingest(self, pos, kinds, keys, vids, vsizes) -> None:
        self.shards[pos].ingest_batch(kinds, keys, vids, vsizes)
        rep = self._rep(pos)
        if rep is not None:
            rep.log_ingest(kinds, keys, vids, vsizes)
            rep.poll()

    def _shard_get(self, pos, keys) -> dict:
        res = self.shards[pos].multi_get(keys)
        rep = self._rep(pos)
        if rep is not None:
            rep.log_reads(keys)
            rep.poll()
        if self.elastic is not None:
            self.elastic.note_traffic(pos, len(keys))
        return res

    def _shard_scan(self, pos, starts, counts) -> list:
        res = self.shards[pos].multi_scan(starts, counts)
        rep = self._rep(pos)
        if rep is not None:
            rep.log_scans(starts, counts)
            rep.poll()
        if self.elastic is not None:
            self.elastic.note_traffic(pos, len(starts))
        return res

    def _elastic_tick(self) -> None:
        """One elastic step per fleet op, taken *before* routing so a
        resulting epoch bump can never strand an in-flight sub-batch; inert
        (a no-op branch) when elasticity is off."""
        if self.elastic is not None:
            self.elastic.step()

    # ------------------------------------------------------- batched writes
    def write(self, batch: WriteBatch) -> np.ndarray:
        kinds, keys, vsizes = batch.arrays()
        return self._write_arrays(kinds, keys, vsizes)

    def _write_arrays(self, kinds, keys, vsizes) -> np.ndarray:
        n = len(keys)
        if n == 0:
            return np.zeros(0, np.uint64)
        if self.durability is not None:
            # fleet journal: replay re-routes through the fleet so the
            # scheduler sees the same global op stream (DESIGN.md §9).
            # seq_base is 0: sequence numbers are per-shard, the fleet has
            # no single seq domain (replay keys off the op index alone)
            self.wal_index += 1
            self.durability.log_batch(self.wal_index, 0,
                                      kinds, keys, vsizes)
        self._elastic_tick()
        self._fleet_write_pressure()
        if len(self.shards) == 1:
            return self._shard_write(0, kinds, keys, vsizes)
        vids_out = np.zeros(n, np.uint64)
        pending = np.arange(n)
        while len(pending):
            # epoch-stamped dispatch: route against one router snapshot; a
            # bump observed mid-batch (migration finalized under our feet)
            # invalidates the remaining sub-batches, which re-route (§14)
            e0 = self.router.epoch
            sid = self.router.shard_of(keys[pending])
            order, starts, ends = scatter(sid, len(self.shards))
            done = np.zeros(len(pending), bool)
            for s in range(len(self.shards)):
                rows = order[starts[s]:ends[s]]
                if len(rows) == 0:
                    continue
                idx = pending[rows]
                vids_out[idx] = self._shard_write(
                    s, kinds[idx], keys[idx], vsizes[idx])
                done[rows] = True
                if self.router.epoch != e0:
                    break
            pending = pending[~done]
            if len(pending):
                self.redispatches += 1
        return vids_out

    def _fleet_write_pressure(self) -> None:
        """Space-aware throttling against the shared fleet quota (the
        fleet analogue of ``Store._write_pressure``)."""
        quota = self.fleet.space_quota_bytes
        if quota is None:
            return
        space = self.fleet.space_bytes()
        if space < self.fleet.soft_quota_frac * quota:
            return
        if space >= quota:
            # writers stall while the globally best GC jobs force-run; the
            # foreground time each job adds (run_one syncs the owning
            # shard's lanes to its fg clock) is charged as stall, matching
            # Store._stall_while's accounting
            before = [s.io.fg_clock_us for s in self.shards]
            for _ in range(self.shards[0].cfg.quota_stall_rounds):
                if self.fleet.space_bytes() < quota:
                    break
                if not self.fleet.run_one(prefer_gc=True):
                    break
            for s, b in zip(self.shards, before):
                stalled = s.io.fg_clock_us - b
                s.stall_us += stalled
                s.obs.on_stall(s, stalled, "write_stall")
        else:
            # one slowdown per write call (Store semantics), charged to the
            # shard holding the fleet wall clock so aggregate stall_s stays
            # comparable between --shards 1 and --shards N runs
            s = max(self.shards, key=lambda s: s.io.fg_clock_us)
            with s.obs.span(s, "quota_slowdown",
                            cause={"trigger": "quota_stall"}):
                s.io.stall(s.cfg.slowdown_us_per_write)
            s.stall_us += s.cfg.slowdown_us_per_write
            s.obs.on_stall(s, s.cfg.slowdown_us_per_write, "quota_slowdown")
            self.fleet.pump()

    # -------------------------------------------------------- batched reads
    def multi_get(self, keys: np.ndarray) -> dict:
        keys = np.atleast_1d(np.asarray(keys, np.uint64))
        if self.durability is not None:
            self.wal_index += 1
            self.durability.log_reads(self.wal_index, keys)
        self._elastic_tick()
        if len(self.shards) == 1:
            return self._shard_get(0, keys)
        n = len(keys)
        out = {"found": np.zeros(n, bool),
               "vid": np.zeros(n, np.uint64),
               "vsize": np.zeros(n, np.int64),
               "etype": np.full(n, ETYPE_NONE, np.uint8)}
        pending = np.arange(n)
        while len(pending):
            e0 = self.router.epoch
            sid = self.router.shard_of(keys[pending])
            order, starts, ends = scatter(sid, len(self.shards))
            done = np.zeros(len(pending), bool)
            for s in range(len(self.shards)):
                rows = order[starts[s]:ends[s]]
                if len(rows) == 0:
                    continue
                idx = pending[rows]
                res = self._shard_get(s, keys[idx])
                for f in out:
                    out[f][idx] = res[f]
                done[rows] = True
                if self.router.epoch != e0:
                    break
            pending = pending[~done]
            if len(pending):
                self.redispatches += 1
        return out

    def multi_scan(self, starts: np.ndarray, count) -> list:
        starts = np.atleast_1d(np.asarray(starts)).astype(np.int64)
        counts = np.broadcast_to(np.asarray(count, np.int64), starts.shape)
        if self.durability is not None:
            self.wal_index += 1
            self.durability.log_scans(self.wal_index, starts, counts)
        self._elastic_tick()
        while True:
            e0 = self.router.epoch
            if len(self.shards) == 1:
                out = self._shard_scan(0, starts, counts)
            elif self.router.policy == "hash":
                out = self._multi_scan_fanout(starts, counts)
            else:
                out = self._multi_scan_range(starts, counts)
            if self.router.epoch == e0:
                return out
            # a migration finalized mid-scan: the slice walk below may have
            # consulted a stale topology — re-run the whole (idempotent)
            # scan against the new epoch
            self.redispatches += 1

    def _multi_scan_fanout(self, starts, counts) -> list:
        """Hash policy: keys interleave across shards, so every scan asks
        every shard and merges (keys are disjoint across shards, so the
        merge is a sort-by-key concat truncated to count)."""
        per_shard = [self._shard_scan(s, starts, counts)
                     for s in range(len(self.shards))]
        out = []
        for i, c in enumerate(counts.tolist()):
            merged = sorted(
                (pair for res in per_shard for pair in res[i]))
            out.append(merged[:int(c)])
        return out

    def _multi_scan_range(self, starts, counts) -> list:
        """Range policy: scan the owning shard, spill into successor
        *slices* in cut order (every key of a later slice is larger) until
        count is filled.  Spills walk the slice table — not shard indexes,
        which stop tracking key order once a split appends a shard (§14) —
        all still-unfilled scans batched into one multi_scan per successor
        so the deep-queue I/O window is kept."""
        router = self.router
        u_starts = starts.astype(np.uint64)
        sid = router.shard_of(u_starts)
        sl = router.slice_of(u_starts)
        order, s_starts, s_ends = scatter(sid, len(self.shards))
        out: list = [None] * len(starts)
        for s in range(len(self.shards)):
            rows = order[s_starts[s]:s_ends[s]]
            if len(rows) == 0:
                continue
            res = self._shard_scan(s, starts[rows], counts[rows])
            for r, got in zip(rows.tolist(), res):
                out[r] = got
        cnt = counts.tolist()
        for j in range(1, router.n_slices):
            need = [i for i in range(len(starts))
                    if sl[i] < j and len(out[i]) < cnt[i]]
            if not need:
                continue
            rem = np.array([cnt[i] - len(out[i]) for i in need], np.int64)
            more = self._shard_scan(router.owners[j], starts[need], rem)
            for i, got in zip(need, more):
                out[i] = out[i] + got
        return out

    # ===================================================== background lanes
    def pump(self) -> None:
        self.fleet.pump()

    def settle(self) -> None:
        self.fleet.pump()

    def drain(self) -> None:
        """Run all pending work: any in-flight migration completes first
        (a drained fleet has a settled topology), then the fleet drains."""
        if self.elastic is not None:
            self.elastic.quiesce()
        self.fleet.drain()

    def flush(self) -> None:
        """Force-rotate every shard's memtable, then drain the fleet."""
        if self.durability is not None:
            self.wal_index += 1
            self.durability.log_flush(self.wal_index)
        for pos in range(len(self.shards)):
            rep = self._rep(pos)
            if rep is not None:
                rep.log_flush()
                rep.poll()
            self.shards[pos].rotate_memtable()
        self.fleet.drain()

    # ======================================= elastic topology (DESIGN.md §14)
    def _spawn_shard(self) -> int:
        """Create and attach a fresh shard (split destination); returns its
        fleet position."""
        from ..durability import Durability
        s = Store(dataclasses.replace(self._shard_cfg), device=self.device)
        s.shard_id = self.next_shard_id
        self.next_shard_id += 1
        self.shards.append(s)
        self._all_shards.append(s)
        self.fleet.add_shard(s)
        self.n_shards = len(self.shards)
        if self.durability is not None:
            sdir = self.durability.root / f"shard-{s.shard_id:02d}"
            if (sdir / Durability.MANIFEST).exists():
                # journal replay re-derives splits over dirs the pre-crash
                # run already created: re-attach, don't re-create
                s.durability = Durability.attach(sdir, wal=False)
            else:
                s.durability = Durability.create(sdir, s.cfg, wal=False)
        if self.cfg.replica_count > 0:
            self.replicators[s.shard_id] = self._make_replicator(s)
        return len(self.shards) - 1

    def _retire_shard(self, pos: int) -> None:
        """Detach a drained merge victim from routing/scheduling.  The
        Store object stays in the fleet's counter aggregation (its history
        happened here); its durability dir is frozen."""
        victim = self.shards.pop(pos)
        self.retired.append(victim)
        self.fleet.remove_shard(pos)
        self.router.renumber_removed(pos)
        self.n_shards = len(self.shards)
        rep = self.replicators.pop(victim.shard_id, None)
        if rep is not None:
            rep.close()
        victim.scheduler = None
        if victim.durability is not None:
            victim.durability.close()
            victim.durability = None

    def split_shard(self, pos: int, cut: int | None = None) -> int | None:
        """Synchronously split shard ``pos``'s slice at ``cut`` (default:
        median live routing value): checkpoint-copy, re-route, delta-replay
        (§14).  Returns the new shard's position, or None if no valid cut
        exists."""
        if not self.elastic.begin_split(pos, cut):
            return None
        dst = self.elastic.mig.dst_pos
        self.elastic.quiesce()
        return dst

    def merge_shards(self, victim: int, into: int | None = None) -> bool:
        """Synchronously drain shard ``victim`` into the adjacent-slice
        shard ``into`` (default: the emptier neighbor) and retire it."""
        if not self.elastic.begin_merge(victim, into):
            return False
        self.elastic.quiesce()
        return True

    def fail_primary(self, pos: int) -> Store:
        """Kill shard ``pos``'s primary and promote its most-caught-up
        replica: replay the log tail the replica hasn't applied, swap it
        into the fleet (scheduler slot, observer, durability dir), and log
        a ``replica_promote`` edit (§14).  The failed machine's counters
        die with it; the promoted store's history is the replayed op
        stream."""
        prim = self.shards[pos]
        rep = self.replicators.get(prim.shard_id)
        if rep is None or not rep.replicas:
            raise ValueError(f"shard {pos} has no replicas to promote "
                             "(cfg.replica_count)")
        self._crashpoint("pre_promote")
        rank = rep.best()
        applied = rep.applied[rank]
        promoted = rep.promote(rank)
        promoted.shard_id = prim.shard_id
        promoted.scheduler = self.fleet
        self.shards[pos] = promoted
        self.fleet.shards[pos] = promoted
        self._all_shards[self._all_shards.index(prim)] = promoted
        prim.scheduler = None
        promoted.obs = self.obs
        promoted.obs_label = self.obs.register_store(promoted)
        if self.durability is not None:
            from ..durability import Durability
            if prim.durability is not None:
                prim.durability.close()
                prim.durability = None
            promoted.durability = Durability.attach(
                self.durability.root / f"shard-{promoted.shard_id:02d}",
                wal=False)
        self._log_fleet_edit("replica_promote", shard=promoted.shard_id,
                             replica=rank, applied=applied,
                             tail=len(rep.log) - applied)
        self.obs.instant(promoted, "replica_promote",
                         shard=promoted.shard_id, replica=rank)
        return promoted

    # ------------------------------------------------------ crash injection
    def arm_crash(self, point: str, hits: int = 1) -> None:
        """Crash-injection at the fleet-level hooks (migration/failover
        points of ``durability.CRASH_POINTS``, §14)."""
        from ..durability import CRASH_POINTS
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
            from ..durability import CrashPoint
            raise CrashPoint(point)
        hooks[point] = left - 1

    def _log_fleet_edit(self, kind: str, **data) -> None:
        """Append a fleet-MANIFEST VersionEdit, byte cost reported to the
        observer ledger (the fleet analogue of ``Store._log_edit``)."""
        if self.durability is not None:
            before = self.durability.manifest.bytes_written
            self.durability.log_edit(kind, **data)
            self.obs.on_edit(self.shards[0], kind,
                             self.durability.manifest.bytes_written - before)

    # ========================================= durability (DESIGN.md §9)
    def checkpoint(self) -> None:
        """Fleet checkpoint: snapshot every shard, bump the fleet epoch,
        roll the fleet journal, and record scheduler state + watermarks +
        topology (router state, shard ids) in the fleet MANIFEST (per-shard
        manifests record their own checkpoint edits).  An in-flight
        migration is quiesced first — checkpoints only describe settled
        topologies (§14)."""
        if self.durability is None:
            raise ValueError("ShardedStore has no durability directory")
        if self.elastic is not None:
            self.elastic.quiesce()
        # record the exact snapshot files in the fleet edit: a crash
        # between the per-shard snapshots and the fleet edit must not let
        # recovery pair newer shard snapshots with an older fleet
        # watermark (that would double-apply the WAL tail)
        snaps = [s.durability.checkpoint(s).name for s in self.shards]
        self.fleet.epoch += 1
        self.durability.roll_segment()
        self.durability.log_edit(
            "fleet_checkpoint", epoch=self.fleet.epoch,
            wal_epoch=self.durability.epoch, wal_index=self.wal_index,
            shard_snaps=snaps, scheduler=self.fleet.state_dict(),
            router=self.router.state_dict(),
            shard_ids=[s.shard_id for s in self.shards],
            next_shard_id=self.next_shard_id)

    def close(self) -> None:
        for rep in self.replicators.values():
            rep.close()
        if self.durability is not None:
            self.durability.close()
            for s in self.shards:
                s.close()

    @classmethod
    def open(cls, path, observer=None, *, device=None) -> "ShardedStore":
        """Recover a fleet: rebuild the ShardedStore from the fleet
        MANIFEST, restore the checkpointed topology (router state + one
        snapshot per live shard id) plus the scheduler state at the same
        fleet epoch, then replay the fleet journal tail through the fleet
        write path — re-deriving any migrations the tail triggers, exactly
        as the original run did (§14).  With ``n_shards=1`` the result is
        byte-identical to single-``Store`` recovery (``tests/
        test_durability.py``).

        Replicas are not recovered from the persisted replication logs:
        after replay they are re-seeded as clones of their recovered
        primaries (a crash loses replica *lag state*, not data, §14).

        The recovered fleet runs on ``device``: CUDA unless the caller
        names one, raising without it, as ``ShardedStore(...)`` does.  The
        directory may have been written by either package."""
        if observer is not None:
            raise NotImplementedError("recording observers are not ported "
                                      "yet; leave observer None")
        from pathlib import Path
        from ..durability import (Durability, read_manifest, read_wal,
                                  replay_into, snapshot as dsnap)
        root = Path(path)
        edits = read_manifest(root / Durability.MANIFEST)
        if not edits:
            raise FileNotFoundError(f"no durable fleet at {root}")
        cfg_edit = next(e for e in edits if e.kind == "config")
        fl = cfg_edit.data["fleet"]
        self = cls(EngineConfig.from_state_dict(cfg_edit.data["cfg"]),
                   n_shards=fl["n_shards"], shard_policy=fl["shard_policy"],
                   key_space=fl["key_space"], scheduler=fl["scheduler"],
                   aging_rate=fl["aging_rate"], device=device)
        # replicators re-seed after replay; drop the fresh ones so replay
        # doesn't feed logs that get discarded anyway
        for rep in self.replicators.values():
            rep.close()
        self.replicators = {}
        ckpts = [e for e in edits if e.kind == "fleet_checkpoint"]
        wal_from = 0
        if ckpts:
            ck = ckpts[-1]
            snaps = ck.data["shard_snaps"]
            sids = [int(x) for x in
                    ck.data.get("shard_ids", range(len(snaps)))]
            if "router" in ck.data:
                self.router = restore_router(ck.data["router"])
            self.next_shard_id = int(ck.data.get("next_shard_id",
                                                 len(sids)))
            new_shards = []
            for sid, snap in zip(sids, snaps):
                # restore the snapshot the fleet edit names, NOT the
                # shard's newest one — a crash mid-fleet-checkpoint leaves
                # newer shard snapshots with no matching fleet watermark
                shard = dsnap.restore(root / f"shard-{sid:02d}" / snap,
                                      device=self.device)
                shard.shard_id = sid
                shard.scheduler = self.fleet
                new_shards.append(shard)
            # rebuild topology in place: FleetClock/scheduler hold refs to
            # these lists
            self.shards[:] = new_shards
            self._all_shards[:] = new_shards
            self.fleet.shards[:] = new_shards
            self.n_shards = len(new_shards)
            self.fleet.load_state(ck.data["scheduler"])
            self.wal_index = int(ck.data["wal_index"])
            wal_from = int(ck.data["wal_epoch"])
        for e in edits:
            if e.kind == "wal_segment" and int(e.data["epoch"]) >= wal_from:
                records = read_wal(root / e.data["file"])
                self.obs.instant(self.shards[0], "replay_segment",
                                 file=e.data["file"],
                                 n_records=len(records))
                replay_into(self, records)
        self.obs.instant(self.shards[0], "recovery_end",
                         wal_index=int(self.wal_index))
        self.durability = Durability.attach(root, wal=True)
        for s in self.shards:
            sdir = root / f"shard-{s.shard_id:02d}"
            if (sdir / Durability.MANIFEST).exists():
                s.durability = Durability.attach(sdir, wal=False)
            else:
                # replay re-derived a split the pre-crash run never got to
                # persist a directory for
                s.durability = Durability.create(sdir, s.cfg, wal=False)
        if self.cfg.replica_count > 0:
            for s in self.shards:
                rep = self._make_replicator(s)
                rep.reseed_from(s)
                self.replicators[s.shard_id] = rep
        return self

    # ================================================================ stats
    # Byte/op counters span live + merge-retired shards (that history
    # happened on this fleet); space metrics span live shards only (the
    # retired copy of moved data is garbage, not fleet space).
    @property
    def valid_bytes(self) -> int:
        return sum(s.valid_bytes for s in self.shards)

    @property
    def user_write_bytes(self) -> int:
        return sum(s.user_write_bytes for s in self.shards + self.retired)

    @property
    def n_gc_runs(self) -> int:
        return sum(s.n_gc_runs for s in self.shards + self.retired)

    @property
    def n_compactions(self) -> int:
        return sum(s.n_compactions for s in self.shards + self.retired)

    @property
    def stall_us(self) -> float:
        return sum(s.stall_us for s in self.shards + self.retired)

    def space_bytes(self) -> int:
        return sum(s.space_bytes() for s in self.shards)

    def space_amplification(self) -> float:
        return self.space_bytes() / max(self.valid_bytes, 1)

    def s_index(self) -> float:
        """Fleet index space-amp: total kSST bytes over total last-level
        bytes (aggregated numerator/denominator, not a mean of ratios)."""
        tot = sum(s.version.ksst_total_bytes() for s in self.shards)
        last = sum(s.version.level_bytes(s.version.last_nonempty_level())
                   for s in self.shards)
        return tot / max(last, 1)

    def exposed_over_valid(self) -> float:
        garbage = sum(s.version.value_garbage_bytes() for s in self.shards)
        ref_valid = max(sum(s.valid_value_bytes() for s in self.shards), 1)
        return garbage / ref_valid

    def valid_value_bytes(self) -> int:
        return sum(s.valid_value_bytes() for s in self.shards)

    def hidden_garbage_bytes(self) -> int:
        return sum(s.hidden_garbage_bytes() for s in self.shards)

    def migrated_bytes(self) -> int:
        return sum(m["bytes"] for m in self.migrations)

    def stats(self) -> dict:
        from ..engine import io as sio
        allstores = self.shards + self.retired
        ss = [s.stats() for s in allstores]
        wal = sum(s.io.write_bytes.get(sio.CAT_WAL, 0) for s in allstores)
        write_bytes = sum(st["write_bytes"] for st in ss)
        hits = sum(s.cache.hits for s in allstores)
        lookups = hits + sum(s.cache.misses for s in allstores)
        return {
            "engine": self.cfg.engine,
            "n_shards": len(self.shards),
            "shard_policy": self.shard_policy,
            "scheduler": self.fleet.policy,
            "clock_s": max(st["clock_s"] for st in ss),
            "space_bytes": self.space_bytes(),
            "valid_bytes": self.valid_bytes,
            "user_write_bytes": self.user_write_bytes,
            "space_amp": self.space_amplification(),
            "s_index": self.s_index(),
            "exposed_over_valid": self.exposed_over_valid(),
            "write_amp": (write_bytes - wal)
            / max(self.user_write_bytes, 1),
            "read_bytes": sum(st["read_bytes"] for st in ss),
            "write_bytes": write_bytes,
            "n_compactions": self.n_compactions,
            "n_gc_runs": self.n_gc_runs,
            "cache_hit_ratio": hits / lookups if lookups else 0.0,
            "stall_s": self.stall_us / 1e6,
            "gc_time_s": sum(st["gc_time_s"] for st in ss),
            "shard_space_amp": [st["space_amp"]
                                for st in ss[:len(self.shards)]],
            "router_epoch": self.router.epoch,
            "n_migrations": len(self.migrations),
        }
