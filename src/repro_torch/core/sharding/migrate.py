"""Live shard migration (port of ``repro.core.sharding.migrate``): online
split/merge with epoch-fenced re-routing (DESIGN.md §14).

A migration moves one contiguous routing-domain range between exactly two
shards and runs in four phases, driven one chunk at a time from
``FleetScheduler.pump`` so copy I/O interleaves with foreground service:

  1. **begin**   — pick the moving range (split: the upper half of the
     source's slice at the median live routing value; merge: the victim's
     whole slice), spawn the destination shard (split only), and log a
     ``migration_begin`` MANIFEST edit.
  2. **copy**    — sweep the source's live keys through the normal read
     path (``multi_scan`` for the key column, ``multi_get`` for value
     identity + size) and ingest them into the destination with their
     vids preserved (``Store.ingest_batch``).  The router is untouched:
     readers and writers still go to the source, and every user write
     into the moving range is mirrored into the migration *delta*.
  3. **re-route + delta replay** — bump the router epoch (new traffic now
     routes to the destination) and replay the delta.  This is the only
     window where writes to the moving range would block; its duration is
     the migration's *fence* downtime, reported per migration (the
     reference gates it in ``benchmarks/elasticity.py``).
  4. **cleanup** — tombstone the moved keys on the source (split), or
     retire the drained victim shard (merge), and log ``migration_end``.

Everything the migration itself does is *derived* work: it is never
journaled to the fleet WAL, because replaying the user-op stream from the
same state re-derives the same migrations deterministically (the same
recovery argument as flush/compaction/GC, DESIGN.md §9).  Crash points
``mid_migration_copy`` / ``pre_reroute`` / ``mid_delta_replay`` fire at
the phase boundaries for the crash matrix in
``tests/test_elastic_fleet.py`` (replayed on this package by
``tests/test_torch_replay_sharding.py``).

All migration I/O runs under a pinned ``origin="migration"`` ledger cause
on the store doing the work (a no-op under the null observer; the
reference's recording observer decomposes migrated bytes by it, §13).
"""

from __future__ import annotations

import numpy as np

from ..batch import OP_DELETE, OP_PUT


class Migration:
    """State of one in-flight range move (src -> dst, [lo, hi))."""

    __slots__ = ("kind", "src_pos", "dst_pos", "lo", "hi", "hi_inf",
                 "cursor", "seen", "delta", "records", "bytes",
                 "copy_done", "fence_us")

    def __init__(self, kind: str, src_pos: int, dst_pos: int, lo: int,
                 hi: int, hi_inf: bool, cursor: int):
        self.kind = kind
        self.src_pos = src_pos
        self.dst_pos = dst_pos
        self.lo = lo
        self.hi = hi
        # hi == routing domain: the moving slice is the last one, which
        # also owns every overflow value at or past the domain bound —
        # treat hi as +inf so those keys move too
        self.hi_inf = hi_inf
        self.cursor = cursor            # next key the copy sweep scans from
        self.seen: set[int] = set()     # keys copied (cleanup tombstones)
        self.delta: list[tuple] = []    # writes mirrored during the copy
        self.records = 0
        self.bytes = 0
        self.copy_done = False
        self.fence_us = 0.0

    def in_range(self, route_vals: np.ndarray) -> np.ndarray:
        m = route_vals >= np.uint64(self.lo)
        if not self.hi_inf:
            m &= route_vals < np.uint64(self.hi)
        return m


class ElasticityManager:
    """Watches per-shard space/traffic shares against the EngineConfig
    elasticity thresholds and drives migrations chunk-by-chunk from the
    fleet scheduler's pump (DESIGN.md §14)."""

    def __init__(self, store):
        self.store = store
        cfg = store.cfg
        self.auto = (cfg.elastic_split_frac is not None
                     or cfg.elastic_merge_frac > 0)
        self.mig: Migration | None = None
        self._migrating = False         # suppress traffic/delta recursion
        self._ops_seen = 0
        self._last_eval = 0
        self._traffic: dict[int, int] = {}   # shard_id -> window op count

    # ---------------------------------------------------------- accounting
    def note_traffic(self, pos: int, n: int) -> None:
        if self._migrating:
            return                      # copy reads are not user traffic
        self._ops_seen += n
        if self.auto:
            sid = self.store.shards[pos].shard_id
            self._traffic[sid] = self._traffic.get(sid, 0) + n

    def note_write(self, pos: int, kinds, keys, vids, vsizes) -> None:
        """Mirror user writes landing in an in-flight migration's moving
        range into the delta (replayed at finalize)."""
        mig = self.mig
        if mig is None or self._migrating or pos != mig.src_pos:
            return
        m = mig.in_range(self.store.router.route(keys))
        if not m.any():
            return
        mig.delta.append((np.asarray(kinds, np.uint8)[m],
                          np.asarray(keys, np.uint64)[m],
                          np.asarray(vids, np.uint64)[m],
                          np.asarray(vsizes, np.int64)[m]))
        puts = m & (np.asarray(kinds, np.uint8) == OP_PUT)
        mig.seen.update(np.asarray(keys, np.uint64)[puts].tolist())

    # ------------------------------------------------------------ stepping
    def step(self) -> None:
        """One unit of elastic work: a copy chunk / the finalize of the
        active migration, else a (cooldown-gated) trigger evaluation."""
        if self.mig is not None:
            if self.mig.copy_done:
                self._finalize()
            else:
                self._copy_chunk()
            return
        self._maybe_trigger()

    def quiesce(self) -> None:
        """Run the active migration to completion (checkpoint/drain
        barrier: scheduler state and snapshots are only taken between
        migrations)."""
        while self.mig is not None:
            self.step()

    # ------------------------------------------------------------ triggers
    def _shares(self):
        shards = self.store.shards
        space = [s.version.total_bytes() for s in shards]
        tot_space = sum(space)
        tot_traffic = sum(self._traffic.values())
        out = []
        for pos, s in enumerate(shards):
            sh = space[pos] / tot_space if tot_space else 0.0
            if tot_traffic:
                sh = max(sh, self._traffic.get(s.shard_id, 0) / tot_traffic)
            out.append(sh)
        return out

    def _maybe_trigger(self) -> None:
        if not self.auto:
            return
        cfg = self.store.cfg
        if self._ops_seen - self._last_eval < cfg.elastic_cooldown_ops:
            return
        self._last_eval = self._ops_seen
        shares = self._shares()
        self._traffic.clear()           # next window starts fresh
        if not shares:
            return
        if cfg.elastic_split_frac is not None \
                and len(shares) < cfg.elastic_max_shards:
            pos = max(range(len(shares)), key=shares.__getitem__)
            if shares[pos] > cfg.elastic_split_frac \
                    and self.begin_split(pos):
                return
        if cfg.elastic_merge_frac > 0 and len(shares) > 1:
            pos = min(range(len(shares)), key=shares.__getitem__)
            if shares[pos] < cfg.elastic_merge_frac:
                self.begin_merge(pos)

    # -------------------------------------------------------------- begin
    def _split_cut(self, src, lo: int, hi: int, hi_inf: bool) -> int | None:
        """Median live routing value of the source inside [lo, hi) — the
        balance point a split cuts at.  Reads engine-internal table/
        memtable metadata (never the stats oracle)."""
        cols = [t.keys for t in src.version.all_kssts()]
        for mt in [src.memtable] + src.immutables:
            n = len(mt.entries)
            if n:
                cols.append(np.fromiter(mt.entries.keys(), np.uint64,
                                        count=n))
        if not cols:
            return None
        rv = self.store.router.route(np.concatenate(cols))
        m = rv >= np.uint64(lo)
        if not hi_inf:
            m &= rv < np.uint64(hi)
        rv = rv[m]
        if len(rv) == 0:
            return None
        # exact integer median via partition (np.median would round-trip
        # uint64 through float64 and lose low bits of the hash domain)
        cut = int(np.partition(rv, len(rv) // 2)[len(rv) // 2])
        cut = max(lo + 1, min(cut, hi - 1))
        if not lo < cut < hi:
            return None
        return cut

    def begin_split(self, pos: int, cut: int | None = None) -> bool:
        """Start splitting shard ``pos``'s slice: the upper part [cut, hi)
        moves to a freshly spawned shard.  Returns False when no valid cut
        exists or a migration is already running."""
        st = self.store
        if self.mig is not None:
            return False
        src = st.shards[pos]
        sl = st.router.slice_of_shard(pos)
        lo, hi = st.router.slice_bounds(sl)
        hi_inf = hi >= st.router.domain
        if cut is None:
            cut = self._split_cut(src, lo, hi, hi_inf)
            if cut is None:
                return False
        elif not lo < cut < hi:
            raise ValueError(f"cut {cut} outside shard {pos}'s slice "
                             f"({lo}, {hi})")
        dst_pos = st._spawn_shard()
        cursor = cut if st.router.policy == "range" else 0
        self.mig = Migration("split", pos, dst_pos, cut, hi, hi_inf, cursor)
        st._log_fleet_edit("migration_begin", mig="split",
                           src=src.shard_id,
                           dst=st.shards[dst_pos].shard_id,
                           lo=cut, hi=hi)
        st.obs.instant(src, "migration_begin", kind="split", lo=cut, hi=hi)
        return True

    def begin_merge(self, victim: int, into: int | None = None) -> bool:
        """Start draining shard ``victim`` into the adjacent-slice shard
        ``into`` (default: the emptier neighbor); the victim retires when
        the move finalizes."""
        st = self.store
        if self.mig is not None or len(st.shards) < 2:
            return False
        neighbors = st.router.neighbors(victim)
        if into is None:
            into = min(neighbors,
                       key=lambda p: st.shards[p].version.total_bytes())
        elif into not in neighbors:
            raise ValueError(f"shard {into} is not slice-adjacent to "
                             f"{victim} (neighbors: {neighbors})")
        lo, hi = st.router.shard_range(victim)
        hi_inf = hi >= st.router.domain
        cursor = lo if st.router.policy == "range" else 0
        self.mig = Migration("merge", victim, into, lo, hi, hi_inf, cursor)
        st._log_fleet_edit("migration_begin", mig="merge",
                           src=st.shards[victim].shard_id,
                           dst=st.shards[into].shard_id, lo=lo, hi=hi)
        st.obs.instant(st.shards[victim], "migration_begin", kind="merge",
                       lo=lo, hi=hi)
        return True

    # --------------------------------------------------------------- copy
    def _copy_chunk(self) -> None:
        """Copy up to ``migration_chunk_records`` live keys src -> dst
        through the normal read path, vids preserved."""
        st, mig = self.store, self.mig
        cfg = st.cfg
        src = st.shards[mig.src_pos]
        dst = st.shards[mig.dst_pos]
        chunk = cfg.migration_chunk_records
        self._migrating = True
        try:
            with st.obs.cause(src, origin="migration"):
                res = st._shard_scan(
                    mig.src_pos, np.array([mig.cursor], np.int64),
                    np.array([chunk], np.int64))
            pairs = res[0]
            if not pairs:
                mig.copy_done = True
                return
            ks = np.array([k for k, _ in pairs], np.uint64)
            rv = st.router.route(ks)
            sel = ks[mig.in_range(rv)]
            end_reached = (not mig.hi_inf
                           and st.router.policy == "range"
                           and bool((rv >= np.uint64(mig.hi)).any()))
            if len(sel):
                with st.obs.cause(src, origin="migration"):
                    got = st._shard_get(mig.src_pos, sel)
                live = got["found"]
                sel = sel[live]
                if len(sel):
                    vids = got["vid"][live]
                    vsz = got["vsize"][live].astype(np.int64)
                    kinds = np.full(len(sel), OP_PUT, np.uint8)
                    with st.obs.cause(dst, origin="migration"):
                        st._shard_ingest(mig.dst_pos, kinds, sel, vids, vsz)
                    mig.seen.update(sel.tolist())
                    mig.records += len(sel)
                    mig.bytes += int(
                        (cfg.key_bytes + vsz + cfg.wal_rec_overhead).sum())
            st._crashpoint("mid_migration_copy")
            mig.cursor = int(ks[-1]) + 1
            if len(pairs) < chunk or end_reached:
                mig.copy_done = True
        finally:
            self._migrating = False

    # ------------------------------------------------------------ finalize
    def _finalize(self) -> None:
        """Re-route (epoch bump), replay the delta inside the write fence,
        clean up the source, and retire the victim on a merge."""
        st, mig = self.store, self.mig
        cfg = st.cfg
        src = st.shards[mig.src_pos]
        dst = st.shards[mig.dst_pos]
        st._crashpoint("pre_reroute")
        if mig.kind == "split":
            st.router.split(mig.src_pos, mig.lo, mig.dst_pos)
        else:
            st.router.merge(mig.src_pos, mig.dst_pos)
        # -- fence window: writes to the moved range block on delta replay
        t0 = dst.io.fg_clock_us
        st._crashpoint("mid_delta_replay")
        self._migrating = True
        try:
            for kinds, ks, vids, vsz in mig.delta:
                with st.obs.cause(dst, origin="migration"):
                    st._shard_ingest(mig.dst_pos, kinds, ks, vids, vsz)
                mig.records += len(ks)
                mig.bytes += int((cfg.key_bytes + vsz
                                  + cfg.wal_rec_overhead).sum())
            mig.fence_us = dst.io.fg_clock_us - t0
            st.obs.instant(dst, "migration_fence", us=mig.fence_us)
            if mig.kind == "split" and mig.seen:
                # tombstone the moved keys on the source: stale records
                # become garbage the normal compaction/GC pipeline reclaims
                moved = np.array(sorted(mig.seen), np.uint64)
                zeros = np.zeros(len(moved), np.int64)
                chunk = cfg.migration_chunk_records
                for i in range(0, len(moved), chunk):
                    part = moved[i:i + chunk]
                    kinds = np.full(len(part), OP_DELETE, np.uint8)
                    with st.obs.cause(src, origin="migration"):
                        st._shard_ingest(
                            mig.src_pos, kinds, part,
                            np.zeros(len(part), np.uint64),
                            zeros[:len(part)])
        finally:
            self._migrating = False
        src_id, dst_id = src.shard_id, dst.shard_id
        if mig.kind == "merge":
            st._retire_shard(mig.src_pos)
        st._log_fleet_edit("migration_end", mig=mig.kind, src=src_id,
                           dst=dst_id, epoch=st.router.epoch,
                           records=mig.records, nbytes=mig.bytes,
                           fence_us=mig.fence_us)
        st.obs.instant(dst, "migration_end", kind=mig.kind,
                       records=mig.records, nbytes=mig.bytes)
        st.migrations.append({
            "kind": mig.kind, "src": src_id, "dst": dst_id,
            "lo": mig.lo, "hi": mig.hi, "records": mig.records,
            "bytes": mig.bytes, "fence_us": mig.fence_us,
            "epoch": st.router.epoch})
        self.mig = None
        self._last_eval = self._ops_seen
