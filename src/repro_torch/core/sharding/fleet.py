"""Fleet scheduler (port of ``repro.core.sharding.fleet``): space-aware
GC/compaction scheduling across shards (DESIGN.md §6).

A ``ShardedStore``'s shards share one device, so background service is a
*fleet* resource: the total flush/compaction (bg) and GC lane time available
equals the total foreground time the fleet has generated (the same
``lane_clock < fg_clock`` pacing ``Store.pump`` applies to a single store,
summed over shards).  What the scheduler controls is *where* that budget is
spent:

  * ``fleet`` (default) — global ranking.  GC jobs are ranked by the top
    candidate's garbage ratio across all shards (most garbage reclaimed per
    unit of lane time first); compaction jobs by the level score, which under
    ``compensated_compaction`` is the paper's compensated-size score (§III-C)
    applied fleet-wide.  Per-shard starvation aging adds
    ``aging_rate * rounds_waited`` to a shard's priority so cold shards are
    eventually serviced; aging only reorders eligible jobs, it never
    manufactures work below the local trigger.
  * ``round_robin`` — the per-instance baseline: shards are serviced in
    rotation, each running its own best local job, blind to fleet-wide
    garbage distribution.  The reference's ``benchmarks/sharding.py``
    measures the space-amplification gap between the two under a skewed
    (one hot shard) workload.

A shared *space* budget (fleet quota) rides on top: when fleet space crosses
the soft quota every shard's GC threshold drops to the aggressive ratio, and
at the hard quota writers stall while the scheduler force-runs the globally
best GC jobs (``run_one``) until space is back under quota.

With one shard both policies degenerate to exactly ``Store.pump``'s
behaviour — job choice, order, and clock accounting are byte-identical
(the reference's ``tests/test_sharding.py`` asserts this on all engines,
replayed on this package by ``tests/test_torch_replay_sharding.py``).
"""

from __future__ import annotations

from .. import compaction as comp
from .. import gc as gcmod

SCHEDULERS = ("fleet", "round_robin")


class FleetScheduler:
    def __init__(self, shards, policy: str = "fleet",
                 aging_rate: float = 0.05,
                 space_quota_bytes: int | None = None,
                 soft_quota_frac: float = 0.9):
        if policy not in SCHEDULERS:
            raise ValueError(f"unknown scheduler policy {policy!r} "
                             f"(want one of {SCHEDULERS})")
        self.shards = list(shards)
        self.policy = policy
        self.aging_rate = float(aging_rate)
        self.space_quota_bytes = space_quota_bytes
        self.soft_quota_frac = float(soft_quota_frac)
        n = len(self.shards)
        self.compact_wait = [0] * n
        self.gc_wait = [0] * n
        self._rr_compact = 0
        self._rr_gc = 0
        self._pumping = False
        # fleet epoch: bumped at every fleet checkpoint so recovery can tie
        # per-shard snapshots to one consistent cut (DESIGN.md §9)
        self.epoch = 0
        for s in self.shards:
            s.scheduler = self

    # ---------------------------------------------------------- durability
    def state_dict(self) -> dict:
        """Scheduler state a fleet checkpoint persists: starvation-aging
        counters, round-robin cursors, and the fleet epoch — so recovered
        scheduling decisions continue exactly where the fleet left off."""
        return {"epoch": self.epoch,
                "compact_wait": list(self.compact_wait),
                "gc_wait": list(self.gc_wait),
                "rr_compact": self._rr_compact,
                "rr_gc": self._rr_gc}

    def load_state(self, st: dict) -> None:
        self.epoch = int(st["epoch"])
        self.compact_wait = [int(x) for x in st["compact_wait"]]
        self.gc_wait = [int(x) for x in st["gc_wait"]]
        self._rr_compact = int(st["rr_compact"])
        self._rr_gc = int(st["rr_gc"])

    # ------------------------------------------------------------ topology
    def add_shard(self, shard) -> None:
        """Attach a freshly spawned shard (split destination) to fleet
        scheduling (DESIGN.md §14)."""
        self.shards.append(shard)
        self.compact_wait.append(0)
        self.gc_wait.append(0)
        shard.scheduler = self

    def remove_shard(self, pos: int) -> None:
        """Detach a retired shard (merge victim) from fleet scheduling;
        positions above ``pos`` shift down (DESIGN.md §14)."""
        self.shards.pop(pos)
        self.compact_wait.pop(pos)
        self.gc_wait.pop(pos)
        n = max(1, len(self.shards))
        self._rr_compact %= n
        self._rr_gc %= n

    # ------------------------------------------------------------- budgets
    def total_fg_us(self) -> float:
        return sum(s.io.lanes["fg"] for s in self.shards)

    def total_bg_us(self) -> float:
        return sum(s.io.lanes["bg"] for s in self.shards)

    def total_gc_us(self) -> float:
        return sum(s.io.lanes["gc"] for s in self.shards)

    def space_bytes(self) -> int:
        return sum(s.version.total_bytes() for s in self.shards)

    def over_soft_quota(self) -> bool:
        return (self.space_quota_bytes is not None
                and self.space_bytes()
                >= self.soft_quota_frac * self.space_quota_bytes)

    def gc_threshold(self, shard, aggressive: bool | None = None) -> float:
        """Shard's GC trigger, aggressive fleet-wide above the soft quota.

        ``aggressive`` lets ``_pick_gc`` evaluate fleet space once per pick
        instead of once per shard (space_bytes walks every shard's files)."""
        if aggressive is None:
            aggressive = self.over_soft_quota()
        if aggressive:
            return shard.cfg.gc_aggressive_ratio
        return shard._gc_threshold()

    # ------------------------------------------------------- job selection
    def _pick_compact(self):
        """-> (shard_idx, job) or None.  Flushes outrank compactions (memtable
        backlog stalls the foreground hardest); compactions rank by level
        score — the compensated-size score when the engine compensates."""
        shards = self.shards
        if self.policy == "round_robin":
            n = len(shards)
            for off in range(n):
                i = (self._rr_compact + off) % n
                job = shards[i].next_compact_job()
                if job is not None:
                    self._rr_compact = i + 1
                    return i, job
            return None
        flushable = [i for i, s in enumerate(shards) if s.immutables]
        if flushable:
            i = max(flushable, key=lambda i: len(shards[i].immutables))
            self.compact_wait[i] = 0
            return i, ("flush",)
        best, best_prio = None, 0.0
        eligible = []
        for i, s in enumerate(shards):
            scores, base_level = comp.level_scores(s)
            score, level = max(scores, key=lambda sc: sc[0])
            if score < 1.0:
                continue
            eligible.append(i)
            prio = score + self.aging_rate * self.compact_wait[i]
            if best is None or prio > best_prio:
                best, best_prio = (i, ("compact", (level, base_level))), prio
        if best is None:
            return None
        for i in eligible:
            self.compact_wait[i] = (0 if i == best[0]
                                    else self.compact_wait[i] + 1)
        return best

    def _shard_gc_candidates(self, shard, aggressive: bool | None = None):
        if not shard.strategy.wants_standalone_gc():
            return None
        if shard.in_batch_write:
            # same fence as Store.next_gc_job: GC must not interleave with a
            # half-applied WriteBatch on that shard
            return None
        cands = gcmod.gc_candidates(shard,
                                    self.gc_threshold(shard, aggressive))
        return cands or None

    def _pick_gc(self):
        """-> (shard_idx, job) or None.  Jobs rank by the shard's top
        candidate GC score — the engine strategy's ``gc_candidate_score``:
        raw garbage ratio (reclaimed bytes per lane time) for the paper
        engines, tracker-driven predicted dead-byte yield for
        ``scavenger_adaptive`` — plus starvation aging."""
        shards = self.shards
        aggressive = self.over_soft_quota()
        if self.policy == "round_robin":
            n = len(shards)
            for off in range(n):
                i = (self._rr_gc + off) % n
                cands = self._shard_gc_candidates(shards[i], aggressive)
                if cands:
                    self._rr_gc = i + 1
                    return i, ("gc", gcmod.gc_batch(shards[i], cands))
            return None
        best, best_prio, best_cands = None, 0.0, None
        eligible = []
        for i, s in enumerate(shards):
            cands = self._shard_gc_candidates(s, aggressive)
            if not cands:
                continue
            eligible.append(i)
            prio = (s.strategy.gc_candidate_score(s, cands[0])
                    + self.aging_rate * self.gc_wait[i])
            if best is None or prio > best_prio:
                best, best_prio, best_cands = i, prio, cands
        if best is None:
            return None
        for i in eligible:
            self.gc_wait[i] = 0 if i == best else self.gc_wait[i] + 1
        return best, ("gc", gcmod.gc_batch(shards[best], best_cands))

    # ------------------------------------------------------------ service
    def pump(self) -> None:
        """Run background jobs that fit in the fleet lane budgets.

        Same two-phase structure as ``Store.pump`` — flush/compaction lane
        first, then the GC lane — with job *choice* globalized."""
        if self._pumping:
            return
        self._pumping = True
        try:
            while self.total_bg_us() < self.total_fg_us():
                picked = self._pick_compact()
                if picked is None:
                    break
                self.shards[picked[0]].run_job(picked[1], "bg",
                                               trigger="lane_budget",
                                               policy=self.policy)
            while self.total_gc_us() < self.total_fg_us():
                picked = self._pick_gc()
                if picked is None:
                    break
                self.shards[picked[0]].run_job(picked[1], "gc",
                                               trigger="lane_budget",
                                               policy=self.policy)
        finally:
            self._pumping = False

    def run_one(self, prefer_gc: bool = False) -> bool:
        """Force-run the single globally best job, ignoring lane budgets
        (the fleet analogue of the job step inside ``Store._stall_while``;
        used when writers stall on the fleet space quota).  The owning
        shard's lane is synced to its foreground clock so the job charges
        real stall time.  Returns False when no job exists anywhere."""
        order = (self._pick_gc, self._pick_compact) if prefer_gc \
            else (self._pick_compact, self._pick_gc)
        lanes = ("gc", "bg") if prefer_gc else ("bg", "gc")
        for pick, lane in zip(order, lanes):
            picked = pick()
            if picked is None:
                continue
            shard = self.shards[picked[0]]
            t_lane = shard.io.lanes[lane]
            shard.io.lanes[lane] = max(t_lane, shard.io.fg_clock_us)
            # both jumps happen outside any shard span (run_one is called
            # from the fleet quota path, before per-shard write dispatch),
            # so each is recorded for lane tiling (DESIGN.md §11)
            shard.obs.lane_sync(shard, lane, t_lane)
            shard.run_job(picked[1], lane, trigger="quota_stall",
                          policy=self.policy)
            t_fg = shard.io.fg_clock_us
            shard.io.lanes["fg"] = max(t_fg, shard.io.lanes[lane])
            shard.obs.lane_sync(shard, "fg", t_fg)
            return True
        return False

    def drain(self) -> None:
        """Run ALL pending background work fleet-wide, then synchronize
        every shard's lanes (the fleet analogue of ``Store.drain``)."""
        while True:
            picked, lane = self._pick_compact(), "bg"
            if picked is None:
                picked, lane = self._pick_gc(), "gc"
            if picked is None:
                break
            self.shards[picked[0]].run_job(picked[1], lane, trigger="drain",
                                           policy=self.policy)
        for s in self.shards:
            m = max(s.io.lanes.values())
            for k in s.io.lanes:
                t0 = s.io.lanes[k]
                s.io.lanes[k] = m
                s.obs.lane_sync(s, k, t0)
