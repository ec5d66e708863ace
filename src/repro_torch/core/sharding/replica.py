"""N-way shard replication + primary failover (port of
``repro.core.sharding.replica``, DESIGN.md §14).

Each primary shard owns a ``ShardReplicator``: every shard-level op the
fleet dispatches to the primary — write batches, vid-preserving ingests,
reads, scans, flushes — is appended to a per-shard replication log in the
WAL record format (``durability/wal.py``), then applied to ``N`` replica
Stores through ``replay_into``.  Replicas are plain standalone ``Store``
objects on their own simulated devices, off the fleet's client critical
path: replica ``rank r`` lags the log tail by ``r * replica_lag_ops``
records (rank 0 is synchronous), modelling a replication pipeline whose
followers are progressively further behind.  They run on the fleet's
torch device, where their replayed batches launch the same kernels as
the primary's.

Because vid minting and background scheduling are pure functions of the
per-shard op stream (§9), a replica that has applied the full log is
byte-identical to a fresh Store replaying that log — the golden-parity
contract ``tests/test_elastic_fleet.py`` locks down after failover.

``fail_primary`` promotes the most-caught-up replica: replay the log tail
it hasn't applied, swap it into the fleet (scheduler slot, observer
registration, durability directory), and log a ``replica_promote`` edit.
When the fleet is durable the log is additionally persisted to
``replog-<shard>-<epoch>.log`` segments beside the fleet WAL; a crash
loses replica *lag state*, not data — recovery re-seeds replicas from the
recovered primary via an in-memory snapshot round trip.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from ..durability.snapshot import restore_store, snapshot_state
from ..durability.wal import WalWriter, replay_into


class ShardReplicator:
    """Replication log + replica set for one primary shard."""

    def __init__(self, cfg, count: int, lag_ops: int,
                 durability_root: Path | None = None, shard_id: int = 0,
                 wal_epoch: int = 0, *, device=None):
        from ..store import Store      # lazy: sharding <- store cycle
        # replicas are independent machines: fresh SimIO each, no observer
        # (the fleet's ledger tracks primaries only)
        rcfg = dataclasses.replace(cfg, observer=None)
        self.device = device
        self.replicas = [Store(rcfg, device=device) for _ in range(count)]
        self.log: list[tuple] = []
        self.applied = [0] * count
        self.lag = [r * lag_ops for r in range(count)]
        self._idx = 0
        self._wal: WalWriter | None = None
        if durability_root is not None and count:
            self._wal = WalWriter(
                Path(durability_root)
                / f"replog-{shard_id:02d}-{wal_epoch:06d}.log")

    # ------------------------------------------------------------- logging
    def log_batch(self, kinds, keys, vsizes) -> None:
        self._idx += 1
        self.log.append(("b", self._idx, 0, np.asarray(kinds, np.uint8),
                         np.asarray(keys, np.uint64),
                         np.asarray(vsizes, np.int64)))
        if self._wal is not None:
            self._wal.append_batch(self._idx, 0, kinds, keys, vsizes)

    def log_ingest(self, kinds, keys, vids, vsizes) -> None:
        self._idx += 1
        self.log.append(("i", self._idx, np.asarray(kinds, np.uint8),
                         np.asarray(keys, np.uint64),
                         np.asarray(vids, np.uint64),
                         np.asarray(vsizes, np.int64)))
        if self._wal is not None:
            self._wal.append_ingest(self._idx, kinds, keys, vids, vsizes)

    def log_reads(self, keys) -> None:
        self._idx += 1
        self.log.append(("r", self._idx, np.asarray(keys, np.uint64)))
        if self._wal is not None:
            self._wal.append_reads(self._idx, keys)

    def log_scans(self, starts, counts) -> None:
        self._idx += 1
        self.log.append(("s", self._idx, np.asarray(starts, np.int64),
                         np.asarray(counts, np.int64)))
        if self._wal is not None:
            self._wal.append_scans(self._idx, starts, counts)

    def log_flush(self) -> None:
        self._idx += 1
        self.log.append(("f", self._idx))
        if self._wal is not None:
            self._wal.append_flush(self._idx)

    # ------------------------------------------------------------ applying
    def poll(self) -> None:
        """Advance each replica to its lag-bounded target position."""
        for r, rep in enumerate(self.replicas):
            target = len(self.log) - self.lag[r]
            if target > self.applied[r]:
                replay_into(rep, self.log[self.applied[r]:target])
                self.applied[r] = target

    def best(self) -> int:
        """Rank of the most-caught-up replica (ties -> lowest rank)."""
        if not self.replicas:
            raise ValueError("no replicas to promote")
        return max(range(len(self.replicas)),
                   key=lambda r: (self.applied[r], -r))

    def promote(self, rank: int):
        """Catch the replica up on the full log and remove it from the
        replica set; the caller swaps it in as the new primary."""
        rep = self.replicas[rank]
        replay_into(rep, self.log[self.applied[rank]:])
        self.replicas.pop(rank)
        self.applied.pop(rank)
        self.lag.pop(rank)
        return rep

    def reseed_from(self, primary) -> None:
        """Rebuild every replica as a byte-identical clone of ``primary``
        (post-recovery: the persisted replog's lag state is not restored —
        a crash loses lag, not data; DESIGN.md §14)."""
        meta, arrays = snapshot_state(primary)
        self.replicas = [restore_store(meta, arrays, device=self.device)
                         for _ in self.replicas]
        for rep in self.replicas:
            # the clone inherits the primary's journal watermark; replica
            # log indexes restart at 1, so reset it or replay skips them
            rep.wal_index = 0
            rep.durability = None
        self.log.clear()
        self.applied = [0] * len(self.replicas)
        self._idx = 0

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()
