"""Durability subsystem: MANIFEST + WAL + snapshots + crash recovery
(port of ``repro.core.durability``, DESIGN.md §9).

A durable store lives in one directory::

    MANIFEST            append-only VersionEdit log (manifest.py)
    wal-000000.log      WAL segments, rolled at each checkpoint (wal.py)
    snap-000001.ckpt    full-state snapshots (snapshot.py)

``Durability`` is the per-store manager ``Store`` / ``ShardedStore`` own
when opened with ``durability_dir``: it appends one WAL record per write
batch, one VersionEdit per metadata transition, and writes
checkpoint snapshots.  All of it is host-side persistence — the simulated
device already charges the WAL append on the write path, so durability
costs zero *simulated* time and a durable run's ``stats()`` are
byte-identical to a non-durable one.

Recovery (``recover_store``) replays MANIFEST then WAL: the manifest
yields the config, the latest intact checkpoint, and the WAL segment
registry; the snapshot restores the full state at the watermark; the WAL
tail re-applies through the normal columnar write path, deterministically
re-deriving flushes, compactions, and GC so the recovered store is
byte-identical to an uninterrupted run at the crash watermark
(``tests/test_torch_durability.py`` crash matrix).  The on-disk format
is the reference package's, so a directory written by either package
recovers in the other.

``CrashPoint`` + ``Store.arm_crash`` provide the crash-injection hooks the
matrix uses (kill between WAL append and memtable insert, mid-flush,
mid-compaction, mid-GC before/after the chain update).  The four fleet
points of ``CRASH_POINTS`` fire in a sharded store, which this package
does not have yet.
"""

from __future__ import annotations

from pathlib import Path

from .manifest import EDIT_KINDS, ManifestWriter, VersionEdit, read_manifest
from .records import (append_record, pack_array, read_record, scan_records,
                      unpack_array)
from .wal import WalWriter, read_wal, replay_into
from . import snapshot

__all__ = ["CrashPoint", "Durability", "EDIT_KINDS", "ManifestWriter",
           "VersionEdit", "WalWriter", "append_record", "pack_array",
           "read_record", "read_manifest", "read_wal", "recover_store",
           "replay_into", "scan_records", "snapshot", "unpack_array"]

# Crash-injection points instrumented in the core (Store._crashpoint);
# the last four fire in the reference's elastic-fleet migration/failover
# machinery (ShardedStore._crashpoint, DESIGN.md §14), not ported yet.
CRASH_POINTS = ("after_wal", "mid_flush", "mid_compaction",
                "gc_pre_chain", "gc_post_chain",
                "mid_migration_copy", "pre_reroute", "mid_delta_replay",
                "pre_promote")


class CrashPoint(RuntimeError):
    """Raised by an armed crash-injection hook: the simulated process died
    here.  The store object must be abandoned; recovery goes through
    ``Store.open`` on its durability directory."""


class Durability:
    """Per-store durability manager: MANIFEST + WAL segments + snapshots."""

    MANIFEST = "MANIFEST"

    def __init__(self, root: Path, man: ManifestWriter, wal: bool,
                 epoch: int, next_snap: int):
        self.root = root
        self.manifest = man
        self.wal_enabled = wal
        self.epoch = epoch
        self._next_snap = next_snap
        self._wal: WalWriter | None = None
        self._wal_bytes_closed = 0      # rolled-segment total (health sampler)
        if wal:
            self._open_segment(epoch)

    @property
    def wal_bytes_written(self) -> int:
        """Host-side WAL bytes across all segments this manager wrote."""
        live = self._wal.bytes_written if self._wal is not None else 0
        return self._wal_bytes_closed + live

    # ----------------------------------------------------------- lifecycle
    @classmethod
    def create(cls, root: Path | str, cfg, wal: bool = True,
               meta: dict | None = None) -> "Durability":
        """Create a fresh durable directory (refuses to reuse one — recover
        existing directories through ``Store.open`` instead)."""
        root = Path(root)
        root.mkdir(parents=True, exist_ok=True)
        mpath = root / cls.MANIFEST
        if mpath.exists():
            raise FileExistsError(
                f"{mpath} exists; use Store.open()/ShardedStore.open() to "
                "recover an existing durable store")
        man = ManifestWriter(mpath)
        # state_dict, not asdict: the live observer hook is process state
        # and must not leak into the JSON config edit
        man.edit("config", cfg=cfg.state_dict(), **(meta or {}))
        return cls(root, man, wal, epoch=0, next_snap=1)

    @classmethod
    def attach(cls, root: Path | str, wal: bool = True) -> "Durability":
        """Re-attach to a recovered directory: append to the existing
        MANIFEST, continue in a fresh WAL segment."""
        root = Path(root)
        epoch = max((int(p.stem.split("-")[1])
                     for p in root.glob("wal-*.log")), default=-1) + 1
        next_snap = max((int(p.stem.split("-")[1])
                         for p in root.glob("snap-*.ckpt")), default=0) + 1
        man = ManifestWriter(root / cls.MANIFEST)
        return cls(root, man, wal, epoch=epoch, next_snap=next_snap)

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()
        self.manifest.close()

    # ------------------------------------------------------------- logging
    def _open_segment(self, epoch: int) -> None:
        if self._wal is not None:
            self._wal_bytes_closed += self._wal.bytes_written
            self._wal.close()
        self.epoch = epoch
        fname = f"wal-{epoch:06d}.log"
        self._wal = WalWriter(self.root / fname)
        self.manifest.edit("wal_segment", epoch=epoch, file=fname)

    def roll_segment(self) -> None:
        """Close the live WAL segment and open the next epoch (recorded as
        a ``wal_segment`` edit).  Checkpoints roll so the journal tail a
        recovery replays starts at the checkpoint."""
        if self.wal_enabled:
            self._open_segment(self.epoch + 1)

    def log_batch(self, idx: int, seq_base: int, kinds, keys,
                  vsizes) -> None:
        if self._wal is not None:
            self._wal.append_batch(idx, seq_base, kinds, keys, vsizes)

    def log_ingest(self, idx: int, kinds, keys, vids, vsizes) -> None:
        if self._wal is not None:
            self._wal.append_ingest(idx, kinds, keys, vids, vsizes)

    def log_reads(self, idx: int, keys) -> None:
        if self._wal is not None:
            self._wal.append_reads(idx, keys)

    def log_scans(self, idx: int, starts, counts) -> None:
        if self._wal is not None:
            self._wal.append_scans(idx, starts, counts)

    def log_flush(self, idx: int) -> None:
        if self._wal is not None:
            self._wal.append_flush(idx)

    def log_edit(self, kind: str, **data) -> None:
        self.manifest.edit(kind, **data)

    # ---------------------------------------------------------- checkpoint
    def checkpoint(self, store) -> Path:
        """Snapshot the store, roll the WAL, and record the checkpoint."""
        fname = f"snap-{self._next_snap:06d}.ckpt"
        path = snapshot.write_snapshot(store, self.root / fname)
        self._next_snap += 1
        self.log_edit("watermark", seq=int(store.seq),
                      next_vid=int(store.next_vid))
        self.roll_segment()
        self.log_edit("checkpoint", file=fname, seq=int(store.seq),
                      wal_epoch=self.epoch)
        return path


# ================================================================ recovery
def recover_store(path: Path | str, io=None, cls=None, *, device=None):
    """MANIFEST-then-WAL recovery of a single durable ``Store``.

    ``path`` may be a bare snapshot file (restore only) or a durable
    directory (restore latest intact checkpoint, then replay the WAL tail
    through the columnar write path).  The recovered store runs on
    ``device`` (CUDA unless the caller names one) and is re-attached to the
    directory, continuing in a fresh WAL segment."""
    from ..store import Store
    cls = cls or Store
    root = Path(path)
    if root.is_file():
        return snapshot.restore(root, io=io, cls=cls, device=device)
    edits = read_manifest(root / Durability.MANIFEST)
    if not edits:
        raise FileNotFoundError(f"no durable store at {root}")
    store, wal_from, ckpt_file = None, 0, None
    for e in reversed(edits):
        if e.kind == "checkpoint":
            try:
                store = snapshot.restore(root / e.data["file"], io=io,
                                         cls=cls, device=device)
            except IOError:
                continue               # torn snapshot: fall back further
            wal_from = int(e.data["wal_epoch"])
            ckpt_file = e.data["file"]
            break
    if store is None:
        cfg_edit = next(e for e in edits if e.kind == "config")
        from ..engine.config import EngineConfig
        store = cls(EngineConfig.from_state_dict(cfg_edit.data["cfg"]),
                    io=io, device=device)
    obs = store.obs
    obs.instant(store, "recovery_begin", src=str(root))
    if ckpt_file is not None:
        obs.instant(store, "checkpoint_restored", file=ckpt_file,
                    wal_epoch=wal_from)
    for e in edits:
        if e.kind == "wal_segment" and int(e.data["epoch"]) >= wal_from:
            records = read_wal(root / e.data["file"])
            obs.instant(store, "replay_segment", file=e.data["file"],
                        n_records=len(records))
            applied = replay_into(store, records)
            obs.on_op(store, "replay_records", applied)
    obs.instant(store, "recovery_end", wal_index=int(store.wal_index))
    store.durability = Durability.attach(root)
    return store
