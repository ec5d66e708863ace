"""Versioned MANIFEST: an append-only log of ``VersionEdit`` records
(port of ``repro.core.durability.manifest``, DESIGN.md §9).

The MANIFEST is the durable root of a store directory.  Every metadata
transition appends one edit: file adds/drops (flush, compaction), value-
file registry changes and GC inheritance-chain updates (``chain_update`` /
``retire_value_file``), sequence-number watermarks, WAL segment rolls, and
checkpoints (which name the snapshot file recovery restores before
replaying the WAL tail).  Edits are JSON payloads in the shared CRC
framing (``records.py``); a torn tail is silently dropped on read, exactly
like a real MANIFEST whose writer died mid-append.

Recovery treats ``config`` / ``checkpoint`` / ``wal_segment`` edits as
load-bearing; the structural edits double as an audit log of the store's
file topology (round-trip tested in ``tests/test_torch_durability.py``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from .records import append_record, scan_records

# Edit kinds the core emits.  The codec is schema-free (kind + JSON data),
# so custom engines can log their own kinds without touching this module.
EDIT_KINDS = (
    "config",              # engine/fleet configuration at creation
    "wal_segment",         # a WAL segment was opened: {epoch, file}
    "watermark",           # sequence-number watermark: {seq, next_vid}
    "checkpoint",          # snapshot written: {file, seq, wal_epoch}
    "add_file",            # kSST added: {fid, level, nbytes}
    "drop_file",           # kSST dropped by compaction: {fid}
    "add_value_file",      # vSST registered: {fid, nbytes, temperature}
    "retire_value_file",   # vSST left the registry: {fid}
    "chain_update",        # GC inheritance: {retired: [...], group: [...]}
    "fleet_checkpoint",    # ShardedStore checkpoint: scheduler state + epoch
    "migration_begin",     # shard split/merge started: {kind, src, dst, ...}
    "migration_end",       # migration finalized: {kind, src, dst, epoch, ...}
    "replica_promote",     # failover: {shard, replica, applied}
)


@dataclasses.dataclass(frozen=True)
class VersionEdit:
    kind: str
    data: dict

    def encode(self) -> bytes:
        return json.dumps({"k": self.kind, "d": self.data},
                          sort_keys=True).encode()

    @classmethod
    def decode(cls, payload: bytes) -> "VersionEdit":
        obj = json.loads(payload)
        return cls(kind=obj["k"], data=obj["d"])


class ManifestWriter:
    """Append-only MANIFEST writer (flushed per edit: the manifest is the
    durability root, a buffered edit is a lost edit)."""

    def __init__(self, path: Path | str):
        self.path = Path(path)
        self._fh = open(self.path, "ab")
        # host-side file size (bytes), surfaced by the health sampler
        # (DESIGN.md §11)
        self.bytes_written = self._fh.tell()

    def append(self, edit: VersionEdit) -> None:
        append_record(self._fh, "e", edit.encode())
        self._fh.flush()
        self.bytes_written = self._fh.tell()

    def edit(self, kind: str, **data) -> None:
        self.append(VersionEdit(kind, data))

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()


def read_manifest(path: Path | str) -> list[VersionEdit]:
    """All intact edits in append order (torn tail dropped)."""
    return [VersionEdit.decode(payload)
            for _, key, payload in scan_records(path) if key == b"e"]
