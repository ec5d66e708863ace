"""WAL segments: a durable journal of the user-op stream + deterministic
replay (port of ``repro.core.durability.wal``, DESIGN.md §9).

A segment is a CRC-framed record log (``records.py``).  Write batches are
journaled as their columnar ``(kinds u8, keys u64, vsizes i64)`` triple
stamped with the batch's first preassigned sequence number — the simulated
device already charges this append on the write path (``CAT_WAL``), so the
host-side persistence here costs zero *simulated* time.

Unlike a production WAL, the journal also records **reads** (``multi_get``
/ ``multi_scan``) and explicit ``flush`` calls: under the two-lane clock a
read advances the foreground lane and therefore moves background
scheduling, so reads are part of the deterministic schedule that
byte-identical recovery must reproduce.  (A real engine recovers logical
state only; this simulator promises the full ``stats()`` byte counters —
see the recovery contract in DESIGN.md §9.)

Every record carries a monotone op index (``Store.wal_index``); replay
pushes records back through the normal columnar entry points
(``_write_arrays`` / ``multi_get`` / ``multi_scan`` / ``flush``) skipping
indexes at or below the store's restored watermark, so replaying a prefix
twice equals replaying it once (prefix idempotence).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from .records import (append_record, pack_array, scan_records,
                      unpack_array_at)

_IDX_HDR = struct.Struct("<Q")          # op index
_SEQ_HDR = struct.Struct("<Q")          # seq_base (write batches only)
_BATCH_ARRAYS = 3                       # "b" payload: kinds, keys, vsizes
_INGEST_ARRAYS = 4                      # "i" payload: kinds, keys, vids,
#                                         vsizes


def _encode_arrays(*arrays) -> bytes:
    return b"".join(pack_array(a) for a in arrays)


def _decode_arrays(payload: bytes, off: int, n: int):
    out = []
    for _ in range(n):
        arr, off = unpack_array_at(payload, off)
        out.append(arr)
    return out


class WalWriter:
    def __init__(self, path: Path | str):
        self.path = Path(path)
        self._fh = open(self.path, "ab")
        # host-side segment size (bytes), surfaced by the health sampler
        # (DESIGN.md §11)
        self.bytes_written = self._fh.tell()

    def _append(self, key: str, idx: int, body: bytes) -> None:
        append_record(self._fh, key, _IDX_HDR.pack(int(idx)) + body)
        self._fh.flush()
        self.bytes_written = self._fh.tell()

    def append_batch(self, idx: int, seq_base: int, kinds, keys,
                     vsizes) -> None:
        self._append("b", idx, _SEQ_HDR.pack(int(seq_base)) + _encode_arrays(
            np.asarray(kinds, np.uint8), np.asarray(keys, np.uint64),
            np.asarray(vsizes, np.int64)))

    def append_ingest(self, idx: int, kinds, keys, vids, vsizes) -> None:
        """Journal a vid-preserving ingest (migration copy-in / replica
        promotion replay, DESIGN.md §14): records that already own their
        value identity, so replay must not re-mint vids."""
        self._append("i", idx, _encode_arrays(
            np.asarray(kinds, np.uint8), np.asarray(keys, np.uint64),
            np.asarray(vids, np.uint64), np.asarray(vsizes, np.int64)))

    def append_reads(self, idx: int, keys) -> None:
        self._append("r", idx, _encode_arrays(np.asarray(keys, np.uint64)))

    def append_scans(self, idx: int, starts, counts) -> None:
        self._append("s", idx, _encode_arrays(
            np.asarray(starts, np.int64), np.asarray(counts, np.int64)))

    def append_flush(self, idx: int) -> None:
        self._append("f", idx, b"")

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()


def read_wal(path: Path | str) -> list[tuple]:
    """All intact journal records, in order.

    Each entry is ``(kind, idx, *payload)``: ``("b", idx, seq_base, kinds,
    keys, vsizes)``, ``("i", idx, kinds, keys, vids, vsizes)``,
    ``("r", idx, keys)``, ``("s", idx, starts, counts)``, or
    ``("f", idx)``."""
    out = []
    for _, key, payload in scan_records(path):
        kind = key.decode()
        (idx,) = _IDX_HDR.unpack_from(payload)
        off = _IDX_HDR.size
        if kind == "b":
            (seq_base,) = _SEQ_HDR.unpack_from(payload, off)
            arrays = _decode_arrays(payload, off + _SEQ_HDR.size,
                                    _BATCH_ARRAYS)
            out.append(("b", idx, seq_base, *arrays))
        elif kind == "i":
            out.append(("i", idx, *_decode_arrays(payload, off,
                                                  _INGEST_ARRAYS)))
        elif kind == "r":
            out.append(("r", idx, *_decode_arrays(payload, off, 1)))
        elif kind == "s":
            out.append(("s", idx, *_decode_arrays(payload, off, 2)))
        elif kind == "f":
            out.append(("f", idx))
    return out


def replay_into(store, records) -> int:
    """Re-apply journal records through the store's columnar entry points.

    Records at or below the store's op-index watermark are skipped
    (prefix-idempotence); returns the number of records applied."""
    applied = 0
    for rec in records:
        kind, idx = rec[0], rec[1]
        if idx <= store.wal_index:
            continue
        if kind == "b":
            store._write_arrays(rec[3], rec[4], rec[5])
        elif kind == "i":
            store.ingest_batch(rec[2], rec[3], rec[4], rec[5])
        elif kind == "r":
            store.multi_get(rec[2])
        elif kind == "s":
            store.multi_scan(rec[2], rec[3])
        elif kind == "f":
            store.flush()
        store.wal_index = idx
        applied += 1
    return applied
