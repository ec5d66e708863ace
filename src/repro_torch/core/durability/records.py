"""CRC-framed record log: the one on-disk framing durability shares (port
of ``repro.core.durability.records``, DESIGN.md §9).

The framing is the reference package's byte for byte, so a directory
written by one package opens in the other.  WAL segments and the MANIFEST
(``core/durability``) and store snapshots (``durability/snapshot.py``) are
each a sequence of ``(key, payload)`` records framed as::

    <crc32 u32> <key_len u32> <val_len u64> <key bytes> <payload bytes>

with the CRC taken over ``key + payload``.  Readers stop at the first
torn or corrupt record (a crashed writer leaves at most one partial
record at the tail), so recovery never needs a separate "clean shutdown"
marker.  Arrays travel as self-describing ``pack_array`` payloads
(dtype + shape header, raw little-endian bytes).
"""

from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path
from typing import Iterator

import numpy as np

REC_HDR = struct.Struct("<IIQ")          # crc32, key_len, val_len

# Sanity bounds applied while scanning: a torn tail can masquerade as a
# huge length field; anything past these is treated as corruption.
MAX_KEY_LEN = 1 << 20
MAX_VAL_LEN = 1 << 40


def append_record(fh, key: bytes | str, payload: bytes) -> int:
    """Append one framed record at the file's current position.

    Returns the serialized record length (header + key + payload)."""
    kb = key.encode() if isinstance(key, str) else key
    fh.write(REC_HDR.pack(zlib.crc32(kb + payload), len(kb), len(payload)))
    fh.write(kb)
    fh.write(payload)
    return REC_HDR.size + len(kb) + len(payload)


def read_record(fh) -> tuple[bytes, bytes] | None:
    """Read one record at the current position; None at EOF or on a torn /
    corrupt record (caller should stop scanning)."""
    hdr = fh.read(REC_HDR.size)
    if len(hdr) < REC_HDR.size:
        return None
    crc, klen, vlen = REC_HDR.unpack(hdr)
    if klen > MAX_KEY_LEN or vlen > MAX_VAL_LEN:
        return None
    kb = fh.read(klen)
    payload = fh.read(vlen)
    if len(kb) < klen or len(payload) < vlen \
            or zlib.crc32(kb + payload) != crc:
        return None
    return kb, payload


def scan_records(path: Path | str) -> Iterator[tuple[int, bytes, bytes]]:
    """Yield ``(offset, key, payload)`` for every intact record, stopping
    silently at the first torn tail (crash-recovery semantics)."""
    p = Path(path)
    if not p.exists():
        return
    with open(p, "rb") as fh:
        while True:
            off = fh.tell()
            rec = read_record(fh)
            if rec is None:
                return
            yield off, rec[0], rec[1]


# ---------------------------------------------------------------- arrays
_ARR_HDR = struct.Struct("<I")           # json header length


def pack_array(a: np.ndarray) -> bytes:
    """Self-describing array payload: JSON dtype/shape header + raw bytes."""
    a = np.ascontiguousarray(a)
    hdr = json.dumps({"dtype": a.dtype.str, "shape": list(a.shape)}).encode()
    return _ARR_HDR.pack(len(hdr)) + hdr + a.tobytes()


def unpack_array_at(b: bytes, off: int = 0) -> tuple[np.ndarray, int]:
    """Decode one packed array at ``off``; returns (array, next offset)."""
    (hlen,) = _ARR_HDR.unpack_from(b, off)
    off += _ARR_HDR.size
    meta = json.loads(b[off:off + hlen])
    off += hlen
    dt = np.dtype(meta["dtype"])
    count = int(np.prod(meta["shape"])) if meta["shape"] else 1
    nbytes = count * dt.itemsize
    arr = np.frombuffer(b[off:off + nbytes], dtype=dt) \
        .reshape(meta["shape"]).copy()
    return arr, off + nbytes


def unpack_array(b: bytes) -> np.ndarray:
    return unpack_array_at(b, 0)[0]
