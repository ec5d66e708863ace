"""Deterministic simulated SSD with byte + latency accounting
(DESIGN.md §3).

The paper's evaluation is I/O-bound on a single NVMe SSD; foreground and
background (flush / compaction / GC) work share one device.  We therefore
model a single serialized I/O timeline: every block/file transfer advances a
simulated clock by a per-op fixed cost plus a per-byte cost.  Throughput
numbers in benchmarks are ``ops / simulated seconds``.  Absolute values are a
device model; the paper's *ratios* (x-improvements, amplification factors,
latency-percentage breakdowns) are what we validate.

Counters are kept per *category* so benchmarks can reproduce the paper's
figures (GC latency breakdown Fig.3, I/O reduction Fig.12(c)).
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

# I/O categories (used for the paper's breakdowns).
CAT_WAL = "wal"
CAT_FLUSH = "flush"
CAT_COMPACT_READ = "compact_read"
CAT_COMPACT_WRITE = "compact_write"
CAT_GC_READ = "gc_read"
CAT_GC_LOOKUP = "gc_lookup"
CAT_GC_WRITE = "gc_write"
CAT_GC_WRITE_INDEX = "gc_write_index"
CAT_FG_READ = "fg_read"
CAT_SCAN = "scan"

GC_CATS = (CAT_GC_READ, CAT_GC_LOOKUP, CAT_GC_WRITE, CAT_GC_WRITE_INDEX)


@dataclasses.dataclass
class DeviceModel:
    """NVMe-ish cost model (KIOXIA 500G class, ext4, direct I/O).

    Per-op overheads are amortized by the parallelism of the issuing lane:
    the compaction/flush pool (16 threads in the paper's setup) keeps a deep
    NVMe queue, while GC runs on a small dedicated pool (Titan/TerarkDB
    default 1-2 GC threads) and foreground point reads are latency-bound at
    queue depth ~1.  Sequential bandwidth is never multiplied — the device
    has one set of flash channels."""

    rand_read_op_us: float = 80.0      # 4K random-read latency floor
    seq_op_us: float = 10.0            # submission overhead for seq I/O
    read_gbps: float = 2.5             # sequential read bandwidth
    write_gbps: float = 1.2            # sequential write bandwidth
    cache_hit_us: float = 0.2          # CPU cost of a block-cache hit
    fg_qd_max: float = 16.0            # NVMe queue depth a batched user op
    #                                    can sustain (matches the bg pool's
    #                                    16 threads saturating one SSD)
    lane_parallelism: dict = dataclasses.field(
        default_factory=lambda: {"fg": 1.0, "bg": 8.0, "gc": 2.0})

    def rand_read_us(self, nbytes: int, lane: str = "fg") -> float:
        par = self.lane_parallelism.get(lane, 1.0)
        return (self.rand_read_op_us / par
                + nbytes / (self.read_gbps * 1e3))

    def seq_read_us(self, nbytes: int, lane: str = "fg") -> float:
        par = self.lane_parallelism.get(lane, 1.0)
        return self.seq_op_us / par + nbytes / (self.read_gbps * 1e3)

    def seq_write_us(self, nbytes: int, lane: str = "fg") -> float:
        par = self.lane_parallelism.get(lane, 1.0)
        return self.seq_op_us / par + nbytes / (self.write_gbps * 1e3)


class SimIO:
    """Two-lane device simulator with per-category accounting.

    The foreground lane carries user-op latencies (WAL appends, reads); the
    background lane carries flush/compaction/GC — 16 background threads
    saturating the device are modelled as one sequential lane at full device
    bandwidth.  The store's scheduler interleaves the lanes and converts
    background debt into foreground write stalls (L0/immutable triggers),
    which is the mechanism behind the paper's delayed-compaction analysis."""

    def __init__(self, device: DeviceModel | None = None):
        self.device = device or DeviceModel()
        self.lane = "fg"
        self.lanes = {"fg": 0.0, "bg": 0.0, "gc": 0.0}
        self.read_bytes = defaultdict(int)
        self.write_bytes = defaultdict(int)
        self.read_ops = defaultdict(int)
        self.write_ops = defaultdict(int)
        self.time_us = defaultdict(float)

    @property
    def clock_us(self) -> float:
        return max(self.lanes.values())

    @property
    def fg_clock_us(self) -> float:
        return self.lanes["fg"]

    @property
    def bg_clock_us(self) -> float:
        return self.lanes["bg"]

    @property
    def gc_clock_us(self) -> float:
        return self.lanes["gc"]

    def _advance(self, t: float, cat: str) -> float:
        self.time_us[cat] += t
        self.lanes[self.lane] += t
        return t

    @contextlib.contextmanager
    def batched(self, depth: int):
        """Issue foreground I/O at queue depth ``depth`` (capped).

        A multi-key user call (multi_get / multi_scan) submits its reads
        together, so the per-op latency floor amortizes across the batch —
        the same parallelism model the bg/gc lanes already use.  Sequential
        bandwidth is NOT multiplied (one set of flash channels); only the
        per-op overhead divides.  Nested contexts keep the deepest queue.
        """
        par = self.device.lane_parallelism
        prev = par.get("fg", 1.0)
        par["fg"] = max(prev, min(float(depth), self.device.fg_qd_max))
        try:
            yield
        finally:
            par["fg"] = prev

    # ------------------------------------------------------------------ I/O
    def rand_read(self, nbytes: int, cat: str) -> float:
        self.read_bytes[cat] += nbytes
        self.read_ops[cat] += 1
        return self._advance(self.device.rand_read_us(nbytes, self.lane),
                             cat)

    def seq_read(self, nbytes: int, cat: str) -> float:
        self.read_bytes[cat] += nbytes
        self.read_ops[cat] += 1
        return self._advance(self.device.seq_read_us(nbytes, self.lane),
                             cat)

    def seq_write(self, nbytes: int, cat: str) -> float:
        self.write_bytes[cat] += nbytes
        self.write_ops[cat] += 1
        return self._advance(self.device.seq_write_us(nbytes, self.lane),
                             cat)

    def cache_hit(self, cat: str, n: int = 1) -> float:
        t = 0.0
        # n separate advances (not one multiply): keeps the float clock
        # bit-identical whether hits are charged one by one or batched
        for _ in range(n):
            t += self._advance(self.device.cache_hit_us, cat)
        return t

    def stall(self, us: float, cat: str = "throttle") -> None:
        self._advance(us, cat)

    # ------------------------------------------------------------ summaries
    def total_read_bytes(self) -> int:
        return sum(self.read_bytes.values())

    def total_write_bytes(self) -> int:
        return sum(self.write_bytes.values())

    def gc_time_us(self) -> float:
        return sum(self.time_us[c] for c in GC_CATS)

    def snapshot(self) -> dict:
        return {
            "clock_us": self.clock_us,
            "lanes": dict(self.lanes),
            "read_bytes": dict(self.read_bytes),
            "write_bytes": dict(self.write_bytes),
            "read_ops": dict(self.read_ops),
            "write_ops": dict(self.write_ops),
            "time_us": dict(self.time_us),
        }

    @staticmethod
    def delta(after: dict, before: dict) -> dict:
        out = {}
        for field in ("read_bytes", "write_bytes", "read_ops", "write_ops",
                      "time_us", "lanes"):
            # .get({}) keeps old lane-less snapshots (pre-§11) subtractable
            af = after.get(field, {})
            bf = before.get(field, {})
            out[field] = {
                k: af.get(k, 0) - bf.get(k, 0)
                for k in set(af) | set(bf)
            }
        out["clock_us"] = after["clock_us"] - before["clock_us"]
        return out
