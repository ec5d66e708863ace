#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. build   — compile ``src/repro_torch/kernels/csrc/kernels.cu`` for
             sm_90a and load it;
2. kernels — each of the six CUDA kernels against its plain torch version
             on the card, at adversarial shapes (Q=1, N=0, N=1, duplicate
             keys, queries at the run's min and max, keys >= 2^32 and
             >= 2^63, coalesce columns past the shared-memory sort cap,
             coalesce keys of 0 to 64 bits and all pairs equal;
             empty, all-masked and out-of-range ids, one slot, slot
             counts either side of a CTA's range, an id column 8 bytes off
             a 16-byte boundary, the lifetime histogram's ids, every id on
             one slot, id columns that widen the range; D from 1 to
             4, W not a power of two, counters of 0.0 and -0.0 and patterns
             that differ only in the low 32 bits); ``lookup_probe``'s level
             form with empty and one-key runs, zero-query segments,
             segments straddling tiles, runs past the fence cap, k = 1..7
             and L0 tables holding the same keys, at four tile and stride
             choices; ``gather_min64``'s key form at widths 1, 3, 4,096 and
             4,097, depths 1 to 4 and keys 0, 2^63 and 2^64 - 1;
             ``segment_sum``'s key form (``sketch_add``) at depths 1 to 5
             and widths 1, 3, 4,096, 4,097 and 2^18 + 1, one key, equal
             keys, keys >= 2^63, with and without a decay factor, its
             scratch zero after each call; ``count_le`` and
             ``interval_rank`` at N 1, 2, 7, 8, 95, the shared-memory cap
             and one past it, queries equal to the bounds; ``rank_probe``'s
             run form either side of its staging threshold, at the
             whole-run staging cap and past it, staged and not, and its
             segmented form with empty runs and segments, one-key runs,
             one multi_get's vSST finds (400 runs of 2,600 keys), 1,200
             segments and a segment past one tile, at four tile and
             stride choices; outputs (the counters' bit patterns) must be
             equal exactly;
2b. bench  — the five kernels the store never routes to (``gc_lookup``,
             ``bloom_probe``, ``merge_dedup``, ``hot_cold_partition``,
             ``page_gather``) against their plain versions at the reference
             tests' shapes, the edges (empty, one, ragged tiles, all and no
             hot records, runs sharing every key, keys at 0xFFFFFFFD and the
             reference's pad values, merges ending either side of a merge
             tile and a key's two copies split by one, partitions either
             side of a partition tile and with only the last tile hot,
             GC-Lookup runs of 2^k - 1, 2^k and 2^k + 1 keys and with
             duplicate keys, operands 4 bytes off a 16-byte boundary;
             bloom k 0 to 17, Q 0 to 4,097, nbits below 32 words a word
             and no multiple of 32, and a 512 MiB filter of 2^32 - 1
             bits) and the ``deploy`` shapes of
             ``repro_torch.bench.kernels`` (the 1 GiB store's state): integer
             outputs equal exactly, pages bit for bit.  Then the kernel
             benchmark itself, ``repro_torch.bench.kernels.run("cuda",
             "all")``, with the five launch counts zeroed just before and
             read just after (each must be > 0), its rows on one line; and
             each kernel timed at its largest ``deploy`` shape beside its
             plain version, a PyTorch library call and its bound;
3. main    — one ``scavenger`` Store on the card at a 1 GiB dataset
             (2^20 keys x 1 KiB values, keys drawn from [0, 2^40)): load,
             one uniform update pass, 262,144 multi_get keys and 1,024 scans
             of 10, every acknowledged write read back and checked against
             the vids ``Store.write`` returned.  The four probe and fetch
             kernels' launch counts are zeroed just before and read just
             after; each must be > 0, and so must ``rank_probe``'s two
             forms' (the memtable probes and the vSST finds); the table
             probes that took the host path are counted beside them;
4. crossover — on the main run's store, the wall time of one routed call
             (upload, kernel, download) against the host NumPy path it
             replaces, per op and batch size: where routing starts to pay
             (``EngineConfig.kernel_min_batch``), for the four probe and
             fetch ops, a multi_get's vSST finds in one call against the
             host loop over its vSSTs, and the access tracker's three;
5. adaptive — one durable ``scavenger_adaptive`` Store on the card at the
             same 1 GiB scale: load 2^20 keys, one update pass of 2^20
             Zipf(0.99) ops with a checkpoint halfway and a crash injected
             late in the pass; ``Store.open(dir, device="cuda")`` recovers
             it and every acknowledged write reads back; the pass finishes,
             the store closes and reopens to the same ``stats()``.  All six
             kernels' launch counts are zeroed just before and read just
             after; each must be > 0, and so must ``segment_sum``'s two
             forms' (the sketches' ``sketch_add``, the lifetime
             histogram's index form);
6. shapes  — each kernel against its plain version again, on the largest
             inputs the main and adaptive runs gave it, timed with CUDA
             events beside its plain version, a PyTorch library call and
             its bound (``segment_sum`` in its key form, the largest
             sketch add); ``segment_sum``'s index form (the lifetime
             histogram's largest add), ``rank_probe``'s segmented form (at
             the largest vSST-find call), ``lookup_probe``'s table form (at
             the largest call's largest table) and ``gather_min64``'s
             index form (on the largest estimate, a form the main path no
             longer makes) are recorded on their own line;
7. parity  — the seven engines (``scavenger_adaptive`` with its tracker on
             and off) on the fixed mixed op stream of the reference
             package's parity test: the port on the card with kernels on
             (at the default routing threshold, and with every probe
             routed) against the port on the CPU with kernels off (stats,
             every multi_get vid, every scan row); then, on ``scavenger``
             and ``titan``, a 1-shard ``ShardedStore`` against ``Store`` on
             the card, and 3-shard ``range`` and ``hash`` fleets under the
             ``fleet`` and ``round_robin`` schedulers on the card against
             the same fleets on the CPU with kernels off;
8. crash   — the durability crash matrix on the card: seven engines x the
             five store crash points (the GC points only where the engine
             runs standalone GC), each recovered with ``Store.open(...,
             device="cuda")`` and held against an uninterrupted CPU run at
             the crash watermark; then the four fleet crash points
             (``mid_migration_copy``, ``pre_reroute`` and
             ``mid_delta_replay`` in a split, ``pre_promote`` in a
             failover) on ``scavenger`` and ``titan``, each fleet recovered
             with ``ShardedStore.open(..., device="cuda")`` and held against
             the latest-write oracle (the reference's
             ``tests/test_elastic_fleet.py`` matrix);
9. fleet   — the reference elasticity benchmark's fleet
             (``benchmarks/elasticity.py``) on the card: Pareto-1K values,
             a durable range fleet of 2 ``scavenger`` shards with one
             replica each, auto-split at a 55% space or traffic share
             (cooldown 2,048 ops, at most 4 shards), a 256 MiB dataset
             (2^18 keys; the source's 100 GB cut to 512 MiB and halved for
             the script's time limit) driven through
             ``repro_torch.workloads.Runner`` in
             batches of 4,096 under a static hotspot (90% of updates on an
             eighth of the keys; ``repro_torch.workloads.elastic.hot_seed``
             puts it in one shard): load, one update pass (the source's 3
             cut to 1) with a checkpoint halfway (timed on its own), its
             last 16 batches profiled for the device's idle share, a
             second checkpoint, ``fail_primary`` on the shard with the
             largest space share, then, in reads of 65,536 keys, 65,536
             multi_get keys, 1,024 scans of 1 to 100 rows, every
             acknowledged write read back, ``close`` and
             ``ShardedStore.open(dir, device="cuda")`` (same shard count
             and router), every write read back again.  It must migrate at
             least once and end with more than 2 shards; the four probe
             and fetch kernels' launch counts (primaries and replicas
             together: the counts are process-wide), zeroed just before,
             must each be > 0, and so must ``rank_probe``'s two forms'.

``python3 chip_smoke.py --crossover [--src DIR]`` runs phase 4 alone on a
smaller store (2^18 keys), against the port under ``DIR/repro_torch``
(default ``src``); ``python3 chip_smoke.py --kernel-times [--src DIR]``
only builds that port's library and times ``segment_sum`` (random ids,
and the lifetime histogram's: one a row of 32 slots) and
``gather_min64`` at the adaptive run's shapes, ``run_coalesce`` at M
from 64 to 8,192 beside ``torch.sort``, one level's table probes as the
store makes them (one level probe, or one launch a table on trees before
it) with the level form's tile and stride choices, the routed sketch
estimate, the routed sketch add at 4,096 and 1,024 keys, a routed
``AccessTracker.observe_writes`` of 4,096 keys, ``interval_rank`` at
10,942 queries over 1 to 2,048 files, ``rank_probe``'s run form at
10,096 queries over runs of 1 to 20,000 keys (staged and not), a
multi_get's vSST finds at 128 to 4,096 keys (the host loop, and the routed
call and the segmented kernel's tile and stride choices where the tree
has them), ``merge_dedup`` at the benchmark's two shapes, and
``hot_cold_partition``, ``gc_lookup`` and ``bloom_probe`` at the
benchmark's two shapes (the partition's device time split by launch,
``gc_lookup`` beside ``torch.searchsorted``, ``bloom_probe`` with the
filter in L2 and cold), and ``segment_sum`` over 1,018 to 2^20 ids into
1,024 to 2^25 slots (``segment_sum_shapes``: where its one launch gives
way to the atomic form), each as that tree makes it; ``--only
segment_sum,segment_sum_tracker,bloom_probe`` (the keys of its record)
times only those parts.
Run either on two trees in one call to compare them.

Each phase's end is logged on the script's clock (``[time]`` lines).
Device times come from the profiler, each kernel's mean over the launches
that three sessions recorded (late in a long process a session loses
some); one that no session recorded is taken by CUDA events, the calls
queued behind a spin kernel, and its record names it under
``events_timed``, as it names ``rank_probe``'s segmented plain version
(a loop of small launches a segment, timed by CUDA events).

The second-to-last line of output is the card's name and power limit, the
one before it the per-kernel JSON record (eleven kernels), the one before
that the records of the other forms; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense): HBM bytes/s, and float32 outside the
# tensor cores, the closest published rate for the kernels' integer work
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

ENGINES = ("rocksdb", "blobdb", "titan", "terarkdb", "scavenger", "hybrid",
           "scavenger_adaptive")
REPLACES = {
    "lookup_probe": "src/repro/kernels/lookup_probe/kernel.py:102",
    "rank_probe": "src/repro/kernels/lookup_probe/kernel.py:134",
    "count_le": "src/repro/kernels/lookup_probe/kernel.py:158",
    "run_coalesce": "src/repro/kernels/run_coalesce/kernel.py:47",
    "segment_sum": "src/repro/kernels/segment_reduce/kernel.py:47",
    "gather_min64": "src/repro/kernels/segment_reduce/kernel.py:93",
    "gc_lookup": "src/repro/kernels/gc_lookup/kernel.py:53",
    "bloom_probe": "src/repro/kernels/bloom/kernel.py:49",
    "merge_dedup": "src/repro/kernels/merge/kernel.py:49",
    "hot_cold_partition": "src/repro/kernels/partition/kernel.py:37",
    "page_gather": "src/repro/kernels/paged_gather/kernel.py:30",
}
# the kernels each run of the store must launch
MAIN_KERNELS = ("lookup_probe", "rank_probe", "count_le", "run_coalesce")
ADAPTIVE_KERNELS = MAIN_KERNELS + ("segment_sum", "gather_min64")
# the kernels the kernel benchmark must launch (no store path reaches them)
BENCH_KERNELS = ("gc_lookup", "bloom_probe", "merge_dedup",
                 "hot_cold_partition", "page_gather")
SOURCE = "src/repro_torch/kernels/csrc/kernels.cu"


def log(*a) -> None:
    print(*a, flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ------------------------------------------------------------- helpers
def call_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls, by
    CUDA events: host issue and device work together."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


# device function names of kernels.cu (the profiler reports them demangled)
CUDA_KERNELS = ("probe_kernel", "rank_search_kernel", "count_le_kernel",
                # the probes' and the merge's kernels on trees before
                # rank_probe's segmented form and the merge path, for
                # --kernel-times --src on such a tree
                "rank_probe_kernel", "lookup_probe_kernel",
                "merge_scatter_kernel", "merge_keep_kernel",
                "coalesce_radix_kernel", "pack_kernel", "bitonic_stage_kernel",
                # the one-CTA bitonic sort of trees before the radix sort,
                # for --kernel-times --src on such a tree
                "coalesce_smem_kernel",
                "mark_kernel", "segment_sum_kernel", "gather_min64_kernel",
                "sketch_scratch_kernel", "sketch_scale_kernel",
                # segment_sum's atomic form past its one-launch budget, and
                # its counts zeroed by a memset on the stream (the whole
                # index form on trees before the one launch)
                "segment_atomic_kernel", "Memset",
                "gc_lookup_kernel", "bloom_probe_kernel",
                "merge_path_kernel", "partition_count_kernel",
                "partition_place_kernel",
                # the partition's scan and scatter on trees before its two
                # launches, for --kernel-times --src on such a tree
                "partition_scan_kernel", "partition_scatter_kernel",
                "page_gather_kernel")


SPIN_TAIL_CYCLES = 2_000_000    # ~1 ms at the H100's 1.98 GHz boost clock
SPIN_CYCLES = 100_000_000       # ~50 ms


def kernel_records(fn, only=None) -> dict:
    """{name: (launches, device us)} of the kernels, copies and fills
    ``fn`` issues (those whose name contains one of ``only``, if given),
    from one profiling session.

    The session ends with a spin kernel of torch's own, which is not
    counted: late in a long process a session often loses its last
    records without it (PERF.md §7)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda._sleep(SPIN_TAIL_CYCLES)
        torch.cuda.synchronize()
    return {e.key: (e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "spin_kernel" not in e.key
            and (only is None or any(k in e.key for k in only))}


def device_busy_us(fn, only=None) -> float:
    """Device time (us) of what ``fn`` issues, from the profiler."""
    return sum(us for _, us in kernel_records(fn, only).values())


def idle_window(what: str, fn) -> dict:
    """The device's busy time and idle share over one call of ``fn`` (a
    run's batches, ending in a wait for the card): the profiler's CUDA
    records over a wall-clock window.  A window with no device time
    recorded fails: its idle share would say nothing."""
    import torch
    wall = []

    def window():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    us = device_busy_us(window)
    require(us > 0, f"{what}: the idle-share window recorded no device "
                    f"time")
    return {"device_busy_s": us / 1e6, "wall_s": wall[0],
            "idle_share": 1 - us / 1e6 / wall[0]}


# labels of the device times that no profiling session recorded, so that
# CUDA events took them (queued_ms); each record lists its own
EVENTS_TIMED: list = []
PROFILE_SESSIONS = 3


def queued_ms(fn, iters: int) -> float:
    """Mean device time (ms) per call of ``fn`` by CUDA events, the calls
    queued behind a spin kernel so that the host's issue time does not
    show (a call that waits for the card still shows its wait; the gaps
    between back-to-back kernels count)."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3, only=None,
              label: str = "") -> float:
    """Mean device time (ms) per call of ``fn`` (warm L2: the main path
    reprobes the same columns), from the profiler's records.

    Late in a long process a profiling session loses some of its records,
    whole launches and not parts of them (on the H100 machine, more the
    longer the process has run).  So each kernel's time per launch is the
    mean over every launch that ``PROFILE_SESSIONS`` sessions recorded, and
    its launches per call the most one session recorded over ``iters``,
    rounded (at least one).  If no session records anything,
    ``queued_ms`` takes the time and ``label`` goes into
    ``EVENTS_TIMED``."""
    for _ in range(warmup):
        fn()

    def loop():
        for _ in range(iters):
            fn()
    most, total = {}, {}
    for _ in range(PROFILE_SESSIONS):
        for key, (n, us) in kernel_records(loop, only).items():
            most[key] = max(most.get(key, 0), n)
            tn, tus = total.get(key, (0, 0.0))
            total[key] = (tn + n, tus + us)
    if not most:
        log(f"[profile] {label}: no session recorded device time; timed "
            f"by CUDA events instead")
        EVENTS_TIMED.append(label)
        return queued_ms(fn, iters)
    lost = {k: n for k, n in most.items() if n % iters}
    if lost:
        log(f"[profile] {label}: most launches a session recorded, of "
            f"{iters} calls: {json.dumps(lost)}")
    return sum(total[k][1] / total[k][0] * max(1, round(most[k] / iters))
               for k in most) / 1e3


def max_abs_err(got, want) -> int:
    """Largest absolute difference over paired integer/bool outputs."""
    import torch
    err = 0
    for g, w in zip(got, want):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"shape/dtype {tuple(g.shape)} {g.dtype} vs "
                f"{tuple(w.shape)} {w.dtype}")
        if g.numel():
            d = (g.to(torch.int64) - w.to(torch.int64)).abs().max()
            err = max(err, int(d))
    return err


def u64_tensor(a, device):
    import numpy as np
    import torch
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.uint64)).view(np.int64)).to(device)


# ----------------------------------------------------------- 1. build
def build_phase() -> None:
    from repro_torch.kernels import common
    t0 = time.perf_counter()
    so = common.build_library()
    common.library()
    log(f"[build] {so.name} in {time.perf_counter() - t0:.1f}s")
    tag = so.stem.rsplit("_", 1)[-1]
    blog = common.BUILD_DIR / f"build_{tag}.log"
    if blog.exists():
        for line in blog.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("[build] " + line.strip())


# --------------------------------------------------------- 2. kernels
def _check_probe_case(rng, device, n, q, hi, errs, *, dup=False,
                      edge=False):
    """One adversarial case for the three lookup-probe kernels."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.core.engine.keys import BloomFilter, hash_family

    def draw(size):
        return rng.integers(0, hi - 1, size, dtype=np.uint64, endpoint=True)
    keys = np.unique(draw(n))
    if dup and len(keys):
        keys = np.sort(np.concatenate([keys, keys[: max(1, len(keys) // 3)]]))
    qs = draw(q)
    if len(keys) and q:
        qs[: q // 3] = keys[rng.integers(0, len(keys), q // 3)]
        if edge:
            qs[0] = keys[0]
            qs[-1] = keys[-1]
    bf = BloomFilter(np.unique(keys), 10)
    bit_idx = (hash_family(qs, bf.k) % np.uint64(bf.nbits)).T
    # disjoint [min, max] intervals over the unique keys, as a level's files
    mins = np.unique(keys)
    maxs = mins.copy()
    if len(mins) > 1:
        maxs[:-1] += (mins[1:] - mins[:-1] - np.uint64(1)) // np.uint64(2)
    qt, rt = u64_tensor(qs, device), u64_tensor(keys, device)
    mt, xt = u64_tensor(mins, device), u64_tensor(maxs, device)
    bt, wt = u64_tensor(bit_idx, device), u64_tensor(bf.bits, device)
    errs["rank_probe"] = max(errs["rank_probe"], max_abs_err(
        kernels.rank_probe(qt, rt), kernels.rank_probe_ref(qt, rt)))
    errs["lookup_probe"] = max(errs["lookup_probe"], max_abs_err(
        kernels.lookup_probe(qt, rt, bt, wt),
        kernels.lookup_probe_ref(qt, rt, bt, wt)))
    errs["count_le"] = max(errs["count_le"], max_abs_err(
        (kernels.count_le(qt, rt),), (kernels.count_le_ref(qt, rt),)),
        max_abs_err((kernels.interval_rank(qt, mt, xt),),
                    (kernels.interval_rank_ref(qt, mt, xt),)))
    # host numpy searchsorted on u64 is an independent check of the rank
    rank = kernels.rank_probe(qt, rt)[1].cpu().numpy()
    require((rank == np.searchsorted(keys, qs)).all(),
            f"rank_probe disagrees with numpy at n={n} q={q} hi={hi}")
    cnt = kernels.count_le(qt, rt).cpu().numpy()
    require((cnt == np.searchsorted(keys, qs, side="right")).all(),
            f"count_le disagrees with numpy at n={n} q={q} hi={hi}")
    fidx = kernels.interval_rank(qt, mt, xt).cpu().numpy()
    want = np.full(q, -1)
    if len(mins):
        c = np.searchsorted(mins, qs, side="right") - 1
        want = np.where((c >= 0) & (qs <= maxs[np.maximum(c, 0)]), c, -1)
    require((fidx == want).all(),
            f"interval_rank disagrees with numpy at n={n} q={q} hi={hi}")


def _rank_segments_case(rng, sizes, counts, device):
    """Sorted unique runs of ``sizes`` keys over the u64 range and, per
    segment, ``counts`` queries (half run keys, 0 and 2^64 - 1 and the
    run's last key among them), grouped.  -> (args, runs, keys)."""
    import numpy as np
    runs = [np.unique(rng.integers(0, 2**64 - 1, n, dtype=np.uint64,
                                   endpoint=True)) for n in sizes]
    qs = []
    for run, c in zip(runs, counts):
        q = rng.integers(0, 2**64 - 1, c, dtype=np.uint64, endpoint=True)
        if len(run) and c:
            q[: c // 2] = run[rng.integers(0, len(run), c // 2)]
            q[: min(c, 3)] = np.array([0, 2**64 - 1, run[-1]],
                                      np.uint64)[: min(c, 3)]
        qs.append(q)
    keys = np.concatenate(qs) if qs else np.zeros(0, np.uint64)
    counts = np.asarray(counts, np.int64)
    args = (u64_tensor(keys, device), np.cumsum(counts) - counts, counts,
            [u64_tensor(r, device) for r in runs])
    return args, runs, keys


def _check_rank_cases(rng, device, errs):
    """``rank_probe``'s run form either side of its staging threshold, at
    the whole-run staging cap and past it, at the staged and global
    searches; its segmented form with empty runs and segments, one-key
    runs, the cap, one multi_get's vSST finds (400 runs of 2,600 keys, 10
    queries each; 1,530 runs of 630, 3 each), 1,200 segments and a
    segment past one tile, at the wrapper's shape and forced ones, and
    with a value row a run; against the plain versions and
    NumPy's ``searchsorted``, queries equal to every run key and
    0, 2^63 and 2^64 - 1."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.lookup_probe.ops import RUN_STAGE_MIN
    for n in (0, 1, 2, RUN_STAGE_MIN - 1, RUN_STAGE_MIN, 631, 2047, 2048,
              2049, 4097, 20000):
        run = np.unique(rng.integers(1, 2**64 - 2, n, dtype=np.uint64))
        qs = np.concatenate([run, run + np.uint64(1), run - np.uint64(1),
                             np.array([0, 2**63, 2**64 - 1], np.uint64),
                             rng.integers(0, 2**64 - 1, 10096,
                                          dtype=np.uint64, endpoint=True)])
        qt, rt = u64_tensor(qs, device), u64_tensor(run, device)
        want = kernels.rank_probe_ref(qt, rt)
        for stride in (None, 0, 1, 8):
            got = kernels.rank_probe(qt, rt, _stride=stride)
            errs["rank_probe"] = max(errs["rank_probe"],
                                     max_abs_err(got, want))
        require((got[1].cpu().numpy() == np.searchsorted(run, qs)).all(),
                f"rank_probe disagrees with numpy at n={n}")
    for sizes, counts in (([0, 30, 0, 40, 1], [5, 10, 3, 0, 4]),
                          ([1] * 50, [3] * 50),
                          ([2047, 2048, 2049], [700] * 3),
                          ([2600] * 400, [10] * 400),
                          ([630] * 1530, [3] * 1530),
                          ([30] * 1200, [4] * 1200),
                          ([20000, 5], [3000, 1500])):
        args, runs, keys = _rank_segments_case(rng, sizes, counts, device)
        want = kernels.rank_probe_segments_ref(*args)
        for kw in ({}, {"_tile": 32, "_stride": 2},
                   {"_tile": 1024, "_stride": 1}, {"_tile": 64,
                                                   "_stride": 64}):
            got = kernels.rank_probe_segments(*args, **kw)
            errs["rank_probe"] = max(errs["rank_probe"],
                                     max_abs_err(got, want))
        both = args[:3] + ([torch.stack([r, u64_tensor(rng.integers(
            0, 2**64 - 1, r.shape[0], dtype=np.uint64, endpoint=True),
            device)]) for r in args[3]],)
        for kw in ({}, {"_tile": 128, "_stride": 1}):
            errs["rank_probe"] = max(errs["rank_probe"], max_abs_err(
                kernels.rank_probe_segments(*both, values=True, **kw),
                kernels.rank_probe_segments_ref(*both, values=True)))
        rank, (_, starts, counts, _) = got[1].cpu().numpy(), args
        for s, run in enumerate(runs):
            seg = slice(starts[s], starts[s] + counts[s])
            require((rank[seg] == np.searchsorted(run, keys[seg])).all(),
                    f"rank_probe_segments disagrees with numpy at "
                    f"sizes={sizes[:3]}")


def _check_coalesce_case(rng, device, m, errs, hi_rank, hi_pos, *,
                         pin=False, equal=False):
    """Pairs below (hi_rank, hi_pos); ``pin``: the largest drawn, so the
    key's width is exactly the bits of hi - 1 each; ``equal``: every pair
    the same."""
    import numpy as np
    from repro_torch import kernels
    r = rng.integers(0, hi_rank, m).astype(np.int64)
    p = rng.integers(0, hi_pos, m).astype(np.int64)
    if pin:
        r[0], p[0] = hi_rank - 1, hi_pos - 1
    if equal:
        r[:], p[:] = r[0], p[0]
    if m > 2:
        r[-1], p[-1] = r[0], p[0]             # a duplicate pair
    rt, pt = u64_tensor(r, device), u64_tensor(p, device)
    for window in (None, 1, 3):
        got = kernels.run_coalesce(rt, pt, window=window)
        want = kernels.run_coalesce_ref(rt, pt, window)
        errs["run_coalesce"] = max(errs["run_coalesce"],
                                   max_abs_err(got, want))
        order = np.lexsort((p, r))
        require((got[0].cpu().numpy() == r[order]).all()
                and (got[1].cpu().numpy() == p[order]).all(),
                f"run_coalesce order disagrees with numpy at m={m}")


def _check_segment_cases(rng, device, errs):
    """segment_sum and gather_min64 at the reference tests' shapes
    (tests/test_kernels.py), the edge cases and the main-path sizes."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.common import segment_range
    for m, slots, lo, hi in ((0, 8, 0, 8), (1, 1, 0, 1), (13, 7, -1, 9),
                             (300, 64, -1, 66), (100, 1000, -1, 1002),
                             (64, 10, -1, 0), (50, 10, 10, 40), (40, 1, -1, 2),
                             (5, 0, -1, 3), (8192, 8192, 0, 8192),
                             (1024, 32768, 0, 32768), (20000, 4096, -5, 5000)):
        ids = rng.integers(lo, hi, m) if hi > lo else np.full(m, lo)
        t = torch.from_numpy(ids.astype(np.int64)).to(device)
        got = kernels.segment_sum(t, slots)
        errs["segment_sum"] = max(errs["segment_sum"], max_abs_err(
            (got,), (kernels.segment_sum_ref(t, slots),)))
        valid = ids[(ids >= 0) & (ids < slots)]
        require((got.cpu().numpy() == np.bincount(
            valid, minlength=slots)[:slots]).all(),
            f"segment_sum disagrees with numpy at m={m} slots={slots}")
    # the index form's one launch: slot counts either side of a CTA's
    # range (kernels.cu kSegRange), no ids, an id column 8 bytes off a
    # 16-byte boundary, the lifetime histogram's ids (one a row of 32),
    # every id on one slot; the one launch at its caps (4,096 ids, 131,072
    # slots) and the atomic form one past each, far more ids than slots,
    # and a long column into many slots
    r = segment_range()
    for m, slots, kind in ((1018, r - 1, ""), (1018, r, ""), (1018, r + 1, ""),
                           (1018, 2 * r + 1, ""), (0, r + 1, ""),
                           (300, r + 1, "shift"), (1018, 32576, "tracker"),
                           (4096, 1024, "one"), (4096, 131072, ""),
                           (4097, 1000, ""), (1018, 131073, ""),
                           (0, 131073, ""), (4097, 131073, "shift"),
                           (5000, 1024, "one"), (400000, 100000, ""),
                           (1 << 20, 1 << 25, "")):
        if kind == "tracker":
            ids = np.arange(m) * 32 + rng.integers(0, 32, m)
        elif kind == "one":
            ids = np.full(m, slots // 2)
        else:
            ids = rng.integers(-3, slots + 3, m)
        t = torch.from_numpy(ids.astype(np.int64)).to(device)
        if kind == "shift":
            t = torch.cat([t[:1], t])[1:]
        got = kernels.segment_sum(t, slots)
        errs["segment_sum"] = max(errs["segment_sum"], max_abs_err(
            (got,), (kernels.segment_sum_ref(t, slots),)))
        valid = ids[(ids >= 0) & (ids < slots)]
        require((got.cpu().numpy() == np.bincount(
            valid, minlength=slots)).all(),
            f"segment_sum disagrees with numpy at m={m} slots={slots} "
            f"{kind}")
    base = np.array([1.5], np.float64).view(np.uint64)[0]
    for d, w, q in ((1, 1, 1), (2, 50, 33), (4, 100, 64), (3, 7, 1),
                    (2, 4096, 1), (2, 4096, 4096), (4, 1000, 20000)):
        vals = rng.random((d, w)) * 1e6
        vals[rng.random((d, w)) < 0.2] = 0.0
        pat = vals.view(np.uint64)
        pat[0, 0] = np.array(-0.0).view(np.uint64)    # sign bit set
        if w > 1:                     # equal high words, low words differ
            pat[:, 1] = base + rng.integers(0, 9, d).astype(np.uint64)
        idx = rng.integers(0, w, (q, d))
        if w > 1:
            idx[0] = 1
        bt = torch.from_numpy(pat.view(np.int64).copy()).to(device)
        it = torch.from_numpy(idx).to(device)
        got = kernels.gather_min64(bt, it)
        errs["gather_min64"] = max(errs["gather_min64"], max_abs_err(
            (got,), (kernels.gather_min64_ref(bt, it),)))
        want = pat[np.arange(d)[None, :], idx].min(axis=1)   # u64 order
        require((got.cpu().numpy().view(np.uint64) == want).all(),
                f"gather_min64 disagrees with numpy at d={d} w={w} q={q}")


def _check_level_cases(rng, device, errs):
    """``lookup_probe``'s level form against its plain version (and the
    engine's ``BloomFilter`` and NumPy's ``searchsorted``): empty and
    one-key runs, zero-query segments, segments straddling tiles, runs past
    the fence cap (the stride widens), keys >= 2^63, k = 1..7, L0-style
    segments sharing rows over tables that hold the same keys; at the
    default tile and stride and at small ones."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.core.engine.keys import BloomFilter, hash_family
    bpk = {1: 1, 2: 3, 3: 4, 4: 6, 5: 7, 6: 9, 7: 10}
    cases = (  # run sizes, segment counts, k, key bound, shared rows
        ([500], [200], 7, 2**40, False),
        ([0, 300, 0, 1], [40, 60, 1, 5], 7, 2**64, False),
        ([1, 1, 1, 200], [50, 1, 30, 70], 7, 2**64, False),
        ([100, 200, 300, 50], [0, 120, 0, 0], 7, 2**40, False),
        ([3000, 2000, 12000], [600, 257, 1000], 7, 2**64, False),
        ([40] * 80, [51] * 80, 7, 2**40, False),
        ([12000, 11000, 9000, 5], [4000] * 4, 7, 2**40, True),
        ([2048 * 32 + 1, 70000], [3000, 2000], 7, 2**64, False),
        *(([900, 400, 0], [250, 150, 10], k, 2**64, k % 2 == 0)
          for k in range(1, 8)))
    for sizes, counts, k, hi, shared in cases:
        runs = [np.unique(rng.integers(0, hi - 1, n, dtype=np.uint64,
                                       endpoint=True)) for n in sizes]
        if shared and len(runs[0]):         # L0 tables holding one key set
            runs = [runs[0]] + [np.unique(np.concatenate(
                [r, runs[0][:50]])) for r in runs[1:]]
        blooms = [BloomFilter(r, bpk[k]) for r in runs]
        pool = np.concatenate(runs + [np.zeros(1, np.uint64)])
        keys = np.concatenate([pool[rng.integers(0, len(pool), 4000)],
                               rng.integers(0, hi - 1, 4000, dtype=np.uint64,
                                            endpoint=True)])
        keys[:3] = [0, 2**63, hi - 1]
        counts = np.asarray(counts, np.int64)
        if shared:
            rows = np.sort(rng.choice(len(keys), counts.max(), replace=False))
            starts = np.zeros(len(counts), np.int64)
            counts = np.full(len(counts), len(rows), np.int64)
        else:
            rows = rng.integers(0, len(keys), counts.sum())
            starts = np.cumsum(counts) - counts
        kraw = hash_family(keys, k)
        args = (u64_tensor(keys, device), u64_tensor(kraw, device),
                rows.astype(np.int64), starts, counts,
                [u64_tensor(r, device) for r in runs],
                [u64_tensor(b.bits, device) for b in blooms],
                [b.nbits for b in blooms])
        want = kernels.lookup_probe_segments_ref(*args)
        for tile, stride in ((512, 32), (32, 4), (1024, 1), (100, 8)):
            got = kernels.lookup_probe_segments(*args, _tile=tile,
                                                _stride=stride)
            errs["lookup_probe"] = max(errs["lookup_probe"],
                                       max_abs_err(got, want))
        may, found, rank = (t.cpu().numpy() for t in got)
        out = 0
        for s, (run, bf) in enumerate(zip(runs, blooms)):
            q = keys[rows[starts[s]:starts[s] + counts[s]]]
            seg = slice(out, out + len(q))
            out += len(q)
            pos = np.searchsorted(run, q)
            require((rank[seg] == pos).all()
                    and (may[seg] == bf.may_contain(q)).all()
                    and (found[seg] == ((pos < len(run)) & (run[np.minimum(
                        pos, max(len(run) - 1, 0))] == q) if len(run)
                        else False)).all(),
                    f"lookup_probe level form disagrees with numpy at "
                    f"sizes={sizes[:4]} k={k}")


def _check_sketch_add_cases(rng, device, errs):
    """``segment_sum``'s key form (``sketch_add``) against its plain version
    and the host's own arithmetic (``counts * f``, then ``+ bincount`` per
    row), bit for bit: depths 1 to 5, widths 1, 3, 4,096 and 4,097, tables
    of 2^18 slots and past, one key, all keys equal, keys >= 2^63, with
    and without a decay factor, decayed fractional counters, and a call
    with no keys (the scale alone).  The scratch must be zero after every
    call."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.engine.keys import splitmix64
    shapes = [(d, w, q) for w in (1, 3, 4096, 4097) for d in (1, 2, 3, 4, 5)
              for q in (1, 4096)]
    shapes += [(2, 1 << 17, 4096), (1, (1 << 18) + 1, 4096),
               (4, 70000, 20000), (2, 4096, 0)]
    for i, (d, w, q) in enumerate(shapes):
        vals = rng.random((d, w)) * 1e3
        vals[rng.random((d, w)) < 0.3] = 0.0
        keys = rng.integers(0, 2**64 - 1, q, dtype=np.uint64, endpoint=True)
        if i % 3 == 1 and q:
            keys[:] = keys[0]                 # every key in one slot a row
        elif i % 3 == 2:
            keys |= np.uint64(1 << 63)
        seeds = splitmix64(np.uint64(i) + np.arange(1, d + 1,
                                                     dtype=np.uint64))
        scale = 0.5 ** (float(i + 1) / 97.0) if i % 2 or not q else None
        kt, st = u64_tensor(keys, device), u64_tensor(seeds, device)
        got = torch.from_numpy(vals.copy()).to(device)
        want = got.clone()
        scratch = torch.zeros(d * w, dtype=torch.int32, device=device)
        kernels.sketch_add(got, kt, st, scale=scale, scratch=scratch)
        kernels.sketch_add_ref(want, kt, st, scale)
        errs["segment_sum"] = max(errs["segment_sum"], max_abs_err(
            (got.view(torch.int64),), (want.view(torch.int64),)))
        require(not bool(scratch.any()),
                f"sketch_add left its scratch non-zero at d={d} w={w}")
        idx = (splitmix64(keys[None, :] ^ seeds[:, None])
               % np.uint64(w)).astype(np.int64)
        host = vals * scale if scale is not None else vals.copy()
        for r in range(d):
            host[r] += np.bincount(idx[r], minlength=w)
        require((got.cpu().numpy().view(np.int64)
                 == host.view(np.int64)).all(),
                f"sketch_add disagrees with the host's add at d={d} w={w} "
                f"q={q}")


def _check_count_le_cap_cases(rng, device, errs):
    """``count_le`` and ``interval_rank`` with the level's bounds in shared
    memory (N 8, 95 and the cap) and in device memory (N 1, 2, 7 and cap +
    1): queries equal to every min and max, one either side of each, and
    0, 2^63 and 2^64 - 1."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.kernels.common import count_le_smem_files
    cap = count_le_smem_files()
    for n in (1, 2, 7, 8, 95, cap, cap + 1):
        edges = np.unique(rng.integers(1, 2**64 - 2, 4 * n, dtype=np.uint64))
        require(len(edges) >= 2 * n, "bound draw too small")
        mins, maxs = edges[0:2 * n:2], edges[1:2 * n:2]
        maxs[: n // 3] = mins[: n // 3]       # one-key intervals
        edge = np.array([0, 2**63, 2**64 - 1], np.uint64)
        qs = np.concatenate([mins, maxs, mins - np.uint64(1),
                             maxs + np.uint64(1), edge,
                             rng.integers(0, 2**64 - 1, 10942,
                                          dtype=np.uint64, endpoint=True)])
        qt, mt, xt = (u64_tensor(a, device) for a in (qs, mins, maxs))
        got_c, got_i = kernels.count_le(qt, mt), kernels.interval_rank(
            qt, mt, xt)
        errs["count_le"] = max(
            errs["count_le"],
            max_abs_err((got_c,), (kernels.count_le_ref(qt, mt),)),
            max_abs_err((got_i,), (kernels.interval_rank_ref(qt, mt, xt),)))
        cnt = np.searchsorted(mins, qs, side="right")
        fidx = np.where((cnt > 0) & (qs <= maxs[np.maximum(cnt - 1, 0)]),
                        cnt - 1, -1)
        require((got_c.cpu().numpy() == cnt).all()
                and (got_i.cpu().numpy() == fidx).all(),
                f"count_le / interval_rank disagree with numpy at n={n}")


def _check_estimate_cases(rng, device, errs):
    """``gather_min64``'s key form (``sketch_estimate``) against its plain
    version and the sketch's NumPy row hash: widths 1, 3, 4,096 and 4,097,
    depths 1 to 4, keys 0, 2^63 and 2^64 - 1, counters of 0.0 and -0.0 and
    patterns equal in their high words."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.engine.keys import splitmix64
    base = np.array([1.5], np.float64).view(np.uint64)[0]
    for w in (1, 3, 4096, 4097):
        for d in (1, 2, 3, 4):
            vals = rng.random((d, w)) * 1e6
            vals[rng.random((d, w)) < 0.2] = 0.0
            pat = vals.view(np.uint64)
            pat[0, 0] = np.array(-0.0).view(np.uint64)
            if w > 1:
                pat[:, 1] = base + rng.integers(0, 9, d).astype(np.uint64)
            seeds = splitmix64(np.uint64(w) + np.arange(1, d + 1,
                                                        dtype=np.uint64))
            keys = rng.integers(0, 2**64 - 1, 20000, dtype=np.uint64,
                                endpoint=True)
            keys[:3] = [0, 2**63, 2**64 - 1]
            bt = torch.from_numpy(pat.view(np.int64).copy()).to(device)
            kt, st = u64_tensor(keys, device), u64_tensor(seeds, device)
            got = kernels.sketch_estimate(bt, kt, st)
            errs["gather_min64"] = max(errs["gather_min64"], max_abs_err(
                (got,), (kernels.sketch_estimate_ref(bt, kt, st),)))
            idx = splitmix64(keys[None, :] ^ seeds[:, None]) % np.uint64(w)
            want = pat[np.arange(d)[:, None], idx.astype(np.int64)].min(0)
            require((got.cpu().numpy().view(np.uint64) == want).all(),
                    f"sketch_estimate disagrees with numpy at d={d} w={w}")


def kernel_phase(device) -> dict:
    """Adversarial shapes; -> max abs error per kernel (all must be 0)."""
    import numpy as np
    from repro_torch.kernels.common import smem_sort_cap
    rng = np.random.default_rng(7)
    errs = {k: 0 for k in ADAPTIVE_KERNELS}
    cap = smem_sort_cap()
    for n, q, hi, kw in (
            (0, 1, 2**20, {}), (1, 1, 2**20, {"edge": True}),
            (1, 37, 4, {"edge": True}), (0, 300, 2**40, {}),
            (5000, 1, 2**40, {"edge": True}),
            (4096, 4096, 2**33, {"edge": True}),
            (4096, 999, 2**64, {"edge": True}),
            (3000, 700, 2**40, {"dup": True, "edge": True}),
            (100, 4096, 2**64, {"dup": True, "edge": True}),
            (20000, 4096, 2**40, {"edge": True})):
        _check_probe_case(rng, device, n, q, hi, errs, **kw)
    for m, hr, hp in ((1, 4, 4), (2, 1, 2), (3, 2, 2), (100, 3, 50),
                      (1000, 400, 2**16), (4096, 400, 3000),
                      (cap, 1000, 2**32 - 2), (cap + 1, 10, 2**20),
                      (20000, 2**32 - 2, 200)):
        _check_coalesce_case(rng, device, m, errs, hr, hp)
    # the one-CTA radix sort's key widths: all 64 bits in use (8 passes),
    # exactly 32 and 33 (the u32/u64 key switch), pos_bits 32 and 0 in a
    # u32 key, one bit; every pair equal, every pair (0, 0) (no pass)
    for m, hr, hp in ((4096, 2**32 - 1, 2**32 - 1), (cap, 2**32 - 1, 2**32 - 1),
                      (4096, 2**12, 2**20), (4096, 2**13, 2**20),
                      (4096, 1, 2**32 - 1), (4096, 2**32 - 1, 1), (cap, 2, 2)):
        _check_coalesce_case(rng, device, m, errs, hr, hp, pin=True)
    for m, hr, hp in ((1000, 400, 2**16), (4096, 1, 1), (cap, 2**32 - 1, 5)):
        _check_coalesce_case(rng, device, m, errs, hr, hp, equal=True)
    _check_count_le_cap_cases(rng, device, errs)
    _check_rank_cases(rng, device, errs)
    _check_segment_cases(rng, device, errs)
    _check_sketch_add_cases(rng, device, errs)
    _check_level_cases(rng, device, errs)
    _check_estimate_cases(rng, device, errs)
    log("[kernels] max abs err at adversarial shapes: " + json.dumps(errs))
    for k, e in errs.items():
        require(e == 0, f"kernel {k} disagrees with its plain version")
    return errs


# ----------------------------------------------------------- 2b. bench
def _bits(t):
    """A float tensor's bit pattern as an integer tensor (bit-for-bit
    comparison); integer and bool tensors as they are."""
    import torch
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def _hold(name, args, errs) -> tuple:
    """One kernel call against its plain version on the same operands.
    -> the kernel's outputs."""
    from repro_torch import kernels
    got = _as_tuple(getattr(kernels, name)(*args))
    want = _as_tuple(getattr(kernels, name + "_ref")(*args))
    errs[name] = max(errs[name], max_abs_err([_bits(g) for g in got],
                                             [_bits(w) for w in want]))
    return got


def _bench_kernel_checks(rng, device, errs) -> None:
    """The reference tests' parametrizations (tests/test_kernels.py) and the
    edges, each kernel against its plain version, with independent NumPy
    checks where they are cheap."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.common import (merge_threads, partition_tile,
                                            u32_tensor)
    from repro_torch.kernels.merge.ops import ITEMS as MERGE_ITEMS

    def u32(*cols):
        return tuple(u32_tensor(np.asarray(c), device) for c in cols)

    def u32_at(a, shift):
        """A column whose data starts ``shift`` elements past an
        allocation's start (shift 1: 4 bytes off a 16-byte boundary)."""
        t = u32_tensor(np.concatenate([np.zeros(shift, np.uint32),
                                       np.asarray(a, np.uint32)]), device)
        return t[shift:]

    top = 0xFFFFFFFD                   # largest key the reference accepts
    # gc_lookup: the reference's (q, n) cases, then the edges: runs around
    # the search's round and finish sizes (2^k - 1, 2^k, 2^k + 1), runs
    # with duplicate keys ("dup-n": cut back to exactly n keys), keys and
    # queries at the top of u32, and a key column 4 bytes off a 16-byte
    # boundary (the scalar loads)
    around = tuple((512, m, "") for k in (3, 4, 5, 6, 7, 10, 16)
                   for m in ((1 << k) - 1, 1 << k, (1 << k) + 1))
    for q, n, kind in ((1, 10, ""), (17, 100, ""), (300, 1000, ""),
                       (256, 512, ""), (5, 2000, ""), (5, 0, ""),
                       (0, 50, ""), (1, 1, ""), (700, 3000, "dup"),
                       (600, 3000, "top"), (4097, 70000, ""),
                       (64, 2, ""), (64, 7, "dup-n"), (512, 65536, "dup-n"),
                       (512, 4096, "top"), (512, 1023, "shift"),
                       (512, 65537, "shift"), (64, 9, "shift")) + around:
        keys = np.sort(rng.choice(np.arange(1, 10 * max(n, 1) + 2,
                                            dtype=np.uint32), n,
                                  replace=False))
        if kind.startswith("dup"):
            keys = np.sort(np.concatenate([keys, keys[::5]]))
        if kind == "dup-n":
            keys = keys[:n]
        if kind == "top":
            keys[-3:] = [top - 2, top - 1, top]
        qs = np.concatenate([rng.choice(keys, q // 2) if n else keys[:0],
                             rng.integers(0, 1 << 32, q, dtype=np.uint64)
                             .astype(np.uint32)])[:q]
        if kind == "top" and q > 4:
            qs[:4] = [top, top - 1, 0xFFFFFFFE, 0xFFFFFFFF]
        vids = (keys * 3 + 1).astype(np.uint32)
        args = u32(qs, keys, vids, keys) if kind != "shift" else (
            u32_at(qs, 1), u32_at(keys, 1), u32_at(vids, 3),
            u32_at(keys, 2))
        found, vid, _ = _hold("gc_lookup", args, errs)
        pos = np.searchsorted(keys, qs)
        hit = np.zeros(len(qs), bool) if not n else \
            keys[np.minimum(pos, len(keys) - 1)] == qs
        require((found.cpu().numpy() == hit).all()
                and (vid.cpu().numpy().view(np.uint32)[hit]
                     == vids[pos[hit]]).all(),
                f"gc_lookup disagrees with numpy at q={q} n={n} {kind}")
    # bloom: the reference's (n, q) cases, no probes, one probe, top keys
    for n, q, kind in ((10, 5, ""), (1000, 300, ""), (5000, 1000, ""),
                       (100, 0, ""), (100, 1, ""), (64, 40, "top")):
        keys = rng.choice(np.arange(1, 1 << 24, dtype=np.uint32), n,
                          replace=False)
        if kind == "top":
            keys[:4] = [0xFFFFFFFF, 0xFFFFFFFE, 0x80000000, 0x7FFFFFFF]
        words, k, nbits = kernels.bloom_build(*u32(keys))
        probes = np.concatenate([keys[:q // 2], rng.integers(
            1 << 24, 1 << 25, q - q // 2).astype(np.uint32)])
        (may,) = _hold("bloom_probe", (*u32(probes), words, k, nbits), errs)
        require(bool(may[:q // 2].all()), f"bloom false negative at n={n}")
    # bloom: k either side of the kernel's batch of 8 word loads, query
    # counts around a warp, nbits below 32 * len(words) and no multiple of
    # 32; and once with operands 4 bytes off a 16-byte boundary (the
    # kernel loads 4-byte words only)
    dense = np.bitwise_or.reduce(         # 7/8 of the bits set
        rng.integers(0, 1 << 32, (3, 1000), dtype=np.uint64)).astype(np.uint32)
    for k, q, shift in (*((k, q, 0) for k in (0, 1, 3, 7, 8, 9, 17)
                          for q in (0, 1, 31, 33, 4097)), (7, 4097, 1)):
        qs = rng.integers(0, 1 << 32, q, dtype=np.uint64).astype(np.uint32)
        ops = (u32_at(qs, shift), u32_at(dense, shift))
        for nbits in (32 * 1000, 32 * 1000 - 5, 997):
            _hold("bloom_probe", (*ops, k, nbits), errs)
    # nbits 2^32 - 1 (2^27 words, 512 MiB): the wrap and the fast modulo at
    # the top of u32
    top_words = torch.randint(-(1 << 31), 1 << 31, (1 << 27,),
                              dtype=torch.int32, device=device)
    for _ in range(2):
        top_words |= torch.randint(-(1 << 31), 1 << 31, (1 << 27,),
                                   dtype=torch.int32, device=device)
    qs = rng.integers(0, 1 << 32, 4097, dtype=np.uint64).astype(np.uint32)
    for k in (1, 7, 17):
        _hold("bloom_probe", (*u32(qs), top_words, k, (1 << 32) - 1), errs)
    del top_words
    # merge: the reference's (na, nb) cases, then empty runs, runs sharing
    # every key, rows equal in key and seq, key 0xFFFFFFFF; then the merge
    # path's tiles (the largest, of 8 rows a thread; every choice of rows a
    # thread is held on each case): runs ending either side of a tile
    # boundary, a key's two copies on either side of one (pair k at rows
    # 2k - 1 and 2k), and the deploy size
    tile = merge_threads() * 8
    for na, nb, kind in ((1, 1, ""), (10, 3, ""), (100, 100, ""),
                         (64, 257, ""), (0, 0, ""), (0, 5, ""), (5, 0, ""),
                         (300, 300, "shared"), (300, 300, "equal"),
                         (40, 30, "top"), (5000, 7000, ""),
                         (tile, tile, ""), (tile - 1, tile + 1, ""),
                         (0, tile + 1, ""), (3, 2 * tile - 3, ""),
                         (tile + 1, tile, "split"), (4097, 4096, "split"),
                         (1 << 19, 1 << 19, "")):
        ak = np.sort(rng.choice(np.arange(4 * (na + nb) + 4,
                                          dtype=np.uint32), na, replace=False))
        bk = np.sort(rng.choice(np.arange(4 * (na + nb) + 4,
                                          dtype=np.uint32), nb, replace=False))
        aseq = rng.integers(0, 1000, na).astype(np.uint32) * 2
        bseq = rng.integers(0, 1000, nb).astype(np.uint32) * 2 + 1
        if kind in ("shared", "equal"):
            bk = ak.copy()
            bseq = aseq.copy() if kind == "equal" else aseq + 1
        if kind == "top":
            ak[-1] = bk[-1] = 0xFFFFFFFF
        if kind == "split":
            ak = np.arange(na, dtype=np.uint32)
            bk = ak[1:nb + 1].copy()
            bseq = aseq[1:nb + 1] + 1
        args = u32(ak, aseq, ak + 1, bk, bseq, bk + 2)
        keys, _, _, keep = _hold("merge_dedup", args, errs)
        want = kernels.merge_dedup_ref(*args)
        for items in MERGE_ITEMS:
            errs["merge_dedup"] = max(errs["merge_dedup"], max_abs_err(
                kernels.merge_dedup(*args, _items=items), want))
        kk = keys.cpu().numpy().view(np.uint32)
        require(bool((np.diff(kk.astype(np.int64)) >= 0).all())
                and int(keep.sum()) == len(np.union1d(ak, bk)),
                f"merge_dedup disagrees with numpy at {na}+{nb} {kind}")
    # partition: the reference's sizes, then empty, all hot, none hot and
    # a ragged last tile; then the tiles: either side of one, three and a
    # ragged fourth (all hot, none hot, only the last tile hot), and
    # operands 4 bytes off a 16-byte boundary (the scalar loads)
    tile = partition_tile()
    for n, share in ((1, .3), (7, .3), (64, .3), (500, .3), (0, .3),
                     (5000, 1.), (5000, 0.), (1025, .3), (70001, .3),
                     (tile - 1, .3), (tile, .3), (tile + 1, .3),
                     (3 * tile + 5, .3), (3 * tile + 5, 1.),
                     (3 * tile + 5, 0.), (3 * tile + 5, "last"),
                     (2 * tile, "last"), (3 * tile + 5, "shift"),
                     (tile - 3, "shift")):
        hot = rng.random(n) < (.3 if isinstance(share, str) else share)
        if share == "last":
            hot[:(n - 1) // tile * tile] = False
        keys = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        if share == "shift":
            h = torch.from_numpy(np.concatenate([[True], hot])).to(device)
            args = (u32_at(keys, 1), h[1:], u32_at(np.arange(n), 3),
                    u32_at(np.full(n, 100), 2))
        else:
            args = (*u32(keys), torch.from_numpy(hot).to(device),
                    *u32(np.arange(n), np.full(n, 100)))
        out = _hold("hot_cold_partition", args, errs)
        order = np.argsort(~hot, kind="stable")
        require(int(out[3][0]) == int(hot.sum())
                and (out[0].cpu().numpy().view(np.uint32)
                     == keys[order]).all(),
                f"hot_cold_partition disagrees with numpy at n={n} {share}")
    # page_gather: the reference's cases, then a page of 30 bytes
    for b, p, npages, psize, d, dtype in (
            (1, 1, 4, 8, 128, torch.float32), (4, 8, 64, 16, 128,
                                                torch.float32),
            (2, 4, 16, 8, 64, torch.bfloat16), (3, 5, 32, 4, 256,
                                                 torch.int32),
            (2, 3, 5, 3, 5, torch.bfloat16)):
        pages = (torch.from_numpy(rng.standard_normal((npages, psize, d)))
                 * 10).to(dtype).to(device)
        table = torch.from_numpy(rng.integers(0, npages, (b, p)).astype(
            np.int32))
        (out,) = _hold("page_gather", (table, pages), errs)
        want = pages.cpu()[table.long()].reshape(b, p * psize, d)
        require(torch.equal(_bits(out.cpu()), _bits(want)),
                f"page_gather disagrees with torch indexing at {b}x{p}")


def bench_phase(device) -> list:
    """The five benchmark kernels: checks, the benchmark run with their
    launch counts, and their records at the deploy shapes."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.bench import kernels as bench
    rng = np.random.default_rng(15)
    errs = {k: 0 for k in BENCH_KERNELS}
    t0 = time.perf_counter()
    _bench_kernel_checks(rng, device, errs)
    deploy = bench.deploy_cases()
    for case in bench.bench_cases() + deploy:
        _hold(case.kernel, bench.operands(case, device), errs)
    log("[bench] max abs err at the reference's, edge and deploy shapes: "
        + json.dumps(errs) + f" ({time.perf_counter() - t0:.1f}s)")
    for k, e in errs.items():
        require(e == 0, f"kernel {k} disagrees with its plain version")

    # the path: the kernel benchmark, counts zeroed just before
    for fn in kernels.KERNELS:
        fn.launches = 0
    t0 = time.perf_counter()
    rows = bench.run(device, "all")
    launches = {k: getattr(kernels, k).launches for k in BENCH_KERNELS}
    print(json.dumps({"bench_rows": rows}), flush=True)
    log(f"[bench] launches: {json.dumps(launches)} "
        f"({time.perf_counter() - t0:.1f}s)")
    for k, n in launches.items():
        require(n > 0, f"kernel {k} was not launched by the kernel benchmark")

    # records at each kernel's largest deploy shape (page_gather: the f32
    # pool, whose 60 MB of traffic exceeds the 50 MB L2; the bf16 pool's
    # fits, so its warm-L2 time can beat the bytes bound)
    largest = {}
    for case in deploy:
        if case.nbytes > getattr(largest.get(case.kernel), "nbytes", -1):
            largest[case.kernel] = case
    recs = []
    m32 = -(1 << 31)                   # int32 XOR: u32 order as signed order
    for case in largest.values():
        args = bench.operands(case, device)
        kern = (lambda f, a: lambda: f(*a))(bench.wrapper(case), args)
        plain = (lambda f, a: lambda: f(*a))(bench.plain(case), args)
        if case.kernel == "gc_lookup":
            qo, ko = args[0] ^ m32, args[1] ^ m32
            lib = (lambda: torch.searchsorted(ko, qo))
        elif case.kernel == "merge_dedup":
            cat = torch.cat([args[0], args[3]]) ^ m32
            lib = (lambda: torch.sort(cat))
        elif case.kernel == "hot_cold_partition":
            cold = (~args[1]).to(torch.uint8)
            lib = (lambda: torch.argsort(cold, stable=True))
        elif case.kernel == "page_gather":
            tab, pages = args[0].reshape(-1).to(device), args[1]
            lib = (lambda: pages.index_select(0, tab))
        else:
            lib = None
        err = max_abs_err([_bits(g) for g in _as_tuple(kern())],
                          [_bits(w) for w in _as_tuple(plain())])
        require(err == 0, f"{case.kernel} disagrees with its plain version "
                          f"at the deploy shape")
        bound_ms, bound_by = _bound(case.nbytes, case.nops)
        n0, name = len(EVENTS_TIMED), case.kernel
        rec = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[name],
               "launches": launches[name], "max_abs_err": err,
               "ms": device_ms(kern, only=CUDA_KERNELS, label=f"{name} ms"),
               "plain_ms": device_ms(plain, iters=5,
                                     label=f"{name} plain_ms"),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": device_ms(lib, label=f"{name} library_ms")
               if lib is not None else None,
               "call_ms": call_ms(kern), "shape": case.shape}
        rec["events_timed"] = EVENTS_TIMED[n0:]
        log(f"[bench] {json.dumps(rec)}")
        recs.append(rec)
    return recs


# ------------------------------------------------------------ 3. main
class Capture:
    """Keeps a copy of the largest inputs the store runs give each kernel
    (wraps the package-level wrappers that ``core/accel.py`` and
    ``core/adaptive/`` call), and tallies the level probes' shapes."""

    NAMES = ("rank_probe", "rank_probe_segments", "lookup_probe_segments",
             "interval_rank", "run_coalesce", "segment_sum", "sketch_add",
             "sketch_estimate")

    def __init__(self):
        import repro_torch.kernels as K
        from repro_torch.core import EngineConfig
        self.K = K
        self.orig = {n: getattr(K, n) for n in self.NAMES}
        self.best: dict = {}
        # level probes: calls, rows, segments and slots over all calls, and
        # by segment count the calls whose every segment is under the
        # routing floor (routed since the level's rows decide)
        self.floor = EngineConfig.kernel_min_batch
        self.levels = {"calls": 0, "rows": 0, "segments": 0, "slots": 0,
                       "under_floor_by_segments": {}}

    def __enter__(self):
        for n in self.NAMES:
            setattr(self.K, n, self._wrap(n, self.orig[n]))
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.K, n, f)

    @staticmethod
    def _copy(a):
        if hasattr(a, "clone"):
            return a.clone()
        return a.copy() if hasattr(a, "copy") else a

    def _wrap(self, name, fn):
        def call(*args, **kw):
            if name == "segment_sum":     # ids + slots
                size = args[0].shape[0] + args[1]
            elif name in ("sketch_estimate", "sketch_add"):
                size = args[0].numel() + args[1].numel()  # table + keys
            elif name == "rank_probe_segments":       # keys found
                size = int(sum(args[2]))
            elif name == "lookup_probe_segments":     # slots probed
                size = int(sum(args[4]))
                lv = self.levels
                lv["calls"] += 1
                lv["rows"] += len(args[2])
                lv["segments"] += len(args[4])
                lv["slots"] += size
                if max(args[4], default=0) < self.floor:
                    by, n = lv["under_floor_by_segments"], str(len(args[4]))
                    by[n] = by.get(n, 0) + 1
            else:   # work ~ queries x run length (first two operands)
                size = args[0].shape[0] * (args[1].shape[0] + 1)
            if name not in self.best or size > self.best[name][0]:
                self.best[name] = (size, [self._copy(a) for a in args], kw)
            return fn(*args, **kw)
        return call


def main_run(device, *, dataset_bytes=1 << 30, n_keys=1 << 20,
             key_space=1 << 40, vsize=1024, update_passes=1,
             n_gets=1 << 18, n_scans=1024, scan_len=10, batch=4096,
             seed=0, capture=None) -> dict:
    """Drive one scavenger Store; check every read; -> phase metrics."""
    import numpy as np
    import torch
    from repro_torch.core import EngineConfig, Store, WriteBatch
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, key_space, n_keys + n_keys // 8,
                                  dtype=np.uint64))
    require(len(keys) >= n_keys, "key draw too small")
    keys = rng.permutation(keys[:n_keys])
    sorted_keys = np.sort(keys)
    cfg = EngineConfig.scaled("scavenger", dataset_bytes, est_keys=n_keys)
    store = Store(cfg, device=device)
    latest: dict[int, int] = {}
    vs = np.full(batch, vsize, np.int64)
    phases = {}

    def timed(name, n_ops, fn):
        sync()
        t0 = time.perf_counter()
        clock0 = store.io.clock_us
        fn()
        sync()
        dt = time.perf_counter() - t0
        dsim = (store.io.clock_us - clock0) / 1e6
        phases[name] = {"ops": n_ops, "host_s": dt,
                        "host_ops_s": n_ops / dt,
                        "sim_s": dsim,
                        "sim_ops_s": n_ops / dsim if dsim > 0 else None}
        log(f"[main] {name}: {n_ops} ops in {dt:.2f}s host "
            f"({n_ops / dt:.0f} ops/s), simulated device {dsim:.3f}s")

    def write_pass(order):
        for i in range(0, len(order), batch):
            ks = order[i:i + batch]
            vids = store.write(WriteBatch().puts(ks, vs[:len(ks)]))
            require(len(vids) == len(ks) and (vids > 0).all(),
                    "write returned no vid")
            latest.update(zip(ks.tolist(), vids.tolist()))

    def check_gets(ks, res):
        want = np.fromiter((latest[k] for k in ks.tolist()), np.uint64,
                           count=len(ks))
        require(bool(res["found"].all()), "acknowledged key not found")
        require(bool((res["vid"] == want).all()),
                "multi_get returned a stale or wrong vid")

    def gets(n):
        ks_all = keys[rng.integers(0, n_keys, n)]
        for i in range(0, n, batch):
            ks = ks_all[i:i + batch]
            check_gets(ks, store.multi_get(ks))

    def scans():
        starts = rng.integers(0, key_space, n_scans).astype(np.int64)
        for i in range(0, n_scans, batch):
            st = starts[i:i + batch]
            rows = store.multi_scan(st, scan_len)
            for s, row in zip(st.tolist(), rows):
                a = int(np.searchsorted(sorted_keys, np.uint64(s)))
                want = sorted_keys[a:a + scan_len].tolist()
                require([k for k, _ in row] == want,
                        f"scan from {s} returned the wrong keys")
                require(all(v == latest[k] for k, v in row),
                        f"scan from {s} returned a wrong vid")

    from repro_torch import kernels
    from repro_torch.core.read.lookup import lookup_entries
    for fn in kernels.KERNELS + (kernels.rank_probe_segments,):
        fn.launches = 0
    lookup_entries.host_table_probes = 0
    with capture if capture is not None else contextlib.nullcontext():
        timed("load", n_keys, lambda: write_pass(keys))
        for u in range(update_passes):
            timed(f"update{u}", n_keys,
                  lambda: write_pass(rng.permutation(keys)))
        timed("multi_get", n_gets, lambda: gets(n_gets))
        timed("multi_scan", n_scans, scans)
    launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    # rank_probe's two forms: the memtable probes and the vSST finds
    by_form = {"run": launches["rank_probe"]
               - kernels.rank_probe_segments.launches,
               "segments": kernels.rank_probe_segments.launches}
    host_probes = lookup_entries.host_table_probes
    log("[main] launches: " + json.dumps(launches)
        + f"; rank_probe by form: {json.dumps(by_form)}"
        + f"; table probes on the host path: {host_probes}")

    def readback():
        for i in range(0, n_keys, batch):
            ks = keys[i:i + batch]
            check_gets(ks, store.multi_get(ks))
    timed("readback", n_keys, readback)
    st = store.stats()

    busy = {}
    if cuda:
        # device busy share of 16 update and 16 multi_get batches
        busy["update"] = idle_window(
            "main update",
            lambda: write_pass(rng.permutation(keys)[:16 * batch]))
        busy["multi_get"] = idle_window("main multi_get",
                                        lambda: gets(16 * batch))
    out = {"phases": phases, "launches": launches,
           "rank_probe_by_form": by_form,
           "host_table_probes": host_probes, "device_busy": busy,
           "space_amp": st["space_amp"], "write_amp": st["write_amp"],
           "n_gc_runs": st["n_gc_runs"], "n_compactions": st["n_compactions"],
           "sim_clock_s": st["clock_s"]}
    log("[main] " + json.dumps(out))
    return out, store


# -------------------------------------------------------- 5. adaptive
def adaptive_run(device, *, dataset_bytes=1 << 30, n_keys=1 << 20,
                 key_space=1 << 40, vsize=1024, batch=4096, theta=0.99,
                 crash_point="mid_compaction", seed=3,
                 capture=None) -> dict:
    """Drive one durable scavenger_adaptive Store through a crash and two
    recoveries; check every acknowledged write; -> phase metrics."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core import CrashPoint, EngineConfig, Store, WriteBatch
    from repro_torch.core.engine import io as sio
    from repro_torch.workloads import ZipfKeys
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, key_space, n_keys + n_keys // 8,
                                  dtype=np.uint64))
    require(len(keys) >= n_keys, "key draw too small")
    keys = rng.permutation(keys[:n_keys])
    zipf = ZipfKeys(n_keys, theta, seed)
    n_batches = n_keys // batch
    update = [keys[zipf.sample(rng, batch)] for _ in range(n_batches)]
    ckpt_at, crash_at = n_batches // 2, n_batches * 3 // 4
    cfg = EngineConfig.scaled("scavenger_adaptive", dataset_bytes,
                              est_keys=n_keys)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_adaptive_")
    root = Path(tmp.name) / "store"
    latest: dict[int, int] = {}
    vs = np.full(batch, vsize, np.int64)
    phases = {}

    def timed(name, n_ops, fn):
        """Run ``fn``; ``n_ops`` is a count, or a function of the result."""
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        dt = time.perf_counter() - t0
        n = n_ops(out) if callable(n_ops) else n_ops
        phases[name] = {"ops": n, "host_s": dt,
                        "host_ops_s": n / dt if n else None}
        log(f"[adaptive] {name}: {n} ops in {dt:.2f}s host")
        return out

    def put(store, ks):
        vids = store.write(WriteBatch().puts(ks, vs[:len(ks)]))
        require(len(vids) == len(ks) and (vids > 0).all(),
                "write returned no vid")
        latest.update(zip(ks.tolist(), vids.tolist()))

    def readback(store):
        for i in range(0, n_keys, batch):
            ks = keys[i:i + batch]
            res = store.multi_get(ks)
            want = np.fromiter((latest[k] for k in ks.tolist()), np.uint64,
                               count=len(ks))
            require(bool(res["found"].all()), "acknowledged key not found")
            require(bool((res["vid"] == want).all()),
                    "multi_get returned a stale or wrong vid")

    def update_pass(store, lo, hi, crash=False):
        """Batches [lo, hi); with ``crash``, the injected crash point is
        armed at ``crash_at``.  -> index of the batch that crashed, else
        None."""
        for b in range(lo, hi):
            if b == ckpt_at:
                store.checkpoint()
            if crash and b == crash_at:
                store.arm_crash(crash_point)
            wal0, vid0 = store.wal_index, store.next_vid
            try:
                put(store, update[b])
            except CrashPoint:
                # the batch reached the WAL before the crash, so recovery
                # replays it: its vids are the ones the write had minted
                require(store.wal_index == wal0 + 1,
                        "the crashed batch never reached the WAL")
                ks = update[b]
                latest.update(zip(ks.tolist(), range(vid0, vid0 + len(ks))))
                return b
        return None

    from repro_torch.core.read.lookup import lookup_entries
    for fn in kernels.KERNELS + (kernels.sketch_add,):
        fn.launches = 0
    lookup_entries.host_table_probes = 0
    with capture if capture is not None else contextlib.nullcontext():
        store = Store(cfg, durability_dir=root, device=device)
        timed("load", n_keys, lambda: [put(store, keys[i:i + batch])
                                       for i in range(0, n_keys, batch)])
        crashed = timed("update_to_crash",
                        lambda b: (b + 1) * batch if b is not None else 0,
                        lambda: update_pass(store, 0, n_batches, crash=True))
        require(crashed is not None,
                f"crash point {crash_point} never fired in the update pass")
        del store                      # the process died: abandon it
        store = timed("recover", 0,
                      lambda: Store.open(root, device=device))
        require(store.device.type == torch.device(device).type,
                "recovered store is not on the requested device")
        timed("readback_after_crash", n_keys, lambda: readback(store))
        store.checkpoint()             # the recovered store checkpoints on
        timed("update_rest", (n_batches - crashed - 1) * batch,
              lambda: update_pass(store, crashed + 1, n_batches))
        before = store.stats()
        store.close()
        del store
        store = timed("reopen", 0, lambda: Store.open(root, device=device))
        require(store.stats() == before,
                "reopened store's stats differ from those before close")
    launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    # segment_sum's two forms: the sketches' adds (and decays) and the
    # lifetime histogram's adds
    by_form = {"key": kernels.sketch_add.launches,
               "index": launches["segment_sum"] - kernels.sketch_add.launches}
    host_probes = lookup_entries.host_table_probes
    log("[adaptive] launches: " + json.dumps(launches)
        + f"; segment_sum by form: {json.dumps(by_form)}"
        + f"; table probes on the host path: {host_probes}")
    st = store.stats()
    wb = store.io.write_bytes
    busy = {}
    if cuda:
        # device busy share of 16 more update batches
        busy["update"] = idle_window(
            "adaptive update", lambda: [put(store, ks) for ks in update[:16]])
    store.close()
    tmp.cleanup()
    out = {"phases": phases, "launches": launches,
           "segment_sum_by_form": by_form,
           "host_table_probes": host_probes, "device_busy": busy,
           "crash_point": crash_point, "crashed_batch": crashed,
           "space_amp": st["space_amp"], "write_amp": st["write_amp"],
           "n_gc_runs": st["n_gc_runs"],
           "gc_rewrite_bytes": wb.get(sio.CAT_GC_WRITE, 0)
           + wb.get(sio.CAT_GC_WRITE_INDEX, 0),
           "n_compactions": st["n_compactions"], "sim_clock_s": st["clock_s"]}
    log("[adaptive] " + json.dumps(out))
    return out



# ----------------------------------------------------------- 9. fleet
FLEET_SHARDS = 2        # the reference elasticity benchmark's fleet
FLEET_SPLIT_FRAC = 0.55
FLEET_COOLDOWN_OPS = 2048
FLEET_MAX_SHARDS = 4
FLEET_HOT_FRAC = 0.9


def _fleet_metrics(fleet) -> dict:
    st = fleet.stats()
    return {"n_shards": st["n_shards"], "n_migrations": st["n_migrations"],
            "fence_ms": sum(m["fence_us"] for m in fleet.migrations) / 1e3,
            "migrated_mb": fleet.migrated_bytes() / 2**20,
            "space_amp": st["space_amp"], "write_amp": st["write_amp"],
            "n_gc_runs": st["n_gc_runs"]}


# the source's 100 GB cut to 512 MiB, then halved: at 512 MiB the phase
# took 391 s on one H100 (PERF.md §4), which with the earlier phases'
# 595-747 s would pass 1,000 s of the script's 1,200
FLEET_DATASET = 256 << 20


def fleet_run(device, *, dataset_bytes=FLEET_DATASET, batch=4096,
              read_batch=1 << 16, n_gets=1 << 16, n_scans=1024,
              seed=0) -> dict:
    """Drive a durable, replicated, elastic range fleet of scavenger shards
    through the port's ``Runner`` under a static hotspot: load, one update
    pass with a checkpoint halfway, a failover, reads, scans, a close and
    a recovery; check every acknowledged write before the close and after
    the recovery; -> phase metrics.  Writes go in batches of ``batch``,
    reads in batches of ``read_batch``."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core import EngineConfig, ShardedStore
    from repro_torch.workloads import HotspotKeys, Runner, pareto_1k
    from repro_torch.workloads.elastic import hot_seed
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    spec = pareto_1k(dataset_bytes, update_factor=1.0, seed=seed)
    n_keys = spec.n_keys
    cfg = EngineConfig.scaled(
        "scavenger", dataset_bytes // FLEET_SHARDS,
        est_keys=max(64, n_keys // FLEET_SHARDS),
        elastic_split_frac=FLEET_SPLIT_FRAC,
        elastic_cooldown_ops=FLEET_COOLDOWN_OPS,
        elastic_max_shards=FLEET_MAX_SHARDS, replica_count=1)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_")
    root = Path(tmp.name) / "fleet"
    fleet = ShardedStore(cfg, n_shards=FLEET_SHARDS, shard_policy="range",
                         key_space=n_keys, durability_dir=root,
                         device=device)
    # static hotspot (shift_every past the op count): 90% of updates hit
    # one contiguous eighth of the keyspace, inside one shard's slice
    hot = HotspotKeys(n_keys, hot_n=max(1, n_keys // 8),
                      hot_frac=FLEET_HOT_FRAC, shift_every=1 << 30,
                      seed=hot_seed(n_keys, FLEET_SHARDS))
    runner = Runner(fleet, spec, batch=batch, key_gen=hot)
    oracle = runner.oracle           # key -> the vid its write returned

    def counts() -> dict:
        c = {fn.__name__: fn.launches for fn in kernels.KERNELS}
        c["rank_probe_segments"] = kernels.rank_probe_segments.launches
        return c

    steps = {}
    live = [fleet]                   # the fleet the steps drive

    def timed(name, n_ops, fn):
        """Run ``fn``; record host time, launches and the live fleet's
        metrics."""
        sync()
        c0 = counts()
        t0 = time.perf_counter()
        out = fn()
        sync()
        dt = time.perf_counter() - t0
        c1 = counts()
        steps[name] = {"ops": n_ops, "host_s": dt,
                       "host_ops_s": n_ops / dt if n_ops else None,
                       "launches": {k: c1[k] - c0[k] for k in c1
                                    if c1[k] != c0[k]},
                       **_fleet_metrics(live[0])}
        log(f"[fleet] {name}: {n_ops} ops in {dt:.2f}s host, "
            f"{steps[name]['n_shards']} shards, "
            f"{steps[name]['n_migrations']} migrations")
        return out

    def readback(f):
        ks_all = np.fromiter(oracle, np.uint64, count=len(oracle))
        for i in range(0, len(ks_all), read_batch):
            ks = ks_all[i:i + read_batch]
            res = f.multi_get(ks)
            want = np.fromiter((oracle[k] for k in ks.tolist()), np.uint64,
                               count=len(ks))
            require(bool(res["found"].all()), "acknowledged key not found")
            require(bool((res["vid"] == want).all()),
                    "multi_get returned a stale or wrong vid")
        return len(ks_all)

    def gets():
        ks_all = rng.integers(0, n_keys, n_gets).astype(np.uint64)
        for i in range(0, n_gets, read_batch):
            ks = ks_all[i:i + read_batch]
            res = fleet.multi_get(ks)
            want = np.fromiter((oracle.get(k, 0) for k in ks.tolist()),
                               np.uint64, count=len(ks))
            require(bool((res["vid"] == want).all()),
                    "fleet multi_get returned a stale or wrong vid")

    def scans():
        sorted_keys = np.fromiter(sorted(oracle), np.uint64,
                                  count=len(oracle))
        starts = rng.integers(0, n_keys, n_scans).astype(np.int64)
        lens = rng.integers(1, 101, n_scans)
        for i in range(0, n_scans, read_batch):
            st, ln = starts[i:i + read_batch], lens[i:i + read_batch]
            for s, n, row in zip(st.tolist(), ln.tolist(),
                                 fleet.multi_scan(st, ln)):
                a = int(np.searchsorted(sorted_keys, np.uint64(s)))
                want = sorted_keys[a:a + n].tolist()
                require([k for k, _ in row] == want,
                        f"fleet scan from {s} returned the wrong keys")
                require(all(v == oracle[k] for k, v in row),
                        f"fleet scan from {s} returned a wrong vid")

    n_window = 16 * batch            # the pass's last 16 batches
    half = n_keys // 2
    busy = {}

    def update_window():
        """The pass's last 16 batches; on the card, the device busy share
        over them, as the main run measures it."""
        ks = hot.sample(runner.rng, n_window)
        sizes = spec.value_dist.sample(runner.rng, n_window)
        if not cuda:
            runner.apply_puts(ks, sizes)
            return
        busy["update"] = idle_window(
            "fleet update", lambda: runner.apply_puts(ks, sizes))

    def settle():
        # a split begun after a checkpoint is re-derived by recovery from
        # a traffic window the checkpoint does not hold (the reference's
        # ElasticityManager keeps it in memory), so it may land on another
        # shard: settle the topology in a second checkpoint before the
        # reads
        fleet.settle()
        fleet.checkpoint()

    rng = np.random.default_rng(seed + 1)
    for fn in kernels.KERNELS + (kernels.rank_probe_segments,):
        fn.launches = 0
    timed("load", n_keys, runner.load)
    timed("update", half, lambda: runner.update(half))
    timed("checkpoint_halfway", 0, fleet.checkpoint)
    timed("update_rest", n_keys - half - n_window,
          lambda: runner.update(n_keys - half - n_window))
    timed("update_window", n_window, update_window)
    timed("settle_checkpoint", 0, settle)
    space = [s.version.total_bytes() for s in fleet.shards]
    failed = int(np.argmax(space))
    promoted = timed("fail_primary", 0, lambda: fleet.fail_primary(failed))
    require(promoted is fleet.shards[failed]
            and promoted.device.type == torch.device(device).type,
            "the promoted replica is not the shard's primary on the device")
    timed("multi_get", n_gets, gets)
    timed("multi_scan", n_scans, scans)
    timed("readback", len(oracle), lambda: readback(fleet))
    launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    by_form = {"run": launches["rank_probe"]
               - kernels.rank_probe_segments.launches,
               "segments": kernels.rank_probe_segments.launches}
    st = fleet.stats()
    n_shards, router = len(fleet.shards), fleet.router.state_dict()
    migrations = list(fleet.migrations)
    timed("close", 0, fleet.close)

    def reopen():
        live[0] = ShardedStore.open(root, device=device)
        return live[0]
    rec = timed("open", 0, reopen)
    require(all(s.device.type == torch.device(device).type
                for s in rec.shards), "a recovered shard is off the device")
    require(len(rec.shards) == n_shards,
            f"recovered fleet has {len(rec.shards)} shards, not {n_shards}")
    require(rec.router.state_dict() == router,
            "recovered router differs from the one before the close")
    timed("readback_after_open", len(oracle), lambda: readback(rec))
    rec.close()
    tmp.cleanup()
    out = {"steps": steps, "launches": launches,
           "rank_probe_by_form": by_form, "device_busy": busy,
           "n_keys": n_keys, "dataset_bytes": dataset_bytes,
           "failed_shard": failed,
           "migrations": [{k: m[k] for k in ("kind", "src", "dst", "records",
                                             "bytes", "fence_us")}
                          for m in migrations],
           "n_shards": n_shards, "n_migrations": st["n_migrations"],
           "space_amp": st["space_amp"], "write_amp": st["write_amp"],
           "n_gc_runs": st["n_gc_runs"], "sim_clock_s": st["clock_s"],
           "launches_cover": "primaries and replicas (process-wide counts)"}
    log("[fleet] " + json.dumps(out))
    return out

# ---------------------------------------------------------- 6. shapes
def _bound(nbytes: float, nops: float):
    tb, to = nbytes / PEAK_BYTES_S * 1e3, nops / PEAK_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _search_sectors(m: int, c: int) -> int:
    """Distinct 32-byte sectors that ``c`` binary searches of a sorted run
    of ``m`` u64 keys read at least: at search depth d at most
    min(2^d, c) probes, a sector each while probes are 4 or more keys
    apart (deeper ones fall in a sector already read)."""
    if m == 0 or c == 0:
        return 0
    depth = max(1, math.ceil(math.log2(m + 1)) - 2)
    return min(-(-m // 4), sum(min(1 << d, c) for d in range(depth)))


# (threads a CTA, fence stride) of the segmented rank_probe timed at the
# main run's largest vSST-find call and at the seeded vSST finds (one
# thread a query in device memory lost to every stride at 32 threads,
# PERF.md §6, and is gone)
SEGMENT_CHOICES = ((32, 8), (128, 8), (32, 16), (128, 16), (32, 32),
                   (128, 32), (32, 64), (64, 8))


def _segment_choices(kernels, args, kw) -> dict:
    """Device ms of ``rank_probe_segments(*args, **kw)`` at each
    ``SEGMENT_CHOICES`` shape, each checked against the plain version,
    timed in the order A..Z then Z..A;
    -> {"tile{t}_stride{s}": [first, second]}."""
    want = kernels.rank_probe_segments_ref(*args, **kw)
    out = {}
    for tile, stride in SEGMENT_CHOICES:
        got = kernels.rank_probe_segments(*args, **kw, _tile=tile,
                                          _stride=stride)
        require(max_abs_err(got, want) == 0,
                f"rank_probe_segments disagrees with its plain version at "
                f"tile {tile}, stride {stride}")
    for tile, stride in SEGMENT_CHOICES + SEGMENT_CHOICES[::-1]:
        out.setdefault(f"tile{tile}_stride{stride}", []).append(device_ms(
            lambda: kernels.rank_probe_segments(*args, **kw, _tile=tile,
                                                _stride=stride),
            only=CUDA_KERNELS,
            label=f"rank_probe_segments tile {tile} stride {stride}"))
    log("[shapes] rank_probe segments choices: " + json.dumps(out))
    return out


def shapes_phase(capture: Capture, launches: dict, by_form: dict,
                 rank_by_form: dict) -> tuple:
    """Main-path inputs: exact check + timings.  -> (kernel records, the
    records of the other forms: ``rank_probe``'s segmented form, which
    the vSST finds take, ``segment_sum``'s index form, which the lifetime
    histogram's adds take, and those the main path no longer calls,
    ``lookup_probe`` one table a launch and ``gather_min64`` on a
    host-built index matrix).

    ``launches``: each kernel's count from the run that carries it (the
    main run for the probes and fetch planning, the adaptive run for the
    segment-reduce kernels); ``by_form``: ``segment_sum``'s count by form
    in the adaptive run; ``rank_by_form``: ``rank_probe``'s in the main
    run (its record is its run form, the memtable probe)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.common import (probe_tile_words, splitmix64,
                                            u64_mod, u64_order)
    from repro_torch.kernels.lookup_probe.ops import FENCE_STRIDE, TILE
    best = capture.best
    for name in Capture.NAMES:
        require(name in best, f"no store run called {name}")
    recs, forms = [], []

    def record(name, args, kern, plain, lib, nbytes, nops, into=recs,
               form=None, form_launches=None, err=None, plain_calls=None):
        if err is None:
            err = max_abs_err(kern(), plain())
        require(err == 0, f"{name} disagrees with its plain version at "
                          f"main-path shapes")
        # ms: the CUDA kernels alone (a wrapper's operand checks are not
        # the kernel); call_ms: the whole wrapper call as the store makes it
        n0 = len(EVENTS_TIMED)
        ms = device_ms(kern, only=CUDA_KERNELS, label=f"{name} ms")
        if plain_calls is None:
            plain_ms = device_ms(plain, iters=5, label=f"{name} plain_ms")
        else:   # a loop of ~100 small launches a segment: CUDA events
            plain()
            plain_ms = queued_ms(plain, plain_calls)
            EVENTS_TIMED.append(f"{name} plain_ms")
        lib_ms = device_ms(lib, label=f"{name} library_ms") \
            if lib is not None else None
        bound_ms, bound_by = _bound(nbytes, nops)
        rec = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[name], "launches": launches[name],
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": lib_ms, "call_ms": call_ms(kern),
               "shape": [_shape(a) for a in args],
               "events_timed": EVENTS_TIMED[n0:]}
        if form is not None:
            rec["form"] = form
            # None: the main path no longer calls this form
            rec["launches"] = form_launches
        log(f"[shapes] {json.dumps(rec)}")
        into.append(rec)

    # the level probe (one launch a level) at the largest call; bytes:
    # the rows, the keys and raw hashes of the rows used, the tiles, and per
    # segment the run's fence and window sectors and the filter's words
    # the queries read (each at most the whole run or filter), and the
    # outputs
    args = best["lookup_probe_segments"][1]
    keys, kraw, rows, starts, counts, runs, words, nbits = args
    k, slots = kraw.shape[0], int(counts.sum())
    window = math.ceil(math.log2(FENCE_STRIDE)) + 1
    tiles = int(sum(-(-int(c) // TILE) for c in counts))
    seg_bytes = sum(
        min(8 * r.shape[0], 32 * (-(-r.shape[0] // FENCE_STRIDE)
                                  + int(c) * window))
        + min(8 * w.shape[0], 8 * k * int(c))
        for r, w, c in zip(runs, words, counts))
    record("lookup_probe", args,
           lambda: kernels.lookup_probe_segments(*args),
           lambda: kernels.lookup_probe_segments_ref(*args), None,
           8 * len(rows) + 8 * (k + 1) * len(np.unique(rows))
           + 8 * probe_tile_words() * tiles + seg_bytes + 10 * slots,
           slots * (math.log2(max(r.shape[0] for r in runs) / FENCE_STRIDE
                              + 1) + window + 2 * k))
    # the table form at the level's largest segment (the per-table launch
    # the store made before the level form), for comparison
    s = max(range(len(runs)), key=lambda i: int(counts[i])
            * (runs[i].shape[0] + 1))
    r = torch.as_tensor(rows[starts[s]:starts[s] + counts[s]],
                        device=keys.device)
    q, run, words1 = keys[r], runs[s], words[s]
    bit_idx = u64_mod(kraw[:, r], nbits[s]).T.contiguous()
    nq, n, w = q.shape[0], run.shape[0], words1.shape[0]
    record("lookup_probe", (q, run, bit_idx, words1),
           lambda: kernels.lookup_probe(q, run, bit_idx, words1),
           lambda: kernels.lookup_probe_ref(q, run, bit_idx, words1),
           None, 8 * nq + 8 * n + 8 * nq * k + 8 * w + 10 * nq,
           nq * (math.log2(n + 1) + 2 * k), into=forms, form="table")

    q, run = best["rank_probe"][1]
    nq, n = q.shape[0], run.shape[0]
    qo, ro = u64_order(q), u64_order(run)
    record("rank_probe", (q, run),
           lambda: kernels.rank_probe(q, run),
           lambda: kernels.rank_probe_ref(q, run),
           lambda: torch.searchsorted(ro, qo),
           8 * nq + 8 * n + 9 * nq, nq * math.log2(n + 1))
    recs[-1]["form"] = "run"
    recs[-1]["launches_by_form"] = rank_by_form
    # the segmented form at the largest vSST-find call (with the vids the
    # strict locator check reads); bytes: the keys, the distinct sectors
    # of each segment's binary searches (at most the whole run), the
    # value's sector at each key found, and the outputs
    args, kw = best["rank_probe_segments"][1:]
    keys, starts, counts, runs = args
    values = kw.get("values", False)
    nq = keys.shape[0]
    found = kernels.rank_probe_segments(*args, **kw)[0]
    seg_bytes = sum(min(8 * r.shape[-1], 32 * _search_sectors(r.shape[-1],
                                                               int(c)))
                    for r, c in zip(runs, counts))
    nval = int(found.sum()) if values else 0
    record("rank_probe", args,
           lambda: kernels.rank_probe_segments(*args, **kw),
           lambda: kernels.rank_probe_segments_ref(*args, **kw),
           None, 8 * nq + seg_bytes + 32 * nval + 9 * nq
           + (8 * nq if values else 0),
           sum(int(c) * math.log2(r.shape[-1] + 1)
               for r, c in zip(runs, counts)),
           into=forms, form="segments",
           form_launches=rank_by_form["segments"], plain_calls=2)
    lens = np.array([r.shape[-1] for r in runs])
    forms[-1]["launches_by_form"] = rank_by_form
    forms[-1]["runs"] = {"keys_mean": float(lens.mean()),
                         "keys_max": int(lens.max()),
                         "queries_mean": float(counts.mean()),
                         "queries_max": int(counts.max()),
                         "values": values}
    forms[-1]["choices_ms"] = _segment_choices(kernels, args, kw)

    # the main path calls count_le through interval_rank (the interval
    # check fused into the kernel); searchsorted gives the count only
    q, mins, maxs = best["interval_rank"][1]
    nq, n = q.shape[0], mins.shape[0]
    qo, mo = u64_order(q), u64_order(mins)
    record("count_le", (q, mins, maxs),
           lambda: (kernels.interval_rank(q, mins, maxs),),
           lambda: (kernels.interval_rank_ref(q, mins, maxs),),
           lambda: torch.searchsorted(mo, qo, right=True),
           8 * nq + 16 * n + 8 * nq, nq * (math.log2(n + 1) + 1))

    # operations: a comparison sort's m log2 m, and the marks' 4 a pair
    (r, p), kw = best["run_coalesce"][1], best["run_coalesce"][2]
    m = r.shape[0]
    packed = u64_order((r << 32) | p)
    record("run_coalesce", (r, p),
           lambda: kernels.run_coalesce(r, p, **kw),
           lambda: kernels.run_coalesce_ref(r, p, kw.get("window")),
           lambda: torch.sort(packed),
           16 * m + 18 * m, m * max(1.0, math.log2(m)) + 4 * m)

    # segment_sum's key form, the sketch's add into its resident counters
    # at the largest add (a decay factor folded in where the store gave
    # one), checked on fresh copies and timed on a working copy; bytes:
    # the keys, the seeds, and every counter read and written with a
    # factor, else the slots the keys touch; the library call adds ones at
    # the hashed slots (the hash computed outside it)
    (counts, keys, seeds), kw = best["sketch_add"][1:]
    scale = kw.get("scale")
    (d, w), q = counts.shape, keys.shape[0]
    got, want = counts.clone(), counts.clone()
    kernels.sketch_add(got, keys, seeds, **kw)
    kernels.sketch_add_ref(want, keys, seeds, scale)
    err = max_abs_err((got.view(torch.int64),), (want.view(torch.int64),))
    flat = (u64_mod(splitmix64(keys[:, None] ^ seeds[None, :]), w)
            + torch.arange(d, device=keys.device) * w).reshape(-1)
    ones = torch.ones(flat.shape[0], dtype=torch.float64,
                      device=keys.device)
    touched = int(torch.unique(flat).shape[0])
    work, work_p, work_l = counts.clone(), counts.clone(), counts.clone()
    record("segment_sum", (counts, keys, seeds),
           lambda: kernels.sketch_add(work, keys, seeds, **kw),
           lambda: kernels.sketch_add_ref(work_p, keys, seeds, scale),
           lambda: work_l.view(-1).index_add_(0, flat, ones),
           8 * q + 8 * d + 16 * (d * w if scale is not None else touched),
           q * d * 16 + (d * w if scale is not None else 0), err=err)
    recs[-1]["form"] = "key"
    recs[-1]["scaled"] = scale is not None
    recs[-1]["launches_by_form"] = by_form
    # the index form at the lifetime histogram's largest add (one launch
    # that writes every count); one id -> one add
    ids, slots = best["segment_sum"][1]
    p = ids.shape[0]
    valid = ids[(ids >= 0) & (ids < slots)]
    record("segment_sum", (ids, slots),
           lambda: (kernels.segment_sum(ids, slots),),
           lambda: (kernels.segment_sum_ref(ids, slots),),
           lambda: torch.bincount(valid, minlength=slots),
           8 * p + 8 * slots, p, into=forms, form="index",
           form_launches=by_form["index"])

    # the estimate with the row hash in the kernel; bytes: the table, the
    # keys, the seeds and the estimates
    bits, keys, seeds = best["sketch_estimate"][1]
    (d, w), q = bits.shape, keys.shape[0]
    record("gather_min64", (bits, keys, seeds),
           lambda: (kernels.sketch_estimate(bits, keys, seeds),),
           lambda: (kernels.sketch_estimate_ref(bits, keys, seeds),),
           None, 8 * d * w + 8 * q + 8 * d + 8 * q, q * d * 16)
    # the index form on the same estimate (the host built idx before)
    idx = u64_mod(splitmix64(keys[:, None] ^ seeds[None, :]), w)
    record("gather_min64", (bits, idx),
           lambda: (kernels.gather_min64(bits, idx),),
           lambda: (kernels.gather_min64_ref(bits, idx),),
           None, 8 * d * w + 8 * q * d + 8 * q, q * d, into=forms,
           form="index")
    return recs, forms


def _shape(a):
    """A record's shape entry: a tensor's or an array's shape, a list's
    length, a number as it is."""
    if hasattr(a, "shape"):
        return list(a.shape)
    return [len(a)] if isinstance(a, (list, tuple)) else a


# ---------------------------------------------------------- 7. parity
def fixed_workload(engine: str, device, fleet=None, **overrides):
    """The reference parity test's op stream (tests/test_refactor_parity.py
    ``run_fixed_workload``) -> (stats, multi_get vids, scan rows); through
    a ``ShardedStore`` made with the ``fleet`` arguments, if given."""
    import numpy as np
    from repro_torch.core import EngineConfig, ShardedStore, Store, WriteBatch
    n_keys = 4096
    vsizes = np.array([64, 200, 600, 2000, 9000], np.int64)
    cfg = EngineConfig.scaled(engine, 8 << 20, est_keys=n_keys, **overrides)
    store = Store(cfg, device=device) if fleet is None else \
        ShardedStore(cfg, device=device, **fleet)
    rng = np.random.default_rng(1234)
    vids, rows = [], []
    for _ in range(6):
        keys = rng.integers(0, n_keys, 256).astype(np.uint64)
        sizes = vsizes[rng.integers(0, len(vsizes), 256)]
        store.write(WriteBatch().puts(keys, sizes))
        store.write(WriteBatch().deletes(
            rng.integers(0, n_keys, 16).astype(np.uint64)))
        res = store.multi_get(rng.integers(0, n_keys, 128).astype(np.uint64))
        vids.append(res["vid"].tolist())
        rows.append(store.multi_scan(
            rng.integers(0, n_keys, 8).astype(np.int64), 10))
    store.drain()
    return store.stats(), vids, rows


def parity_phase(device="cuda") -> None:
    """Kernels on at the default routing threshold and with every probe
    routed (kernel_min_batch=1), each against kernels off on the CPU;
    ``scavenger_adaptive`` with its tracker on and off."""
    cases = [(e, {}) for e in ENGINES] + [
        ("scavenger_adaptive", {"adaptive_enabled": False})]
    for engine, base in cases:
        t0 = time.perf_counter()
        off = fixed_workload(engine, "cpu", use_kernels=False, **base)
        for kw in ({}, {"kernel_min_batch": 1}):
            on = fixed_workload(engine, device, **base, **kw)
            what = f"{engine} {base} {kw}"
            require(on[0] == off[0], f"{what}: stats differ: "
                                     f"{on[0]} vs {off[0]}")
            require(on[1] == off[1], f"{what}: multi_get vids differ")
            require(on[2] == off[2], f"{what}: scan rows differ")
        log(f"[parity] {engine} {base}: equal "
            f"({time.perf_counter() - t0:.1f}s)")
    fleet_parity(device)


FLEET_ENGINES = ("scavenger", "titan")


def fleet_parity(device="cuda") -> None:
    """A 1-shard fleet against the port's ``Store`` on the card (equal
    stats on every field they share, vids and scan rows), and 3-shard
    ``range`` and ``hash`` fleets under the ``fleet`` and ``round_robin``
    schedulers on the card with kernels on (at the default threshold and
    with every probe routed) against the same fleets on the CPU with
    kernels off (stats, every multi_get vid and every scan row)."""
    for engine in FLEET_ENGINES:
        t0 = time.perf_counter()
        one = fixed_workload(engine, device, fleet={"n_shards": 1})
        store = fixed_workload(engine, device)
        shared = set(one[0]) & set(store[0])
        require({k: one[0][k] for k in shared}
                == {k: store[0][k] for k in shared},
                f"{engine}: a 1-shard fleet's stats differ from Store's")
        require(one[1:] == store[1:],
                f"{engine}: a 1-shard fleet's reads differ from Store's")
        n = 1
        for policy in ("range", "hash"):
            for scheduler in ("fleet", "round_robin"):
                fleet = {"n_shards": 3, "shard_policy": policy,
                         "key_space": 4096, "scheduler": scheduler}
                off = fixed_workload(engine, "cpu", fleet=fleet,
                                     use_kernels=False)
                for kw in ({}, {"kernel_min_batch": 1}):
                    on = fixed_workload(engine, device, fleet=fleet, **kw)
                    what = f"{engine} fleet {policy}/{scheduler} {kw}"
                    require(on[0] == off[0], f"{what}: stats differ: "
                                             f"{on[0]} vs {off[0]}")
                    require(on[1] == off[1], f"{what}: multi_get vids differ")
                    require(on[2] == off[2], f"{what}: scan rows differ")
                    n += 1
        log(f"[parity] {engine} fleets: {n} cases equal "
            f"({time.perf_counter() - t0:.1f}s)")


# ------------------------------------------------------------ 8. crash
def _crash_ops(n_groups: int = 8, seed: int = 7) -> list:
    """The op stream of the reference's crash-matrix test
    (tests/test_durability.py ``_ops``)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    vsizes = np.array([64, 200, 600, 2000, 9000], np.int64)
    out = []
    for _ in range(n_groups):
        keys = rng.integers(0, 4096, 192).astype(np.uint64)
        out.append(("puts", keys, vsizes[rng.integers(0, 5, 192)]))
        out.append(("dels", rng.integers(0, 4096, 16).astype(np.uint64)))
        out.append(("get", rng.integers(0, 4096, 64).astype(np.uint64)))
    return out


def crash_phase(device="cuda") -> int:
    """Each (engine, store crash point): a durable store on the card,
    checkpointed after 8 ops, crashed at the second pass through the point
    from op 12 on, recovered on the card, against an uninterrupted CPU run
    (kernels off) at the crash watermark.  -> the number of cases."""
    import numpy as np
    from repro_torch.core import CrashPoint, EngineConfig, Store, WriteBatch
    from repro_torch.core.durability import CRASH_POINTS
    ops = _crash_ops()

    def apply(store, op):
        if op[0] == "puts":
            store.write(WriteBatch().puts(op[1], op[2]))
        elif op[0] == "dels":
            store.write(WriteBatch().deletes(op[1]))
        else:
            store.multi_get(op[1])

    def state(store):
        res = store.multi_get(np.arange(4096, dtype=np.uint64))
        return store.stats(), res["found"].tolist(), res["vid"].tolist()

    cache: dict = {}
    n = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_crash_") as tmp:
        for engine in ENGINES:
            cfg = EngineConfig.scaled(engine, 8 << 20, est_keys=4096)
            for point in CRASH_POINTS[:5]:     # the fleet points need shards
                if engine in ("rocksdb", "blobdb") and point.startswith("gc_"):
                    continue                   # no standalone GC run
                root = Path(tmp) / f"{engine}-{point}"
                store = Store(cfg, durability_dir=root, device=device)
                for i, op in enumerate(ops):
                    if i == 8:
                        store.checkpoint()
                    if i == 12:
                        store.arm_crash(point, hits=2)
                    try:
                        apply(store, op)
                    except CrashPoint:
                        break
                applied = store.wal_index
                store.close()
                rec = Store.open(root, device=device)
                key = (engine, applied)
                if key not in cache:
                    ref = Store(EngineConfig.scaled(engine, 8 << 20,
                                                    est_keys=4096,
                                                    use_kernels=False),
                                device="cpu")
                    for op in ops[:applied]:
                        apply(ref, op)
                    cache[key] = state(ref)
                got, want = state(rec), cache[key]
                require(got[1:] == want[1:],
                        f"crash {engine}/{point}: recovered vids differ")
                gs, ws = dict(got[0]), dict(want[0])
                require(gs == ws, f"crash {engine}/{point}: recovered stats "
                                  f"differ: {gs} vs {ws}")
                rec.close()
                n += 1
    log(f"[crash] {n} (engine, crash point) cases recovered on the card "
        f"equal to the uninterrupted CPU run "
        f"({time.perf_counter() - t0:.1f}s)")
    return n + fleet_crash(device)


def fleet_crash(device="cuda") -> int:
    """The four fleet crash points on ``scavenger`` and ``titan``: a split
    crashed at each migration point, and a failover at ``pre_promote``,
    each fleet recovered with ``ShardedStore.open(..., device=...)`` and
    held against the latest-write oracle, then driven on (a failover on
    the re-seeded replicas).  -> the number of cases."""
    import numpy as np
    import torch
    from repro_torch.core import CrashPoint, EngineConfig, ShardedStore
    from repro_torch.core.durability import CRASH_POINTS
    from repro_torch.workloads.elastic import (FLEET_KEY_SPACE, TINY_FLEET,
                                               fleet_rounds, oracle_mismatch)

    def holds(fleet, oracle, what):
        bad = oracle_mismatch(fleet, oracle)
        require(bad is None, f"{what}: {bad}")
    n = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_crash_") as tmp:
        for engine in FLEET_ENGINES:
            for point in CRASH_POINTS[5:]:
                what = f"fleet crash {engine}/{point}"
                promote = point == "pre_promote"
                extra = {"replica_count": 1, "replica_lag_ops": 4} \
                    if promote else {}
                cfg = EngineConfig(engine=engine, **TINY_FLEET, **extra)
                root = Path(tmp) / f"{engine}-{point}"
                rng = np.random.default_rng(17 if promote else 11)
                oracle: dict = {}
                fleet = ShardedStore(cfg, n_shards=2,
                                     key_space=FLEET_KEY_SPACE,
                                     durability_dir=root, device=device)
                fleet_rounds(fleet, oracle, rng, 4)
                fleet.checkpoint()
                fleet_rounds(fleet, oracle, rng, 2 if promote else 3)
                fleet.arm_crash(point)
                try:
                    fleet.fail_primary(0) if promote else fleet.split_shard(0)
                except CrashPoint:
                    pass
                else:
                    raise SmokeFailure(f"{what}: the crash point never fired")
                fleet.close()
                rec = ShardedStore.open(root, device=device)
                require(all(s.device.type == torch.device(device).type
                            for s in rec.shards),
                        f"{what}: a recovered shard is off the device")
                holds(rec, oracle, what)
                fleet_rounds(rec, oracle, rng, 2)
                if promote:
                    rec.fail_primary(0)
                holds(rec, oracle, what + " (driven on)")
                rec.close()
                n += 1
    log(f"[crash] {n} fleet (engine, crash point) cases recovered on the "
        f"card to the latest-write oracle "
        f"({time.perf_counter() - t0:.1f}s)")
    return n


# -------------------------------------------------------- 4. crossover
CROSSOVER_SIZES = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def _per_call_us(fn, iters: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def crossover_phase(store, sizes=CROSSOVER_SIZES, iters=40) -> dict:
    """Wall time per call (us) of each routed op against the host NumPy
    path it replaces, per batch size: the probes and fetch planning on the
    store's own columns (the table probes as one level probe over the
    level with the most files and over the level with the fewest, against
    the host's loop over its files; one vSST's find; and a multi_get's
    vSST finds, keys drawn over every vSST's records as a multi_get's
    fall, through ``fetch.find_records`` routed (one call with the
    grouping and the locator check) against its host path, on trees that
    have it), the access tracker's sketch add,
    lifetime observe (``segment_sum``) and sketch estimate
    (``gather_min64``) on a tracker of the 1 GiB ``scavenger_adaptive``
    configuration's widths; then ``few_files_crossover``.  A routed call
    returns host arrays, so its time holds the upload, the kernel and the
    download.  -> {op: {"rows": [...], "crossover": the smallest size from
    which the routed call is never slower, or None}, "few_files": ...}."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.core import EngineConfig, accel
    from repro_torch.core.adaptive.lifetime import LifetimeEstimator
    from repro_torch.core.adaptive.sketch import DecaySketch
    from repro_torch.core.engine.keys import BloomFilter, hash_family
    from repro_torch.core.values import fetch
    from repro_torch.core.values.fetch import split_runs
    rng = np.random.default_rng(11)
    v = store.version
    vtab = max(v.value_files.values(), key=lambda t: len(t.keys))
    deep = [i for i in range(1, store.cfg.max_levels) if v.levels[i]]
    require(len(deep) > 0, "crossover: no level below L0")
    lvl = max(deep, key=lambda i: len(v.levels[i]))
    few = min(deep, key=lambda i: len(v.levels[i]))
    lkeys = np.concatenate([t.keys for t in v.levels[lvl]])
    fkeys = np.concatenate([t.keys for t in v.levels[few]])
    k = BloomFilter.k_for(store.cfg.filter_bits_per_key)
    window = store.cfg.coalesce_window
    saved = getattr(store.cfg, "_kernel_policy", None)
    store.cfg._kernel_policy = accel.KernelPolicy(True, 1, window)

    def draw(col, b):       # half present keys, half random ones
        ks = col[rng.integers(0, len(col), b)]
        ks[b // 2:] = rng.integers(0, 1 << 40, b - b // 2, dtype=np.uint64)
        return ks

    def level_plan(i, ks):   # the rows grouped by file, as lookup_entries
        fidx = v.assign_files(i, ks)
        rows = np.nonzero(fidx >= 0)[0]
        rows = rows[np.argsort(fidx[rows], kind="stable")]
        return (v.levels[i], rows) + np.unique(
            fidx[rows], return_index=True, return_counts=True)

    def level_host(ks, kraw, plan):
        files, rows, fis, starts, counts = plan
        for fi, a, c in zip(fis.tolist(), starts.tolist(), counts.tolist()):
            r = rows[a:a + c]
            may = files[fi].bloom.may_contain(ks[r], raw=kraw[:, r])
            files[fi].find(ks[r][may])

    def level_routed(ks, kraw, plan):
        files, rows, fis, starts, counts = plan
        return accel.level_probe(store, accel.ProbeKeys(ks, kraw),
                                 [files[fi] for fi in fis], rows, starts,
                                 counts)

    # a multi_get's keys fall on the vSSTs as their records do: draw
    # records uniformly over every vSST (the main run's 4,096-key batches
    # touched ~1,500 vSSTs, ~2.7 keys each)
    vfids = np.concatenate([np.full(len(t.keys), fid) for fid, t in
                            v.value_files.items()])
    vkeys = np.concatenate([t.keys for t in v.value_files.values()])
    vvids = np.concatenate([t.vids for t in v.value_files.values()])

    def vsst_batch(b):      # one multi_get's finds
        j = rng.integers(0, len(vkeys), b)
        return vfids[j], vkeys[j], vvids[j]

    off_pol = accel.KernelPolicy(False)

    def find_host(fsel, ksel, vsel):    # the host path: a find a vSST
        saved_pol = store.cfg._kernel_policy
        store.cfg._kernel_policy = off_pol
        try:
            return fetch.find_records(store, fsel, ksel, vsel, True)
        finally:
            store.cfg._kernel_policy = saved_pol

    def find_routed(fsel, ksel, vsel):  # every vSST's find in one call
        return fetch.find_records(store, fsel, ksel, vsel, True)

    def table_find(t, ks):  # one vSST's find as the tree routes it
        if hasattr(accel, "table_find_segments"):
            return accel.table_find_segments(store, [t], ks, [0], [len(ks)])
        return accel.table_find(store, t, ks)

    def plan_host(ranks, pos):
        bounds = np.nonzero(np.diff(ranks))[0] + 1
        return [split_runs(np.unique(p), window)
                for p in np.split(pos, bounds)]

    # the tracker's state: one host-path and one routed copy of each
    acfg = EngineConfig.scaled("scavenger_adaptive", 1 << 30,
                               est_keys=1 << 20)
    routed_pol = accel.KernelPolicy(True, 1, window)

    def sketch(pol):
        return DecaySketch(acfg.adaptive_sketch_width,
                           acfg.adaptive_sketch_depth,
                           acfg.adaptive_half_life_ops, policy=pol,
                           device=store.device)

    def lifetime(pol):
        return LifetimeEstimator(acfg.adaptive_groups,
                                 acfg.adaptive_half_life_ops,
                                 policy=pol, device=store.device)

    sk_host, sk_routed = sketch(None), sketch(routed_pol)
    lt_host, lt_routed = lifetime(None), lifetime(routed_pol)
    for lt in (lt_host, lt_routed):     # every group has a last write
        lt.observe(np.arange(acfg.adaptive_groups), 0.0)

    def via(kern, fn):      # the routed call, None if it launched nothing
        def call():
            n = kern.launches
            fn()
            return True if kern.launches > n else None
        return call

    def cases(b):
        vks, lks, fks = draw(vtab.keys, b), draw(lkeys, b), draw(fkeys, b)
        kraw, plan = hash_family(lks, k), level_plan(lvl, lks)
        fraw, fplan = hash_family(fks, k), level_plan(few, fks)
        # one multi_get's fetch plan: ~10 keys per vSST, grouped by file
        ranks = np.sort(rng.integers(0, max(1, b // 10), b)).astype(np.int64)
        pos = rng.integers(0, 4 * b, b).astype(np.int64)
        tks = rng.integers(0, 1 << 40, b, dtype=np.uint64)
        # lifetime observe routes one row per distinct group seen before
        groups = rng.permutation(acfg.adaptive_groups)[:b]
        found = vsst_batch(b)
        vsst = ({"vsst_find": (lambda: find_host(*found),
                               via(kernels.rank_probe_segments,
                                   lambda: find_routed(*found)))}
                if hasattr(fetch, "find_records") else {})
        return {  # op: (host path, routed path)
            **vsst,
            "lookup_probe_level": (lambda: level_host(lks, kraw, plan),
                                   lambda: level_routed(lks, kraw, plan)),
            "lookup_probe_level_fewest": (
                lambda: level_host(fks, fraw, fplan),
                lambda: level_routed(fks, fraw, fplan)),
            "rank_probe": (lambda: vtab.find(vks),
                           lambda: table_find(vtab, vks)),
            "count_le": (lambda: v.assign_files(lvl, lks),
                         lambda: accel.assign_files(store, lvl, lks)),
            "run_coalesce": (lambda: plan_host(ranks, pos),
                             lambda: accel.plan_runs(store, ranks, pos)),
            "sketch_add": (lambda: sk_host.add(tks),
                           via(kernels.segment_sum,
                               lambda: sk_routed.add(tks))),
            "sketch_estimate": (lambda: sk_host.estimate(tks),
                                via(kernels.gather_min64,
                                    lambda: sk_routed.estimate(tks))),
            "lifetime_observe": (lambda: lt_host.observe(groups, 0.0),
                                 via(kernels.segment_sum,
                                     lambda: lt_routed.observe(groups, 0.0))),
        }

    rows = {}
    try:
        for b in sizes:
            for name, (host, routed) in cases(b).items():
                if name == "lifetime_observe" and b > acfg.adaptive_groups:
                    continue    # at most one row per group
                require(routed() is not None, f"crossover: {name} declined")
                rows.setdefault(name, []).append(
                    {"batch": b, "host_us": _per_call_us(host, iters),
                     "routed_us": _per_call_us(routed, iters)})
    finally:
        store.cfg._kernel_policy = saved
    out = {}
    for name, rs in rows.items():
        cross = None        # smallest size from which routed never loses
        for r in reversed(rs):
            if r["routed_us"] > r["host_us"]:
                break
            cross = r["batch"]
        out[name] = {"rows": rs, "crossover": cross}
        if name.startswith("lookup_probe_level"):
            out[name]["files"] = len(v.levels[lvl if name ==
                                              "lookup_probe_level" else few])
        log(f"[crossover] {name}: " + json.dumps(out[name]))
    out["few_files"] = few_files_crossover(store.device, iters)
    return out


# (files, rows) of the level probes whose route the level's row count
# decides: a level of a few files, each under kernel_min_batch rows, and
# an L0 of one to four tables
FEW_FILES = (1, 2, 3, 4, 8, 16)
FEW_ROWS = (64, 128, 256, 512, 1024)


def few_files_crossover(device, iters=40) -> dict:
    """Wall time per call (us) of one level probe against the host loop
    over its files (bloom test and ``SSTable.find`` a file), on seeded
    levels of ``FEW_FILES`` 12,000-key files (the 1 GiB store's table
    size) at ``FEW_ROWS`` rows: an L1+ level's rows spread over its files
    (half present keys), and L0 tables that each probe every row (the
    host walk's work when no table resolves a row).  The routed call
    uploads the key and raw-hash columns, as a lookup's first routed
    level does.  -> {"level": [...], "l0": [...]}, a row per shape."""
    import types
    import numpy as np
    from repro_torch.core import accel
    from repro_torch.core.engine.keys import BloomFilter, hash_family
    from repro_torch.core.engine.tables import SSTable
    rng = np.random.default_rng(23)
    store = _stub_store(str(device))
    per = 12000
    out = {"level": [], "l0": []}
    for kind in out:
        for nfiles in FEW_FILES if kind == "level" else FEW_FILES[:4]:
            if kind == "level":     # one sorted key set cut into files
                allk = np.unique(rng.integers(0, 1 << 40, nfiles * per + 99,
                                              dtype=np.uint64))
                runs = np.split(allk[:nfiles * per], nfiles)
            else:                   # tables over one key range
                runs = [np.unique(rng.integers(0, 1 << 40, per,
                                               dtype=np.uint64))
                        for _ in range(nfiles)]
            tables = [types.SimpleNamespace(keys=r, n=len(r),
                                            bloom=BloomFilter(r, 10))
                      for r in runs]
            pool = np.concatenate(runs)
            for nrows in FEW_ROWS:
                ks = pool[rng.integers(0, len(pool), nrows)]
                ks[nrows // 2:] = rng.integers(0, 1 << 40, nrows - nrows // 2,
                                               dtype=np.uint64)
                kraw = hash_family(ks, tables[0].bloom.k)
                if kind == "level":
                    lo = np.array([r[0] for r in runs])
                    fidx = np.searchsorted(lo, ks, side="right") - 1
                    fidx[ks > runs[-1][-1]] = -1
                    rows = np.nonzero(fidx >= 0)[0]
                    rows = rows[np.argsort(fidx[rows], kind="stable")]
                    fis, starts, counts = np.unique(
                        fidx[rows], return_index=True, return_counts=True)
                else:
                    rows = np.arange(nrows)
                    fis = np.arange(nfiles)
                    starts = np.zeros(nfiles, np.int64)
                    counts = np.full(nfiles, nrows, np.int64)
                segs = list(zip(fis.tolist(), starts.tolist(),
                                counts.tolist()))

                def host():
                    for fi, a, c in segs:
                        r = rows[a:a + c]
                        t = tables[fi]
                        may = t.bloom.may_contain(ks[r], raw=kraw[:, r])
                        SSTable.find(t, ks[r][may])

                def routed():
                    return accel.level_probe(
                        store, accel.ProbeKeys(ks, kraw),
                        [tables[fi] for fi in fis], rows, starts, counts)
                require(routed() is not None,
                        "crossover: the level probe declined")
                out[kind].append({
                    "files": nfiles, "rows": nrows,
                    "max_file_rows": int(counts.max()),
                    "host_us": _per_call_us(host, iters),
                    "routed_us": _per_call_us(routed, iters)})
    log("[crossover] few_files: " + json.dumps(out))
    return out


def crossover_only(src: Path) -> None:
    """Phase 4 alone, on a 2^18-key store of the port under ``src``."""
    import torch
    sys.path.insert(0, str(src.resolve()))
    import repro_torch
    log(f"[crossover] port at {Path(repro_torch.__file__).parent}")
    _, store = main_run("cuda", dataset_bytes=1 << 28, n_keys=1 << 18,
                        n_gets=1 << 14, n_scans=16)
    res = crossover_phase(store)
    print(json.dumps({"crossover": res}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ------------------------------------------------------------- main
COALESCE_TIMES_M = (64, 256, 1024, 4096, 8192)


def kernel_times_only(src: Path, only=None) -> None:
    """Build the port under ``src`` and time ``segment_sum`` and
    ``gather_min64`` at the adaptive run's largest inputs (1,018 ids into
    32,576 slots, random and as the lifetime histogram makes them, one a
    row of 32 slots; a 2 x 4,096 sketch and 5,433 queries) and
    ``run_coalesce`` at M in ``COALESCE_TIMES_M`` (ranks below M / 10 as
    one multi_get's vSSTs, positions below 2^12 as the 2,621 records of a
    1 GiB store's vSST) on
    seeded data: the build's wall time, and each kernel's device time per
    launch in three profiler sessions of 200 launches each and by
    ``queued_ms`` (``segment_sum``'s also split by device operation, and
    with its operands out of L2); for ``run_coalesce`` also the wrapper
    call (``call_ms``) and ``torch.sort`` of the packed pairs beside it, after
    holding the kernel against its plain version.  Then a level's table
    probes (``_level_times``), the routed sketch estimate
    (``_estimate_times``) and add (``_sketch_add_times``), the tracker's
    write observation (``_observe_times``), the level file assignment
    (``_interval_times``), ``rank_probe``'s run form (``_rank_times``), a
    multi_get's vSST finds (``_vsst_find_times``), ``merge_dedup``
    (``_merge_times``), ``hot_cold_partition`` (``_partition_times``),
    ``gc_lookup`` (``_gc_lookup_times``), ``bloom_probe``
    (``_bloom_times``) and ``segment_sum`` at ``SEGMENT_SHAPES``
    (``_segment_shape_times``), as the store makes them on that tree.  ``only``:
    the names of the parts to run (the keys of the result), the build
    always; None for all."""
    import numpy as np
    import torch
    sys.path.insert(0, str(src.resolve()))
    import repro_torch
    from repro_torch import kernels
    from repro_torch.kernels import common
    log(f"[kernel-times] port at {Path(repro_torch.__file__).parent}")
    t0 = time.perf_counter()
    common.library()
    out = {"build_s": time.perf_counter() - t0}
    rng = np.random.default_rng(14)

    def want(part):
        return only is None or part in only
    slots = 32576
    ids = torch.from_numpy(rng.integers(0, slots, 1018)).to("cuda")
    # the lifetime histogram's ids: one a row of 32 slots, ascending
    rows = torch.from_numpy(np.arange(1018) * 32
                            + rng.integers(0, 32, 1018)).to("cuda")
    vals = rng.random((2, 4096)) * 1e6
    bits = torch.from_numpy(vals.view(np.int64).copy()).to("cuda")
    idx = torch.from_numpy(rng.integers(0, 4096, (5433, 2))).to("cuda")
    for name, fn in (("segment_sum", lambda: kernels.segment_sum(ids, slots)),
                     ("segment_sum_tracker",
                      lambda: kernels.segment_sum(rows, slots)),
                     ("gather_min64",
                      lambda: kernels.gather_min64(bits, idx))):
        if not want(name):
            continue
        out[name] = [device_ms(fn, iters=200, only=CUDA_KERNELS, label=name)
                     for _ in range(3)]
        out[name + "_queued"] = queued_ms(fn, 200)
        if name.startswith("segment_sum"):
            out[name + "_by_kernel_us"] = _split_us(fn)
            out[name + "_cold"] = [
                device_ms(_after_flush(fn), iters=20, only=CUDA_KERNELS,
                          label=f"{name} cold") for _ in range(2)]
    for m in COALESCE_TIMES_M if want("run_coalesce") else ():
        r = torch.from_numpy(rng.integers(0, max(2, m // 10), m)).to("cuda")
        p = torch.from_numpy(rng.integers(0, 1 << 12, m)).to("cuda")
        err = max_abs_err(kernels.run_coalesce(r, p),
                          kernels.run_coalesce_ref(r, p))
        require(err == 0, f"run_coalesce disagrees with its plain version "
                          f"at m={m}")
        packed = (r << 32) | p

        def coalesce():
            return kernels.run_coalesce(r, p)
        out[f"run_coalesce_{m}"] = {
            "ms": [device_ms(coalesce, iters=200, only=CUDA_KERNELS,
                             label=f"run_coalesce {m}") for _ in range(3)],
            "queued_ms": queued_ms(coalesce, 200),
            "call_ms": call_ms(coalesce, iters=200),
            "sort_ms": [device_ms(lambda: torch.sort(packed), iters=200,
                                  label=f"torch.sort {m}")
                        for _ in range(3)]}
    for part, fn in (("level_probe", lambda: _level_times(kernels)),
                     ("estimate", lambda: _estimate_times(kernels)),
                     ("sketch_add", lambda: _sketch_add_times(kernels)),
                     ("observe_writes", _observe_times),
                     ("interval_rank", lambda: _interval_times(kernels)),
                     ("rank_probe", lambda: _rank_times(kernels)),
                     ("vsst_find", lambda: _vsst_find_times(kernels)),
                     ("merge_dedup", _merge_times),
                     ("hot_cold_partition", _partition_times),
                     ("gc_lookup", _gc_lookup_times),
                     ("bloom_probe", _bloom_times),
                     ("segment_sum_shapes", _segment_shape_times)):
        if want(part):
            out[part] = fn()
    print(json.dumps({"kernel_times": out}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# (name, files, keys a file, rows, rows shared by every file as in L0):
# the main path's level probes, an L1+ level of a multi_get batch and the
# L0 tables of a GC-Lookup batch
LEVEL_SHAPES = (("level_80x12000_q4096", 80, 12000, 4096, False),
                ("level_80x12000_q512", 80, 12000, 512, False),
                ("l0_4x12000_q9757", 4, 12000, 9757, True))
TILE_CHOICES = (256, 512, 1024)
STRIDE_CHOICES = (16, 32, 64)


def _stub_store(device="cuda"):
    """What ``core/accel.py`` reads of a store: its config (every probe
    routed), device, device cache and observer."""
    import types
    import torch
    from repro_torch.core import EngineConfig, accel
    from repro_torch.kernels.common import DeviceCache
    from repro_torch.obs import NULL_OBSERVER
    cfg = EngineConfig.scaled("scavenger", 1 << 30, est_keys=1 << 20)
    cfg._kernel_policy = accel.KernelPolicy(True, 1, cfg.coalesce_window)
    dev = torch.device(device)
    return types.SimpleNamespace(cfg=cfg, device=dev, obs=NULL_OBSERVER,
                                 dev_cache=DeviceCache(dev))


def _wall_ms(fn, iters: int = 50) -> float:
    """Mean wall ms per call of ``fn`` (each call waits for the card)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def _level_times(kernels, device="cuda") -> dict:
    """The table probes of one level as the store makes them: one level
    probe (``accel.level_probe``, this tree) or one ``accel.table_probe``
    a table (trees before it), on the same seeded level: the device time
    of all the call's kernels and the call's wall time (upload, kernels,
    download).  On a tree with the level form, also its tile and fence
    stride choices, in two passes (forward, then reverse) for a spread."""
    import types
    import numpy as np
    from repro_torch.core import accel
    from repro_torch.core.engine.keys import BloomFilter, hash_family
    level_form = hasattr(accel, "level_probe")
    rng = np.random.default_rng(19)
    res = {}
    for name, nfiles, per, nrows, shared in LEVEL_SHAPES:
        store = _stub_store(device)
        if shared:      # L0: tables over one key range, rows shared
            runs = [np.unique(rng.integers(0, 1 << 40, per, dtype=np.uint64))
                    for _ in range(nfiles)]
        else:           # a level: one sorted key set cut into files
            allk = np.unique(rng.integers(0, 1 << 40, nfiles * per + 999,
                                          dtype=np.uint64))[:nfiles * per]
            runs = np.split(allk, nfiles)
        tables = [types.SimpleNamespace(keys=r, bloom=BloomFilter(r, 10))
                  for r in runs]
        pool = np.concatenate(runs)
        keys = np.concatenate([pool[rng.integers(0, len(pool), nrows // 2)],
                               rng.integers(0, 1 << 40, nrows - nrows // 2,
                                            dtype=np.uint64)])
        kraw = hash_family(keys, tables[0].bloom.k)
        if shared:
            rows = np.arange(nrows)
            segs = [(i, 0, nrows) for i in range(nfiles)]
        else:
            mins = np.array([r[0] for r in runs])
            fidx = np.searchsorted(mins, keys, side="right") - 1
            fidx[keys > runs[-1][-1]] = -1
            rows = np.nonzero(fidx >= 0)[0]
            rows = rows[np.argsort(fidx[rows], kind="stable")]
            fis, starts, counts = np.unique(fidx[rows], return_index=True,
                                            return_counts=True)
            segs = list(zip(fis.tolist(), starts.tolist(), counts.tolist()))
        segs = [(tables[i], a, c) for i, a, c in segs]
        starts = np.array([a for _, a, _ in segs], np.int64)
        counts = np.array([c for _, _, c in segs], np.int64)

        def per_table():
            return [accel.table_probe(store, t, keys[rows[a:a + c]],
                                      kraw[:, rows[a:a + c]])
                    for t, a, c in segs]

        def level():
            return accel.level_probe(store, accel.ProbeKeys(keys, kraw),
                                     [t for t, _, _ in segs], rows, starts,
                                     counts)
        call = level if level_form else per_table
        got = call()
        may = got[0] if level_form else np.concatenate([g[0] for g in got])
        pos = got[1] if level_form else np.concatenate([g[1] for g in got])
        want_may = np.concatenate([t.bloom.may_contain(
            keys[rows[a:a + c]], raw=kraw[:, rows[a:a + c]])
            for t, a, c in segs])
        want_pos = np.concatenate([np.where(
            np.isin(keys[rows[a:a + c]], t.keys), np.searchsorted(
                t.keys, keys[rows[a:a + c]]), -1) for t, a, c in segs])
        require((may == want_may).all() and (pos == want_pos).all(),
                f"{name}: the probe disagrees with the host path")
        rec = {"form": "level" if level_form else "per_table",
               "segments": len(segs), "slots": int(counts.sum()),
               "launches_per_call": 1 if level_form else len(segs),
               "device_ms": [device_ms(call, iters=20, only=CUDA_KERNELS,
                                       label=name) for _ in range(3)],
               "call_ms": [_wall_ms(call) for _ in range(3)]}
        if level_form:
            dk, dr = store.dev_cache.get, accel.ProbeKeys(keys, kraw)
            kt, kr = dr.on(store.device)
            args = (kt, kr, rows, starts, counts,
                    [dk(t.keys) for t, _, _ in segs],
                    [dk(t.bloom.bits) for t, _, _ in segs],
                    [t.bloom.nbits for t, _, _ in segs])
            choices = [(t, st) for t in TILE_CHOICES for st in STRIDE_CHOICES]
            times = {f"tile{t}_stride{st}": [] for t, st in choices}
            for order in (choices, choices[::-1]):
                for t, st in order:
                    times[f"tile{t}_stride{st}"].append(device_ms(
                        lambda t=t, st=st: kernels.lookup_probe_segments(
                            *args, _tile=t, _stride=st),
                        iters=100, only=CUDA_KERNELS,
                        label=f"{name} tile {t} stride {st}"))
            rec["choices_ms"] = times
        log(f"[kernel-times] {name}: {json.dumps(rec)}")
        res[name] = rec
    return res


def _estimate_times(kernels, device="cuda") -> dict:
    """``DecaySketch.estimate`` routed, at the adaptive run's largest call
    (a 2 x 4,096 sketch, 5,433 keys): the row hash in the kernel (this
    tree) or the host's ``_rows`` and the index-form kernel (trees before
    it); device time and the call's wall time."""
    import numpy as np
    from repro_torch.core import accel
    from repro_torch.core.adaptive.sketch import DecaySketch
    rng = np.random.default_rng(21)
    sk = DecaySketch(4096, 2, 5000.0, policy=accel.KernelPolicy(True, 1),
                     device=device)
    sk.counts = rng.random((2, 4096)) * 1e3
    keys = rng.integers(0, 1 << 40, 5433, dtype=np.uint64)
    want = sk.counts[np.arange(2)[:, None], sk._rows(keys)].min(0)
    require((sk.estimate(keys) == want).all(),
            "estimate disagrees with the host path")

    def call():
        return sk.estimate(keys)
    rec = {"form": "key" if hasattr(kernels, "sketch_estimate") else "index",
           "counters": "resident" if hasattr(kernels, "sketch_add")
           else "uploaded",
           "device_ms": [device_ms(call, iters=20, only=CUDA_KERNELS,
                                   label="estimate") for _ in range(3)],
           "call_ms": [_wall_ms(call, iters=200) for _ in range(3)]}
    log(f"[kernel-times] estimate: {json.dumps(rec)}")
    return rec


SKETCH_ADD_KEYS = (4096, 1024)


def _sketch_add_times(kernels, device="cuda") -> dict:
    """``DecaySketch.add`` routed, on a 2 x 4,096 sketch (the 1 GiB
    ``scavenger_adaptive`` configuration's) at ``SKETCH_ADD_KEYS`` keys,
    as the tree makes it: resident counters and ``sketch_add`` (this
    tree), or the host's ``_rows``, the index upload, ``segment_sum``, the
    download and the host add (trees before it).  Each call is first held
    against a host-path sketch; then the device time of the call's kernels
    (three profiler sessions), the wall ms of a call that ends waiting for
    the card, and the wall ms of the call alone (what the store waits:
    a resident add does not wait for the card)."""
    import numpy as np
    import torch
    from repro_torch.core import accel
    from repro_torch.core.adaptive.sketch import DecaySketch
    rng = np.random.default_rng(23)
    res = {}
    for q in SKETCH_ADD_KEYS:
        sk = DecaySketch(4096, 2, 5000.0, policy=accel.KernelPolicy(True, 1),
                         device=device)
        host = DecaySketch(4096, 2, 5000.0)
        start = rng.random((2, 4096)) * 1e3
        sk.counts, host.counts = start.copy(), start.copy()
        keys = rng.integers(0, 1 << 40, q, dtype=np.uint64)
        for s in (sk, host):
            s.decay_to(100.0)
            s.add(keys)
        require((sk.counts.view(np.int64) == host.counts.view(np.int64))
                .all(), f"sketch add of {q} keys disagrees with the host path")

        def call():
            sk.add(keys)

        def waited():
            sk.add(keys)
            torch.cuda.synchronize()
        rec = {"form": "resident" if hasattr(kernels, "sketch_add")
               else "host_rows_segment_sum",
               "device_ms": [device_ms(call, iters=20, only=CUDA_KERNELS,
                                       label=f"sketch add {q}")
                             for _ in range(3)],
               "call_waited_ms": [_wall_ms(waited, iters=200)
                                  for _ in range(3)],
               "call_ms": [_wall_ms(call, iters=200) for _ in range(3)]}
        torch.cuda.synchronize()
        log(f"[kernel-times] sketch_add {q}: {json.dumps(rec)}")
        res[f"keys_{q}"] = rec
    return res


def _observe_times(device="cuda", n_batches=64) -> dict:
    """One routed ``AccessTracker.observe_writes`` of 4,096 Zipf(0.99)
    keys on the 1 GiB ``scavenger_adaptive`` configuration's tracker (both
    sketches' decay, the write sketch's add, the lifetime observation), as
    the tree makes it: wall ms a call ending in a wait for the card, three
    loops over ``n_batches`` distinct batches after one warm-up loop (so
    the lifetime observations route, every group seen before)."""
    import numpy as np
    import torch
    from repro_torch.core import EngineConfig
    from repro_torch.core.adaptive.tracker import AccessTracker
    from repro_torch.workloads import ZipfKeys
    cfg = EngineConfig.scaled("scavenger_adaptive", 1 << 30,
                              est_keys=1 << 20)
    tr = AccessTracker.from_config(cfg, device)
    rng = np.random.default_rng(29)
    zipf = ZipfKeys(1 << 20, 0.99, 29)
    batches = [zipf.sample(rng, 4096).astype(np.uint64)
               for _ in range(n_batches)]

    def loop():
        t0 = time.perf_counter()
        for ks in batches:
            tr.observe_writes(ks)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / len(batches) * 1e3
    loop()
    rec = {"call_ms": [loop() for _ in range(3)],
           "device_ms": device_ms(lambda: tr.observe_writes(batches[0]),
                                  iters=20, only=CUDA_KERNELS,
                                  label="observe_writes"),
           "groups": cfg.adaptive_groups,
           "sketch": [cfg.adaptive_sketch_depth, cfg.adaptive_sketch_width]}
    log(f"[kernel-times] observe_writes: {json.dumps(rec)}")
    return rec


# (queries, files) of the level file assignment: the main path's largest
# call, a few files, and the shared-memory form's cap
INTERVAL_SHAPES = ((10942, 95), (10942, 1), (10942, 2), (10942, 4),
                   (10942, 8), (10942, 2048))


def _interval_times(kernels, device="cuda") -> dict:
    """``interval_rank`` (the ``count_le`` kernel's interval form, the
    level file assignment) at ``INTERVAL_SHAPES`` on seeded disjoint
    bounds, half the queries inside a file: held against its plain
    version, then its device time in three profiler sessions of 200
    launches each and by ``queued_ms``."""
    import numpy as np
    res = {}
    rng = np.random.default_rng(31)
    for q, n in INTERVAL_SHAPES:
        edges = np.unique(rng.integers(0, 1 << 40, 4 * n, dtype=np.uint64))
        mins, maxs = edges[0:2 * n:2], edges[1:2 * n:2]
        qs = rng.integers(0, 1 << 40, q, dtype=np.uint64)
        pick = rng.integers(0, n, q // 2)
        qs[: q // 2] = mins[pick] + (maxs[pick] - mins[pick]) // np.uint64(2)
        qt, mt, xt = (u64_tensor(a, device) for a in (qs, mins, maxs))
        err = max_abs_err((kernels.interval_rank(qt, mt, xt),),
                          (kernels.interval_rank_ref(qt, mt, xt),))
        require(err == 0, f"interval_rank disagrees with its plain version "
                          f"at q={q} n={n}")

        def call():
            return kernels.interval_rank(qt, mt, xt)
        rec = {"ms": [device_ms(call, iters=200, only=CUDA_KERNELS,
                                label=f"interval_rank {q}x{n}")
                      for _ in range(3)],
               "queued_ms": queued_ms(call, 200)}
        log(f"[kernel-times] interval_rank q={q} n={n}: {json.dumps(rec)}")
        res[f"q{q}_n{n}"] = rec
    return res


# (queries, run keys) of rank_probe's run form: the main path's memtable
# probe, the whole-run staging cap, a long run, and short runs either side
# of the staging threshold
RANK_RUN_SHAPES = ((10096, 631), (10096, 2048), (10096, 20000),
                   (10096, 1), (10096, 2), (10096, 4), (10096, 8),
                   (10096, 16), (10096, 32), (10096, 64))


RUN_TILES = (64, 128, 256)
RUN_STRIDES = (1, 2, 4, 8)


def _rank_times(kernels, device="cuda") -> dict:
    """``rank_probe``'s run form at ``RANK_RUN_SHAPES`` on seeded runs,
    half the queries run keys: held against its plain version, then its
    device time (three profiler sessions of 100 launches) as the tree
    makes it and, on a tree that takes the fence stride, searched in
    device memory (stride 0) and staged (stride 1) and, at the first
    three shapes, at ``RUN_TILES`` x ``RUN_STRIDES``."""
    import inspect
    import numpy as np
    res = {}
    rng = np.random.default_rng(37)
    choices = "_stride" in inspect.signature(kernels.rank_probe).parameters
    for q, n in RANK_RUN_SHAPES:
        run = np.unique(rng.integers(0, 1 << 40, n + n // 8 + 8,
                                     dtype=np.uint64))[:n]
        qs = rng.integers(0, 1 << 40, q, dtype=np.uint64)
        qs[: q // 2] = run[rng.integers(0, n, q // 2)]
        qt, rt = u64_tensor(qs, device), u64_tensor(run, device)
        err = max_abs_err(kernels.rank_probe(qt, rt),
                          kernels.rank_probe_ref(qt, rt))
        require(err == 0, f"rank_probe disagrees with its plain version "
                          f"at q={q} n={n}")
        rec = {"ms": device_ms(lambda: kernels.rank_probe(qt, rt),
                               iters=100, only=CUDA_KERNELS,
                               label=f"rank_probe {q}x{n}")}
        if choices:
            grid = ([(t, st) for t in RUN_TILES for st in RUN_STRIDES]
                    if n >= 631 else [(None, 0), (None, 1)])
            for tile, stride in grid:
                kw = {"_stride": stride} | (
                    {} if tile is None else {"_tile": tile})
                rec[f"tile{tile}_stride{stride}_ms"] = device_ms(
                    lambda kw=kw: kernels.rank_probe(qt, rt, **kw),
                    iters=100, only=CUDA_KERNELS,
                    label=f"rank_probe {q}x{n} {kw}")
        log(f"[kernel-times] rank_probe q={q} n={n}: {json.dumps(rec)}")
        res[f"q{q}_n{n}"] = rec
    return res


def _vsst_host_loop(value_files, fsel, ksel, vsel) -> None:
    """The host loop ``core/values/fetch.py`` ran over a batch's vSSTs
    before it grouped their keys: a mask, a gather and an
    ``SSTable.find`` a vSST, and the strict locator check."""
    import numpy as np
    from repro_torch.core.engine.tables import SSTable
    uniq, first = np.unique(fsel, return_index=True)
    for fid in uniq[np.argsort(first)].tolist():
        t = value_files[fid]
        m = fsel == fid
        pos = SSTable.find(t, ksel[m])
        require(bool((pos >= 0).all() and (t.vids[pos] == vsel[m]).all()),
                "stale locator")


# (keys, vSSTs, keys a vSST): a multi_get's finds as the main run makes
# them, its keys drawn uniformly over the records of a 1 GiB store's
# ~1,670 vSSTs of ~630 records (4,096 keys touch ~1,530 of them, ~2.7
# keys each), and smaller batches
VSST_FIND_SHAPES = ((4096, 1670, 630), (1024, 1670, 630), (128, 1670, 630))


def _vsst_find_times(kernels, device="cuda") -> dict:
    """A multi_get's vSST finds at ``VSST_FIND_SHAPES`` on seeded vSSTs:
    the wall ms of the earlier host loop (``_vsst_host_loop``, on every tree)
    and, on a tree with ``fetch.find_records``, of its host path (kernels
    off) and its routed find (the grouping, the one launch, the download
    and the locator check), both held against the host's positions, with
    the routed call alone (``accel.table_find_segments``) beside them; and
    the segmented kernel's device time at the wrapper's shape and at
    ``SEGMENT_CHOICES``."""
    from repro_torch.core import accel
    import types
    import numpy as np
    from repro_torch.core.engine.tables import SSTable
    from repro_torch.core.values import fetch

    class VSST(types.SimpleNamespace):
        find = SSTable.find

    rng = np.random.default_rng(41)
    res = {}
    for nkeys, nfiles, per in VSST_FIND_SHAPES:
        store = _stub_store(device)
        files = {}
        for f in range(nfiles):
            k = np.unique(rng.integers(0, 1 << 40, per + per // 8,
                                       dtype=np.uint64))[:per]
            files[100 + f] = VSST(
                keys=k, n=len(k), vids=rng.permutation(per).astype(
                    np.uint64) + np.uint64(1))
        store.version = types.SimpleNamespace(value_files=files)
        fsel = 100 + rng.integers(0, nfiles, nkeys)
        pos = rng.integers(0, per, nkeys)
        ksel = np.array([files[f].keys[j] for f, j in
                         zip(fsel.tolist(), pos.tolist())], np.uint64)
        vsel = np.array([files[f].vids[j] for f, j in
                         zip(fsel.tolist(), pos.tolist())], np.uint64)
        _vsst_host_loop(files, fsel, ksel, vsel)
        rec = {"vssts": len(np.unique(fsel)), "keys": nkeys,
               "host_ms": [_wall_ms(lambda: _vsst_host_loop(
                   files, fsel, ksel, vsel), iters=20) for _ in range(3)]}
        if hasattr(fetch, "find_records"):
            def find(pol):
                store.cfg._kernel_policy = pol
                return fetch.find_records(store, fsel, ksel, vsel, True)
            on, off = accel.KernelPolicy(True, 1), accel.KernelPolicy(False)
            order, got_rank, got_pos = find(on)
            want = np.concatenate([np.searchsorted(
                files[f].keys, ksel[fsel == f]) for f in order.tolist()])
            require(bool((got_pos == want).all()
                         and (find(off)[2] == want).all()),
                    "the routed vSST find disagrees with the host's")
            rec["host_grouped_ms"] = [_wall_ms(lambda: find(off), iters=20)
                                      for _ in range(3)]
            rec["routed_ms"] = [_wall_ms(lambda: find(on), iters=20)
                                for _ in range(3)]
            counts = np.bincount(got_rank, minlength=len(order))
            starts = np.cumsum(counts) - counts
            kg = np.concatenate([ksel[fsel == f] for f in order.tolist()])
            tables = [files[f] for f in order.tolist()]
            rec["call_ms"] = [_wall_ms(lambda: accel.table_find_segments(
                store, tables, kg, starts, counts), iters=20)
                for _ in range(3)]
            args = (u64_tensor(kg, device), starts, counts,
                    [store.dev_cache.get_rows(t.keys, t.vids)
                     for t in tables])
            kw = {"values": True}
            rec["device_ms"] = device_ms(
                lambda: kernels.rank_probe_segments(*args, **kw), iters=100,
                only=CUDA_KERNELS, label=f"rank_probe_segments {nkeys}")
            rec["choices_ms"] = _segment_choices(kernels, args, kw)
        log(f"[kernel-times] vsst_find {nkeys}: {json.dumps(rec)}")
        res[f"keys_{nkeys}"] = rec
    return res


def _merge_times(device="cuda") -> dict:
    """``merge_dedup`` at the kernel benchmark's ``bench`` (2 x 2,048
    equal runs) and ``deploy`` (2 x 2^19 sharing half their keys) shapes:
    held against its plain version, then its device time (three profiler
    sessions of 100 launches) and the wrapper call's, and on a tree that
    takes the rows a thread merges, ``_merge_items_sweep``."""
    import inspect
    from repro_torch.bench import kernels as bench
    from repro_torch.kernels import merge_dedup
    res = {}
    choices = "_items" in inspect.signature(merge_dedup).parameters
    for case in bench.bench_cases() + bench.deploy_cases():
        if case.kernel != "merge_dedup":
            continue
        args = bench.operands(case, device)
        fn = bench.wrapper(case)
        err = max_abs_err(fn(*args), bench.plain(case)(*args))
        require(err == 0, f"merge_dedup disagrees with its plain version "
                          f"at the {case.shapes} shape")
        rec = {"shape": case.shape,
               "ms": [device_ms(lambda: fn(*args), iters=100,
                                only=CUDA_KERNELS,
                                label=f"merge_dedup {case.shapes}")
                      for _ in range(2)],
               "call_ms": call_ms(lambda: fn(*args), iters=100)}
        log(f"[kernel-times] merge_dedup {case.shapes}: {json.dumps(rec)}")
        res[case.shapes] = rec
    if choices:
        res["items_by_rows"] = _merge_items_sweep(merge_dedup, device)
    return res


# rows of the merges at which merge_dedup's two shapes are timed, each two
# runs of half the rows sharing half their keys (the deploy shape's mix)
MERGE_SWEEP_ROWS = tuple(1 << e for e in range(12, 21))


def _merge_items_sweep(merge_dedup, device="cuda") -> dict:
    """``merge_dedup``'s device ms at 1 and at 8 rows a thread over
    ``MERGE_SWEEP_ROWS``, in the order 1, 8, 8, 1 at each size, each held
    against the plain version; -> {rows: {items: [first, second]}}."""
    import numpy as np
    from repro_torch.kernels import merge_dedup_ref
    from repro_torch.kernels.common import u32_tensor
    rng = np.random.default_rng(23)
    out = {}
    for n in MERGE_SWEEP_ROWS:
        half = n // 2
        pool = np.unique(rng.integers(0, 1 << 32, 2 * n, dtype=np.uint64))
        pool = rng.permutation(pool[:half + half // 2])
        ak = np.sort(pool[:half]).astype(np.uint32)
        bk = np.sort(pool[half // 2:half // 2 + half]).astype(np.uint32)
        args = tuple(u32_tensor(c, device) for c in (
            ak, np.full(half, 2, np.uint32), ak ^ 1,
            bk, np.full(half, 1, np.uint32), bk ^ 2))
        want = merge_dedup_ref(*args)
        rec = {}
        for items in (1, 8, 8, 1):
            if items not in rec:
                require(max_abs_err(merge_dedup(*args, _items=items),
                                    want) == 0,
                        f"merge_dedup disagrees with its plain version at "
                        f"{n} rows, {items} a thread")
            rec.setdefault(items, []).append(device_ms(
                lambda: merge_dedup(*args, _items=items), iters=100,
                only=CUDA_KERNELS, label=f"merge_dedup {n} items {items}"))
        log(f"[kernel-times] merge_dedup rows {n}: {json.dumps(rec)}")
        out[n] = rec
    return out


def _split_us(fn, iters: int = 100) -> dict:
    """{kernel: device us a launch} of what ``fn`` issues, over every
    launch that ``PROFILE_SESSIONS`` profiler sessions of ``iters`` calls
    recorded; a kernel is named by the longest ``CUDA_KERNELS`` name in
    the profiler's."""
    def loop():
        for _ in range(iters):
            fn()
    total = {}
    for _ in range(PROFILE_SESSIONS):
        for key, (n, us) in kernel_records(loop, CUDA_KERNELS).items():
            name = max((k for k in CUDA_KERNELS if k in key), key=len)
            tn, tus = total.get(name, (0, 0.0))
            total[name] = (tn + n, tus + us)
    return {k: us / n for k, (n, us) in total.items()}


def _bench_args(kernel: str, device="cuda") -> list:
    """[(shapes, shape, operands on device, the plain version's outputs)]
    of ``kernel``'s cases at the kernel benchmark's two shapes."""
    from repro_torch.bench import kernels as bench
    out = []
    for case in bench.bench_cases() + bench.deploy_cases():
        if case.kernel == kernel:
            args = bench.operands(case, device)
            out.append((case.shapes, case.shape, args,
                        bench.plain(case)(*args)))
    return out


def _partition_times(device="cuda") -> dict:
    """``hot_cold_partition`` at the kernel benchmark's ``bench`` (4,096
    records) and ``deploy`` (2^20, 315,002 hot) shapes: held against its
    plain version, then its device time (two sets of three profiler
    sessions of 100 launches), split by kernel (``_split_us``: each
    kernel's device us a launch), and the wrapper call's."""
    from repro_torch.kernels import hot_cold_partition
    res = {}
    for shapes, shape, args, want in _bench_args("hot_cold_partition",
                                                 device):
        require(max_abs_err(hot_cold_partition(*args), want) == 0,
                f"hot_cold_partition disagrees with its plain version at "
                f"the {shapes} shape")

        def fn():
            return hot_cold_partition(*args)
        rec = {"shape": shape,
               "ms": [device_ms(fn, iters=100, only=CUDA_KERNELS,
                                label=f"hot_cold_partition {shapes}")
                      for _ in range(2)],
               "by_kernel_us": _split_us(fn),
               "call_ms": call_ms(fn, iters=100)}
        log(f"[kernel-times] hot_cold_partition {shapes}: "
            f"{json.dumps(rec)}")
        res[shapes] = rec
    return res


def _gc_lookup_times(device="cuda") -> dict:
    """``gc_lookup`` at the kernel benchmark's ``bench`` (1,024 queries
    over 8,192 keys) and ``deploy`` (65,536 over 2^20) shapes: held
    against its plain version, then its device time (two sets of three
    profiler sessions of 100 launches), the wrapper call's and
    ``torch.searchsorted``'s (ranks only)."""
    import torch
    from repro_torch.kernels import gc_lookup
    m32 = -(1 << 31)                   # int32 XOR: u32 order as signed order
    res = {}
    for shapes, shape, args, want in _bench_args("gc_lookup", device):
        require(max_abs_err(gc_lookup(*args), want) == 0,
                f"gc_lookup disagrees with its plain version at the "
                f"{shapes} shape")

        def fn():
            return gc_lookup(*args)
        qo, ko = args[0] ^ m32, args[1] ^ m32
        rec = {"shape": shape,
               "ms": [device_ms(fn, iters=100, only=CUDA_KERNELS,
                                label=f"gc_lookup {shapes}")
                      for _ in range(2)],
               "call_ms": call_ms(fn, iters=100),
               "library_ms": device_ms(lambda: torch.searchsorted(ko, qo),
                                       iters=100,
                                       label=f"searchsorted {shapes}")}
        log(f"[kernel-times] gc_lookup {shapes}: {json.dumps(rec)}")
        res[shapes] = rec
    return res


# bytes written between two launches for a cold-L2 time: 2.5x the H100's
# 50 MB L2
L2_FLUSH_BYTES = 128 << 20


@functools.lru_cache(maxsize=None)
def _flush_buffer():
    import torch
    return torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")


def _after_flush(fn):
    """``fn`` behind a write of L2_FLUSH_BYTES, so that it finds its
    operands out of L2 (a torch fill kernel, which no ``CUDA_KERNELS`` name
    matches, so a profiled time leaves it out)."""
    def cold():
        _flush_buffer().fill_(7)
        return fn()
    return cold


# segment_sum's index form past the tracker's size: (ids, slots), the ids
# uniform over the slots
SEGMENT_SHAPES = tuple((p, s) for s in (1024, 32576, 65536, 131072, 262144,
                                        1 << 20, 1 << 25)
                       for p in (1018, 2048, 4096, 6144, 8192, 16384,
                                 1 << 20))


def _segment_shape_times(device="cuda") -> dict:
    """``segment_sum``'s index form at ``SEGMENT_SHAPES``: held against
    numpy's bincount, then its device time (memset included; two sets of
    three profiler sessions of 10 launches), as that tree makes it."""
    import numpy as np
    import torch
    from repro_torch.kernels import segment_sum
    rng = np.random.default_rng(23)
    res = {}
    for p, slots in SEGMENT_SHAPES:
        ids_np = rng.integers(0, slots, p)
        ids = torch.from_numpy(ids_np).to(device)
        got = segment_sum(ids, slots).cpu().numpy()
        require((got == np.bincount(ids_np, minlength=slots)).all(),
                f"segment_sum disagrees with numpy at {p} x {slots}")

        def fn():
            return segment_sum(ids, slots)
        res[f"{p}x{slots}"] = [device_ms(fn, iters=10, only=CUDA_KERNELS,
                                         label=f"segment_sum {p}x{slots}")
                               for _ in range(2)]
    log(f"[kernel-times] segment_sum shapes: {json.dumps(res)}")
    return res


def _bloom_times(device="cuda") -> dict:
    """``bloom_probe`` at the kernel benchmark's ``bench`` (1,024 queries
    against 8,192 keys' filter) and ``deploy`` (65,536 queries, k 7,
    nbits 10,485,760) shapes: held against its plain version, then its
    device time with the filter in L2 (two sets of three profiler sessions
    of 100 launches), the wrapper call's, and its cold-L2 device time (an
    L2_FLUSH_BYTES buffer written before each launch, the write not
    counted; two sets of three sessions of 20 launches)."""
    from repro_torch.kernels import bloom_probe
    res = {}
    for shapes, shape, args, want in _bench_args("bloom_probe", device):
        require(max_abs_err(bloom_probe(*args), want) == 0,
                f"bloom_probe disagrees with its plain version at the "
                f"{shapes} shape")

        def fn():
            return bloom_probe(*args)
        rec = {"shape": shape,
               "ms": [device_ms(fn, iters=100, only=CUDA_KERNELS,
                                label=f"bloom_probe {shapes}")
                      for _ in range(2)],
               "call_ms": call_ms(fn, iters=100),
               "cold_ms": [device_ms(_after_flush(fn), iters=20,
                                     only=CUDA_KERNELS,
                                     label=f"bloom_probe cold {shapes}")
                           for _ in range(2)]}
        log(f"[kernel-times] bloom_probe {shapes}: {json.dumps(rec)}")
        res[shapes] = rec
    return res


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--crossover", action="store_true",
                    help="run only phase 4, on a 2^18-key store")
    ap.add_argument("--kernel-times", action="store_true",
                    help="only build the library and time segment_sum and "
                         "gather_min64 at the adaptive run's shapes, "
                         "run_coalesce at M from 64 to 8,192, a level's "
                         "table probes, the sketch estimate and add, the "
                         "tracker's observe_writes, interval_rank, "
                         "rank_probe's two forms, a multi_get's vSST finds, "
                         "merge_dedup, hot_cold_partition, gc_lookup, "
                         "bloom_probe and segment_sum over 1,018 to 2^20 "
                         "ids into 1,024 to 2^25 slots")
    ap.add_argument("--only", default=None,
                    help="with --kernel-times: the parts to time, comma-"
                         "separated (the keys of its record, e.g. "
                         "hot_cold_partition,gc_lookup); default all")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="directory holding the repro_torch package")
    args = ap.parse_args(argv)
    if not (args.src / "repro_torch").is_dir():
        print(f"chip_smoke: {args.src}/repro_torch not found",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.crossover:
        crossover_only(args.src)
        return 0
    if args.kernel_times:
        kernel_times_only(args.src, args.only and args.only.split(","))
        return 0
    sys.path.insert(0, str(args.src.resolve()))
    t_start = time.perf_counter()

    def mark(phase):        # the script's clock at each phase's end
        log(f"[time] {phase} done at {time.perf_counter() - t_start:.1f}s")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    build_phase()
    kernel_phase("cuda")
    mark("kernels")
    bench_recs = bench_phase("cuda")
    mark("bench")
    cap = Capture()
    main, store = main_run("cuda", capture=cap)
    for name in MAIN_KERNELS:
        require(main["launches"][name] > 0,
                f"kernel {name} was not launched in the main run")
    for form, n in main["rank_probe_by_form"].items():
        require(n > 0, f"rank_probe's {form} form was not launched in the "
                       f"main run")
    mark("main")
    crossover_phase(store)
    mark("crossover")
    del store
    adaptive = adaptive_run("cuda", capture=cap)
    mark("adaptive")
    for name in ADAPTIVE_KERNELS:
        require(adaptive["launches"][name] > 0,
                f"kernel {name} was not launched in the adaptive run")
    for form, n in adaptive["segment_sum_by_form"].items():
        require(n > 0, f"segment_sum's {form} form was not launched in the "
                       f"adaptive run")
    # each kernel's count from the run that carries it
    launches = {name: (main if name in MAIN_KERNELS else adaptive)
                ["launches"][name] for name in ADAPTIVE_KERNELS}
    recs, forms = shapes_phase(cap, launches,
                               adaptive["segment_sum_by_form"],
                               main["rank_probe_by_form"])
    recs += bench_recs
    log("[shapes] level probes of the two store runs: "
        + json.dumps(cap.levels))
    mark("shapes")
    parity_phase()
    mark("parity")
    crash_phase()
    mark("crash")
    fleet = fleet_run("cuda")
    require(fleet["n_migrations"] >= 1, "the fleet never migrated a range")
    require(fleet["n_shards"] > FLEET_SHARDS, "the fleet never split")
    for name in MAIN_KERNELS:
        require(fleet["launches"][name] > 0,
                f"kernel {name} was not launched in the fleet run")
    for form, n in fleet["rank_probe_by_form"].items():
        require(n > 0, f"rank_probe's {form} form was not launched in the "
                       f"fleet run")
    mark("fleet")
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"other_forms": forms}))
    print(json.dumps({"kernels": recs}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
