#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. build   — compile ``src/repro_torch/kernels/csrc/kernels.cu`` for sm_90a
             and load it;
2. kernels — each of the six CUDA kernels against its plain torch version
             on the card, at adversarial shapes (Q=1, N=0, N=1, duplicate
             keys, queries at the run's min and max, keys >= 2^32 and
             >= 2^63, coalesce columns past the shared-memory sort cap;
             empty, all-masked and out-of-range ids, one slot; D from 1 to
             4, W not a power of two, counters of 0.0 and -0.0 and patterns
             that differ only in the low 32 bits); outputs must be equal
             exactly;
3. main    — one ``scavenger`` Store on the card at a 1 GiB dataset
             (2^20 keys x 1 KiB values, keys drawn from [0, 2^40)): load,
             one uniform update pass, 262,144 multi_get keys and 1,024 scans
             of 10, every acknowledged write read back and checked against
             the vids ``Store.write`` returned.  The four probe and fetch
             kernels' launch counts are zeroed just before and read just
             after; each must be > 0;
4. crossover — on the main run's store, the wall time of one routed call
             (upload, kernel, download) against the host NumPy path it
             replaces, per op and batch size: where routing starts to pay
             (``EngineConfig.kernel_min_batch``), for the four probe and
             fetch ops and the access tracker's three;
5. adaptive — one durable ``scavenger_adaptive`` Store on the card at the
             same 1 GiB scale: load 2^20 keys, one update pass of 2^20
             Zipf(0.99) ops with a checkpoint halfway and a crash injected
             late in the pass; ``Store.open(dir, device="cuda")`` recovers
             it and every acknowledged write reads back; the pass finishes,
             the store closes and reopens to the same ``stats()``.  All six
             kernels' launch counts are zeroed just before and read just
             after; each must be > 0;
6. shapes  — each kernel against its plain version again, on the largest
             inputs the main and adaptive runs gave it, timed with CUDA
             events beside its plain version, a PyTorch library call and
             its bound;
7. parity  — the seven engines (``scavenger_adaptive`` with its tracker on
             and off) on the fixed mixed op stream of the reference
             package's parity test: the port on the card with kernels on
             (at the default routing threshold, and with every probe
             routed) against the port on the CPU with kernels off (stats,
             every multi_get vid, every scan row);
8. crash   — the durability crash matrix on the card: seven engines x the
             five store crash points (the GC points only where the engine
             runs standalone GC), each recovered with ``Store.open(...,
             device="cuda")`` and held against an uninterrupted CPU run at
             the crash watermark.

``python3 chip_smoke.py --crossover [--src DIR]`` runs phase 4 alone on a
smaller store (2^18 keys), against the port under ``DIR/repro_torch``
(default ``src``): run it on two trees in one call to compare them.

The second-to-last line of output is the card's name and power limit, the
one before it the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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
}
# the kernels each run of the store must launch
MAIN_KERNELS = ("lookup_probe", "rank_probe", "count_le", "run_coalesce")
ADAPTIVE_KERNELS = MAIN_KERNELS + ("segment_sum", "gather_min64")
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
CUDA_KERNELS = ("rank_probe_kernel", "lookup_probe_kernel", "count_le_kernel",
                "coalesce_smem_kernel", "pack_kernel", "bitonic_stage_kernel",
                "mark_kernel", "segment_sum_kernel", "gather_min64_kernel",
                # segment_sum zeroes its counts with a memset on the stream
                "Memset")


def device_busy_us(fn, only=None) -> float:
    """Device time (us) of the kernels, copies and fills ``fn`` issues
    (those whose name contains one of ``only``, if given), from the
    profiler's CUDA activity records."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and (only is None or any(k in e.key for k in only)))


def device_ms(fn, iters: int = 20, warmup: int = 3, only=None) -> float:
    """Mean device time (ms) per call of ``fn`` (warm L2: the main path
    reprobes the same columns); raises if no device work was recorded.

    A profiling session sometimes returns none of its kernel records
    (seen once on the H100 machine, after the main run's long sessions),
    so an empty session is repeated, up to three sessions."""
    for _ in range(warmup):
        fn()

    def loop():
        for _ in range(iters):
            fn()
    for attempt in (1, 2, 3):
        us = device_busy_us(loop, only)
        if us > 0:
            return us / iters / 1e3
        log(f"[profile] session {attempt} recorded no device time")
    raise SmokeFailure("the profiler recorded no device time")


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


def _check_coalesce_case(rng, device, m, errs, hi_rank, hi_pos):
    import numpy as np
    from repro_torch import kernels
    r = rng.integers(0, hi_rank, m).astype(np.int64)
    p = rng.integers(0, hi_pos, m).astype(np.int64)
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


def kernel_phase(device) -> dict:
    """Adversarial shapes; -> max abs error per kernel (all must be 0)."""
    import numpy as np
    from repro_torch.kernels.common import smem_sort_cap
    rng = np.random.default_rng(7)
    errs = {k: 0 for k in REPLACES}
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
                      (4096, 400, 3000), (cap, 1000, 2**32 - 2),
                      (cap + 1, 10, 2**20), (20000, 2**32 - 2, 200)):
        _check_coalesce_case(rng, device, m, errs, hr, hp)
    _check_segment_cases(rng, device, errs)
    log("[kernels] max abs err at adversarial shapes: " + json.dumps(errs))
    for k, e in errs.items():
        require(e == 0, f"kernel {k} disagrees with its plain version")
    return errs


# ------------------------------------------------------------ 3. main
class Capture:
    """Keeps a copy of the largest inputs the store runs give each kernel
    (wraps the package-level wrappers that ``core/accel.py`` and
    ``core/adaptive/`` call)."""

    NAMES = ("rank_probe", "lookup_probe", "interval_rank", "run_coalesce",
             "segment_sum", "gather_min64")

    def __init__(self):
        import repro_torch.kernels as K
        self.K = K
        self.orig = {n: getattr(K, n) for n in self.NAMES}
        self.best: dict = {}

    def __enter__(self):
        for n in self.NAMES:
            setattr(self.K, n, self._wrap(n, self.orig[n]))
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.K, n, f)

    def _wrap(self, name, fn):
        def call(*args, **kw):
            if name == "segment_sum":     # ids + slots
                size = args[0].shape[0] + args[1]
            elif name == "gather_min64":  # table + queries
                size = args[0].numel() + args[1].numel()
            else:   # work ~ queries x run length (first two operands)
                size = args[0].shape[0] * (args[1].shape[0] + 1)
            if name not in self.best or size > self.best[name][0]:
                self.best[name] = (size, [a.clone() if hasattr(a, "clone")
                                          else a for a in args], kw)
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
    for fn in kernels.KERNELS:
        fn.launches = 0
    with capture if capture is not None else contextlib.nullcontext():
        timed("load", n_keys, lambda: write_pass(keys))
        for u in range(update_passes):
            timed(f"update{u}", n_keys,
                  lambda: write_pass(rng.permutation(keys)))
        timed("multi_get", n_gets, lambda: gets(n_gets))
        timed("multi_scan", n_scans, scans)
    launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    log("[main] launches: " + json.dumps(launches))

    def readback():
        for i in range(0, n_keys, batch):
            ks = keys[i:i + batch]
            check_gets(ks, store.multi_get(ks))
    timed("readback", n_keys, readback)
    st = store.stats()

    busy = {}
    if cuda:
        # device busy share of 16 update and 16 multi_get batches: the
        # profiler's CUDA records over a wall-clock window
        for name, fn in (
                ("update",
                 lambda: write_pass(rng.permutation(keys)[:16 * batch])),
                ("multi_get", lambda: gets(16 * batch))):
            wall = []

            def window(fn=fn, wall=wall):
                t0 = time.perf_counter()
                fn()
                sync()
                wall.append(time.perf_counter() - t0)
            us = device_busy_us(window)
            busy[name] = {"device_busy_s": us / 1e6, "wall_s": wall[0],
                          "idle_share": 1 - us / 1e6 / wall[0]}
    out = {"phases": phases, "launches": launches, "device_busy": busy,
           "space_amp": st["space_amp"], "write_amp": st["write_amp"],
           "n_gc_runs": st["n_gc_runs"], "n_compactions": st["n_compactions"],
           "sim_clock_s": st["clock_s"]}
    log("[main] " + json.dumps(out))
    return out, store


# -------------------------------------------------------- 5. adaptive
def zipf_sampler(n: int, theta: float, seed: int):
    """YCSB scrambled-zipfian ranks over [0, n): the generator of the
    reference's ``workloads.ZipfKeys`` (inverse CDF over the 10,000-rank
    head, uniform tail, splitmix64 scramble), the ``skewed`` workload of
    ``benchmarks/adaptive_gc.py``.  -> sample(rng, m) -> int64 ranks."""
    import numpy as np
    from repro_torch.core.engine.keys import splitmix64
    head = min(n, 10_000)
    w = np.arange(1, head + 1, dtype=np.float64) ** (-theta)
    tail = ((n ** (1 - theta)) - (head ** (1 - theta))) / (1 - theta) \
        if n > head else 0.0
    cdf = np.cumsum(w) / (w.sum() + tail)
    perm = np.uint64(seed * 2654435761 + 1)

    def sample(rng, m):
        u = rng.random(m)
        is_head = u < cdf[-1]
        out = np.empty(m, np.int64)
        out[is_head] = np.searchsorted(cdf, u[is_head])
        n_tail = int((~is_head).sum())
        if n_tail:
            out[~is_head] = rng.integers(head, n, n_tail)
        scram = splitmix64(out.astype(np.uint64) ^ perm)
        return (scram % np.uint64(n)).astype(np.int64)
    return sample


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
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, key_space, n_keys + n_keys // 8,
                                  dtype=np.uint64))
    require(len(keys) >= n_keys, "key draw too small")
    keys = rng.permutation(keys[:n_keys])
    zipf = zipf_sampler(n_keys, theta, seed)
    n_batches = n_keys // batch
    update = [keys[zipf(rng, batch)] for _ in range(n_batches)]
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

    for fn in kernels.KERNELS:
        fn.launches = 0
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
    log("[adaptive] launches: " + json.dumps(launches))
    st = store.stats()
    wb = store.io.write_bytes
    busy = {}
    if cuda:
        # device busy share of 16 more update batches: the profiler's CUDA
        # records over a wall-clock window
        wall = []

        def window():
            t0 = time.perf_counter()
            for ks in update[:16]:
                put(store, ks)
            sync()
            wall.append(time.perf_counter() - t0)
        us = device_busy_us(window)
        busy["update"] = {"device_busy_s": us / 1e6, "wall_s": wall[0],
                          "idle_share": 1 - us / 1e6 / wall[0]}
    store.close()
    tmp.cleanup()
    out = {"phases": phases, "launches": launches, "device_busy": busy,
           "crash_point": crash_point, "crashed_batch": crashed,
           "space_amp": st["space_amp"], "write_amp": st["write_amp"],
           "n_gc_runs": st["n_gc_runs"],
           "gc_rewrite_bytes": wb.get(sio.CAT_GC_WRITE, 0)
           + wb.get(sio.CAT_GC_WRITE_INDEX, 0),
           "n_compactions": st["n_compactions"], "sim_clock_s": st["clock_s"]}
    log("[adaptive] " + json.dumps(out))
    return out


# ---------------------------------------------------------- 6. shapes
def _bound(nbytes: float, nops: float):
    tb, to = nbytes / PEAK_BYTES_S * 1e3, nops / PEAK_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def shapes_phase(capture: Capture, launches: dict) -> list:
    """Main-path inputs: exact check + timings.  -> kernel records.

    ``launches``: each kernel's count from the run that carries it (the
    main run for the probes and fetch planning, the adaptive run for the
    segment-reduce kernels)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.common import u64_order
    best = capture.best
    for name in Capture.NAMES:
        require(name in best, f"no store run called {name}")
    recs = []

    def record(name, args, kern, plain, lib, nbytes, nops):
        err = max_abs_err(kern(), plain())
        require(err == 0, f"{name} disagrees with its plain version at "
                          f"main-path shapes")
        # ms: the CUDA kernels alone (a wrapper's operand checks are not
        # the kernel); call_ms: the whole wrapper call as the store makes it
        ms = device_ms(kern, only=CUDA_KERNELS)
        plain_ms = device_ms(plain, iters=5)
        lib_ms = device_ms(lib) if lib is not None else None
        bound_ms, bound_by = _bound(nbytes, nops)
        rec = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[name], "launches": launches[name],
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": lib_ms, "call_ms": call_ms(kern),
               "shape": [list(a.shape) if hasattr(a, "shape") else a
                         for a in args]}
        log(f"[shapes] {json.dumps(rec)}")
        recs.append(rec)

    q, run, bit_idx, words = best["lookup_probe"][1]
    nq, n, k, w = q.shape[0], run.shape[0], bit_idx.shape[1], words.shape[0]
    qo, ro = u64_order(q), u64_order(run)
    record("lookup_probe", (q, run, bit_idx, words),
           lambda: kernels.lookup_probe(q, run, bit_idx, words),
           lambda: kernels.lookup_probe_ref(q, run, bit_idx, words),
           None, 8 * nq + 8 * n + 8 * nq * k + 8 * w + 10 * nq,
           nq * (math.log2(n + 1) + 2 * k))

    q, run = best["rank_probe"][1]
    nq, n = q.shape[0], run.shape[0]
    qo, ro = u64_order(q), u64_order(run)
    record("rank_probe", (q, run),
           lambda: kernels.rank_probe(q, run),
           lambda: kernels.rank_probe_ref(q, run),
           lambda: torch.searchsorted(ro, qo),
           8 * nq + 8 * n + 9 * nq, nq * math.log2(n + 1))

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

    (r, p), kw = best["run_coalesce"][1], best["run_coalesce"][2]
    m = r.shape[0]
    mp = 1 << max(1, (m - 1).bit_length())
    stages = math.log2(mp) * (math.log2(mp) + 1) / 2
    packed = u64_order((r << 32) | p)
    record("run_coalesce", (r, p),
           lambda: kernels.run_coalesce(r, p, **kw),
           lambda: kernels.run_coalesce_ref(r, p, kw.get("window")),
           lambda: torch.sort(packed),
           16 * m + 18 * m, mp / 2 * stages + 4 * m)

    # segment_sum's time holds its memset of the counts; one id -> one add
    ids, slots = best["segment_sum"][1]
    p = ids.shape[0]
    valid = ids[(ids >= 0) & (ids < slots)]
    record("segment_sum", (ids, slots),
           lambda: (kernels.segment_sum(ids, slots),),
           lambda: (kernels.segment_sum_ref(ids, slots),),
           lambda: torch.bincount(valid, minlength=slots),
           8 * p + 8 * slots, p)

    bits, idx = best["gather_min64"][1]
    (d, w), q = bits.shape, idx.shape[0]
    record("gather_min64", (bits, idx),
           lambda: (kernels.gather_min64(bits, idx),),
           lambda: (kernels.gather_min64_ref(bits, idx),),
           None, 8 * d * w + 8 * q * d + 8 * q, q * d)
    return recs


# ---------------------------------------------------------- 7. parity
def fixed_workload(engine: str, device, **overrides):
    """The reference parity test's op stream (tests/test_refactor_parity.py
    ``run_fixed_workload``) -> (stats, multi_get vids, scan rows)."""
    import numpy as np
    from repro_torch.core import EngineConfig, Store, WriteBatch
    n_keys = 4096
    vsizes = np.array([64, 200, 600, 2000, 9000], np.int64)
    cfg = EngineConfig.scaled(engine, 8 << 20, est_keys=n_keys, **overrides)
    store = Store(cfg, device=device)
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
    store's own columns, the access tracker's sketch add, lifetime observe
    (``segment_sum``) and sketch estimate (``gather_min64``) on a tracker
    of the 1 GiB ``scavenger_adaptive`` configuration's widths.  A routed
    call returns host arrays, so its time holds the upload, the kernel and
    the download.  -> {op: {"rows": [...], "crossover": the smallest size
    from which the routed call is never slower, or None}}."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.core import EngineConfig, accel
    from repro_torch.core.adaptive.lifetime import LifetimeEstimator
    from repro_torch.core.adaptive.sketch import DecaySketch
    from repro_torch.core.engine.keys import BloomFilter, hash_family
    from repro_torch.core.values.fetch import split_runs
    rng = np.random.default_rng(11)
    v = store.version
    tables = [t for lvl in v.levels for t in lvl]
    require(bool(tables), "crossover: the store has no key tables")
    tab = max(tables, key=lambda t: len(t.keys))
    vtab = max(v.value_files.values(), key=lambda t: len(t.keys))
    lvl = max(range(1, store.cfg.max_levels), key=lambda i: len(v.levels[i]))
    require(len(v.levels[lvl]) > 0, "crossover: no level below L0")
    lkeys = np.concatenate([t.keys for t in v.levels[lvl]])
    k = BloomFilter.k_for(store.cfg.filter_bits_per_key)
    window = store.cfg.coalesce_window
    saved = getattr(store.cfg, "_kernel_policy", None)
    store.cfg._kernel_policy = accel.KernelPolicy(True, 1, window)

    def draw(col, b):       # half present keys, half random ones
        ks = col[rng.integers(0, len(col), b)]
        ks[b // 2:] = rng.integers(0, 1 << 40, b - b // 2, dtype=np.uint64)
        return ks

    def lookup_host(ks, kraw):
        may = tab.bloom.may_contain(ks, raw=kraw)
        return may, tab.find(ks[may])

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
        ks, vks, lks = draw(tab.keys, b), draw(vtab.keys, b), draw(lkeys, b)
        kraw = hash_family(ks, k)
        # one multi_get's fetches: ~10 keys per vSST, grouped by file
        ranks = np.sort(rng.integers(0, max(1, b // 10), b)).astype(np.int64)
        pos = rng.integers(0, 4 * b, b).astype(np.int64)
        tks = rng.integers(0, 1 << 40, b, dtype=np.uint64)
        # lifetime observe routes one row per distinct group seen before
        groups = rng.permutation(acfg.adaptive_groups)[:b]
        return {  # op: (host path, routed path)
            "lookup_probe": (lambda: lookup_host(ks, kraw),
                             lambda: accel.table_probe(store, tab, ks, kraw)),
            "rank_probe": (lambda: vtab.find(vks),
                           lambda: accel.table_find(store, vtab, vks)),
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
        log(f"[crossover] {name}: " + json.dumps(out[name]))
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
    sys.path.insert(0, str(args.src.resolve()))
    t_start = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    build_phase()
    kernel_phase("cuda")
    cap = Capture()
    main, store = main_run("cuda", capture=cap)
    for name in MAIN_KERNELS:
        require(main["launches"][name] > 0,
                f"kernel {name} was not launched in the main run")
    crossover_phase(store)
    del store
    adaptive = adaptive_run("cuda", capture=cap)
    for name in ADAPTIVE_KERNELS:
        require(adaptive["launches"][name] > 0,
                f"kernel {name} was not launched in the adaptive run")
    # each kernel's count from the run that carries it
    launches = {name: (main if name in MAIN_KERNELS else adaptive)
                ["launches"][name] for name in REPLACES}
    recs = shapes_phase(cap, launches)
    parity_phase()
    crash_phase()
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": recs}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
