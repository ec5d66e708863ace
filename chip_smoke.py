#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. build   — compile ``src/repro_torch/kernels/csrc/kernels.cu`` for sm_90a
             and load it;
2. kernels — each of the four CUDA kernels against its plain torch version
             on the card, at adversarial shapes (Q=1, N=0, N=1, duplicate
             keys, queries at the run's min and max, keys >= 2^32 and
             >= 2^63, coalesce columns past the shared-memory sort cap);
             integer outputs must be equal exactly;
3. main    — one ``scavenger`` Store on the card at a 1 GiB dataset
             (2^20 keys x 1 KiB values, keys drawn from [0, 2^40)): load,
             one uniform update pass, 262,144 multi_get keys and 1,024 scans
             of 10, every acknowledged write read back and checked against
             the vids ``Store.write`` returned.  Kernel launch counts are
             zeroed just before and read just after; each must be > 0;
4. shapes  — each kernel against its plain version again, on the largest
             inputs the main run gave it, timed with CUDA events beside its
             plain version, a PyTorch library call and its bound;
5. parity  — the six engines on the fixed mixed op stream of the reference
             package's parity test: the port on the card with kernels on
             (at the default routing threshold, and with every probe
             routed) against the port on the CPU with kernels off (stats,
             every multi_get vid, every scan row);
6. crossover — on the main run's store, the wall time of one routed call
             (upload, kernel, download) against the host NumPy path it
             replaces, per op and batch size: where routing starts to pay
             (``EngineConfig.kernel_min_batch``).

``python3 chip_smoke.py --crossover [--src DIR]`` runs phase 6 alone on a
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
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense): HBM bytes/s, and float32 outside the
# tensor cores, the closest published rate for the kernels' integer work
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

ENGINES = ("rocksdb", "blobdb", "titan", "terarkdb", "scavenger", "hybrid")
REPLACES = {
    "lookup_probe": "src/repro/kernels/lookup_probe/kernel.py:102",
    "rank_probe": "src/repro/kernels/lookup_probe/kernel.py:134",
    "count_le": "src/repro/kernels/lookup_probe/kernel.py:158",
    "run_coalesce": "src/repro/kernels/run_coalesce/kernel.py:47",
}
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
                "mark_kernel")


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
    log("[kernels] max abs err at adversarial shapes: " + json.dumps(errs))
    for k, e in errs.items():
        require(e == 0, f"kernel {k} disagrees with its plain version")
    return errs


# ------------------------------------------------------------ 3. main
class Capture:
    """Keeps a copy of the largest inputs the main run gives each kernel
    (wraps the package-level wrappers that ``core/accel.py`` calls)."""

    NAMES = ("rank_probe", "lookup_probe", "interval_rank", "run_coalesce")

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
            # work ~ queries x run length (first two operands)
            size = args[0].shape[0] * (args[1].shape[0] + 1)
            if name not in self.best or size > self.best[name][0]:
                self.best[name] = (size, [a.clone() for a in args], kw)
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


# ---------------------------------------------------------- 4. shapes
def _bound(nbytes: float, nops: float):
    tb, to = nbytes / PEAK_BYTES_S * 1e3, nops / PEAK_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def shapes_phase(capture: Capture, launches: dict) -> list:
    """Main-path inputs: exact check + timings.  -> kernel records."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.common import u64_order
    best = capture.best
    for name in Capture.NAMES:
        require(name in best, f"main run never called {name}")
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
               "shape": [list(a.shape) for a in args]}
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
    return recs


# ---------------------------------------------------------- 5. parity
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


def parity_phase() -> None:
    """Kernels on at the default routing threshold and with every probe
    routed (kernel_min_batch=1), each against kernels off on the CPU."""
    for engine in ENGINES:
        t0 = time.perf_counter()
        off = fixed_workload(engine, "cpu", use_kernels=False)
        for kw in ({}, {"kernel_min_batch": 1}):
            on = fixed_workload(engine, "cuda", **kw)
            require(on[0] == off[0], f"{engine} {kw}: stats differ: "
                                     f"{on[0]} vs {off[0]}")
            require(on[1] == off[1], f"{engine} {kw}: multi_get vids differ")
            require(on[2] == off[2], f"{engine} {kw}: scan rows differ")
        log(f"[parity] {engine}: equal ({time.perf_counter() - t0:.1f}s)")


# -------------------------------------------------------- 6. crossover
CROSSOVER_SIZES = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def _per_call_us(fn, iters: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def crossover_phase(store, sizes=CROSSOVER_SIZES, iters=40) -> dict:
    """Wall time per call (us) of each routed op against the host NumPy
    path it replaces, on the store's own columns, per batch size.  A
    routed call returns host arrays, so its time holds the upload, the
    kernel and the download.  -> {op: {"rows": [...], "crossover": the
    smallest size from which the routed call is never slower, or None}}."""
    import numpy as np
    from repro_torch.core import accel
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

    def cases(b):
        ks, vks, lks = draw(tab.keys, b), draw(vtab.keys, b), draw(lkeys, b)
        kraw = hash_family(ks, k)
        # one multi_get's fetches: ~10 keys per vSST, grouped by file
        ranks = np.sort(rng.integers(0, max(1, b // 10), b)).astype(np.int64)
        pos = rng.integers(0, 4 * b, b).astype(np.int64)
        return {  # op: (host path, routed path)
            "lookup_probe": (lambda: lookup_host(ks, kraw),
                             lambda: accel.table_probe(store, tab, ks, kraw)),
            "rank_probe": (lambda: vtab.find(vks),
                           lambda: accel.table_find(store, vtab, vks)),
            "count_le": (lambda: v.assign_files(lvl, lks),
                         lambda: accel.assign_files(store, lvl, lks)),
            "run_coalesce": (lambda: plan_host(ranks, pos),
                             lambda: accel.plan_runs(store, ranks, pos)),
        }

    rows = {name: [] for name in REPLACES}
    try:
        for b in sizes:
            for name, (host, routed) in cases(b).items():
                require(routed() is not None, f"crossover: {name} declined")
                rows[name].append({"batch": b,
                                   "host_us": _per_call_us(host, iters),
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
    """Phase 6 alone, on a 2^18-key store of the port under ``src``."""
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
                    help="run only phase 6, on a 2^18-key store")
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
    for name, n in main["launches"].items():
        require(n > 0, f"kernel {name} was not launched in the main run")
    recs = shapes_phase(cap, main["launches"])
    parity_phase()
    crossover_phase(store)
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": [{k: v for k, v in r.items()
                                   if k != "shape"} for r in recs]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
