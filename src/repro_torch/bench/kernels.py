"""Kernel benchmark of the port: the per-kernel rows of the reference's
``benchmarks/kernels_bench.py`` for GC-Lookup, bloom probe, compaction
merge, hot/cold partition and paged gather.

    python -m repro_torch.bench.kernels [--device cuda|cpu]
                                        [--shapes bench|deploy|all]

prints ``name,us_per_call,derived`` CSV rows under the reference's row
names.  ``run(device, shapes)`` returns them as dicts (``{"name",
"us_per_call", "derived"}``, the reference's row contract) and writes no
file.  ``us_per_call`` is the wrapper call's time (CUDA events on the
card, the host clock on the CPU); ``derived`` carries ``ref_us`` (the
plain torch version on the same operands and device), the shape and
``bytes``, the bytes the call must move on its data (each input byte it
needs read once, each output written once; ``gc_lookup`` counts the 32-byte
sectors its searches and hits read, not whole columns), the count a
roofline bound divides by the memory rate.

The default device is CUDA; without a card it raises, it never falls back
to the CPU.  On the CPU the wrappers run their plain versions, so there
``us_per_call`` and ``ref_us`` time the same code.

Shapes: ``bench`` are the reference's own (its inputs, drawn in its order
from seed 0); ``deploy`` the state of the 1 GiB store that ``chip_smoke.py``
drives (2^20 keys, keys below 2^32 - 2 for the kernels' u32 contract):
one GC-Lookup batch of 65,536 keys against the whole index, a 10 bit/key
filter over all keys, a level-into-level compaction of two runs of 2^19
sharing half their keys, a flush or GC output of the whole store through
the partition, and a page pool of 8,192 (16, 128) pages gathered through a
(64, 64) table in bf16 and f32.

The reference's roofline section (routed calls against the host path for
the store's kernels) is ``chip_smoke.py``'s crossover phase and is not
repeated here, nor is its assertion that the routed lookup wins from 1,024
keys: the port records what the card measures.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..kernels.common import u32_tensor

ROW_NAMES = {"gc_lookup": "kernels/gc_lookup",
             "bloom_probe": "kernels/bloom_probe",
             "merge_dedup": "kernels/merge_dedup",
             "hot_cold_partition": "kernels/partition",
             "page_gather": "kernels/page_gather"}
U32_KEY_LIMIT = (1 << 32) - 2    # the reference's u32 table pad


@dataclass(frozen=True)
class Case:
    """One kernel call: its wrapper's name, the host operands (CPU tensors
    and ints) and what the call must move and compute."""
    kernel: str
    shapes: str                  # "bench" or "deploy"
    shape: dict                  # the shape fields of the row
    args: tuple
    nbytes: int                  # each input read once, each output written once
    nops: float                  # compares, hash steps or adds

    @property
    def row_name(self) -> str:
        return ROW_NAMES[self.kernel]


def row(name: str, us: float, **derived) -> dict:
    """A row of the reference's contract (``benchmarks/common.py``)."""
    dstr = " ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in derived.items())
    return {"name": name, "us_per_call": round(us, 3), "derived": dstr}


def operands(case: Case, device) -> tuple:
    """The case's operands on ``device``; the page table stays on the host,
    where ``page_gather`` takes it."""
    host = (0,) if case.kernel == "page_gather" else ()
    return tuple(a.to(device) if isinstance(a, torch.Tensor) and i not in host
                 else a for i, a in enumerate(case.args))


def wrapper(case: Case):
    return getattr(kernels, case.kernel)


def plain(case: Case):
    return getattr(kernels, case.kernel + "_ref")


# ------------------------------------------------------------ the cases
SECTOR = 32                      # bytes of the card's smallest memory access


def _sectors(idx: np.ndarray) -> int:
    """Distinct 32-byte sectors of a u32 column that the entries ``idx``
    lie in."""
    return len(np.unique(idx // (SECTOR // 4)))


def _gc_bytes(queries: np.ndarray, keys: np.ndarray) -> int:
    """What one GC-Lookup call must move on this data: the queries and the
    outputs (found, vid, vfile) once, the key sectors the kernel's
    lower-bound searches read, and the vid and vfile sectors of the hits.
    Each column counts at most its whole size."""
    n = len(keys)
    lo, hi = np.zeros(len(queries), np.int64), np.full(len(queries), n)
    seen = []
    while (act := lo < hi).any():
        mid = (lo + hi) >> 1
        seen.append(mid[act])
        less = keys[np.minimum(mid, n - 1)] < queries
        lo = np.where(act & less, mid + 1, lo)
        hi = np.where(act & ~less, mid, hi)
    inside = lo < n
    seen.append(lo[inside])                 # the hit test reads keys[rank]
    hits = lo[inside][keys[lo[inside]] == queries[inside]]
    whole = -(-4 * n // SECTOR)
    key_sectors = min(whole, _sectors(np.concatenate(seen))) if seen else 0
    hit_sectors = min(whole, _sectors(hits))
    return 4 * len(queries) + 9 * len(queries) + \
        SECTOR * (key_sectors + 2 * hit_sectors)


def _gc_case(shapes, queries, keys, vids, vfiles) -> Case:
    q, n = len(queries), len(keys)
    return Case("gc_lookup", shapes, {"n": n, "q": q},
                tuple(u32_tensor(a) for a in (queries, keys, vids, vfiles)),
                _gc_bytes(queries, keys), q * math.log2(n + 1))


def _bloom_case(shapes, queries, keys) -> Case:
    words, k, nbits = kernels.bloom_build(u32_tensor(keys))
    q, w = len(queries), words.shape[0]
    return Case("bloom_probe", shapes, {"n": len(keys), "q": q, "k": k,
                                        "nbits": nbits},
                (u32_tensor(queries), words, k, nbits),
                4 * q + 4 * w + q, q * k * 12)


def _merge_case(shapes, a, b) -> Case:
    na, nb = len(a[0]), len(b[0])
    n = na + nb
    return Case("merge_dedup", shapes, {"na": na, "nb": nb},
                tuple(u32_tensor(c) for c in (*a, *b)),
                12 * n + 13 * n, n * math.log2(max(na, nb) + 1))


def _partition_case(shapes, keys, hot, vids, vsizes) -> Case:
    n = len(keys)
    return Case("hot_cold_partition", shapes, {"n": n,
                                               "hot": int(hot.sum())},
                (u32_tensor(keys), torch.from_numpy(hot.copy()),
                 u32_tensor(vids), u32_tensor(vsizes)),
                13 * n + 12 * n + 8, n)


def _gather_case(shapes, table, pages) -> Case:
    b, p = table.shape
    n, page_size, d = pages.shape
    page_bytes = page_size * d * pages.element_size()
    distinct = len(np.unique(table))
    return Case("page_gather", shapes,
                {"b": b, "p": p, "pages": n, "page_size": page_size, "d": d,
                 "dtype": str(pages.dtype).removeprefix("torch.")},
                (torch.from_numpy(table.astype(np.int32)), pages),
                4 * b * p + distinct * page_bytes + b * p * page_bytes, 0)


def bench_cases(seed: int = 0) -> list[Case]:
    """The reference's shapes, its inputs drawn in its order."""
    rng = np.random.default_rng(seed)
    n, q = 8192, 1024
    skeys = np.sort(rng.choice(np.arange(10 * n, dtype=np.uint32), n,
                               replace=False))
    queries = rng.choice(skeys, q)
    cases = [_gc_case("bench", queries, skeys, skeys + 1, skeys % 997),
             _bloom_case("bench", queries, skeys)]
    ak = np.sort(rng.choice(np.arange(1 << 20, dtype=np.uint32), 2048,
                            replace=False))
    cases.append(_merge_case("bench", (ak, ak, ak), (ak, ak, ak)))
    hot = rng.random(4096) < 0.3
    cases.append(_partition_case("bench", ak.repeat(2)[:4096], hot,
                                 ak.repeat(2)[:4096],
                                 np.full(4096, 100, np.uint32)))
    pages = torch.from_numpy(rng.standard_normal((256, 16, 128)).astype(
        np.float32))
    table = rng.integers(0, 256, (8, 32)).astype(np.int32)
    cases.append(_gather_case("bench", table, pages))
    return cases


def _unique_u32(rng, n: int) -> np.ndarray:
    """n distinct values in [0, 2^32 - 2), in random order."""
    got = np.unique(rng.integers(0, U32_KEY_LIMIT, n + n // 8 + 16,
                                 dtype=np.uint64))
    if len(got) < n:
        raise RuntimeError(f"drew {len(got)} distinct keys, wanted {n}")
    return rng.permutation(got)[:n].astype(np.uint32)


def deploy_cases(seed: int = 1, n_keys: int = 1 << 20,
                 n_queries: int = 1 << 16) -> list[Case]:
    """The 1 GiB store's state (see the module docstring)."""
    rng = np.random.default_rng(seed)
    keys = np.sort(_unique_u32(rng, n_keys))
    vids = rng.integers(1, 1 << 32, n_keys, dtype=np.uint64).astype(np.uint32)
    vfiles = rng.integers(1, 1 << 20, n_keys).astype(np.uint32)
    half = n_queries // 2
    queries = np.concatenate([
        keys[rng.integers(0, n_keys, half)],
        rng.integers(0, U32_KEY_LIMIT, n_queries - half,
                     dtype=np.uint64).astype(np.uint32)])
    queries = rng.permutation(queries)
    cases = [_gc_case("deploy", queries, keys, vids, vfiles),
             _bloom_case("deploy", queries, keys)]
    # two runs of n_keys / 2 sharing half their keys; B is the newer run
    quarter = n_keys // 4
    pool = _unique_u32(rng, 3 * quarter)
    runs = []
    for own, seq_base in ((pool[quarter:2 * quarter], 0),
                          (pool[2 * quarter:], 1 << 31)):
        k = np.sort(np.concatenate([pool[:quarter], own]))
        seq = (seq_base + rng.integers(0, 1 << 31, len(k))).astype(np.uint32)
        vid = rng.integers(1, 1 << 32, len(k), dtype=np.uint64)
        runs.append((k, seq, vid.astype(np.uint32)))
    cases.append(_merge_case("deploy", *runs))
    cases.append(_partition_case(
        "deploy", _unique_u32(rng, n_keys), rng.random(n_keys) < 0.3,
        rng.integers(1, 1 << 32, n_keys, dtype=np.uint64).astype(np.uint32),
        np.full(n_keys, 1024, np.uint32)))
    pool_f32 = torch.from_numpy(rng.standard_normal(
        (8192, 16, 128), dtype=np.float32))
    table = rng.integers(0, 8192, (64, 64)).astype(np.int32)
    for dtype in (torch.bfloat16, torch.float32):
        cases.append(_gather_case("deploy", table, pool_f32.to(dtype)))
    return cases


def cases(shapes: str = "all") -> list[Case]:
    if shapes not in ("bench", "deploy", "all"):
        raise ValueError(f"shapes must be bench, deploy or all, got {shapes}")
    return (bench_cases() if shapes != "deploy" else []) + \
        (deploy_cases() if shapes != "bench" else [])


# ---------------------------------------------------------------- timing
def time_us(fn, device: torch.device, iters: int, warmup: int = 2) -> float:
    """Mean microseconds per call of ``fn``: CUDA events around ``iters``
    back-to-back calls on the card (host and device work together),
    the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) * 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e6 / iters


def run(device="cuda", shapes: str = "all") -> list[dict]:
    """Time each case's wrapper and plain version on ``device``.
    -> rows under the reference's names."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.bench.kernels: no CUDA device (pass "
                           "--device cpu to time the plain versions)")
    iters = 50 if device.type == "cuda" else 3
    rows = []
    for case in cases(shapes):
        args = operands(case, device)
        kern, ref = wrapper(case), plain(case)
        us = time_us(lambda: kern(*args), device, iters)
        ref_us = time_us(lambda: ref(*args), device, iters)
        rows.append(row(case.row_name, us, ref_us=ref_us, shapes=case.shapes,
                        **case.shape, bytes=case.nbytes))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--shapes", choices=("bench", "deploy", "all"),
                    default="all")
    args = ap.parse_args(argv)
    rows = run(args.device, args.shapes)
    name = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(f"# device={name}")
    print("name,us_per_call,derived")
    for r in rows:
        print(f"{r['name']},{r['us_per_call']},{r['derived']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
