"""YCSB core workloads A-F (paper §IV-C), scaled, issued in batches; port
of ``repro.workloads.ycsb``.

  A: 50% read / 50% update        B: 95% read / 5% update
  C: 100% read                    D: 95% read-latest / 5% insert
  E: 95% scan / 5% insert         F: 50% read / 50% read-modify-write

The op stream is cut into segments of ``batch`` ops; within a segment all
reads execute first as one ``multi_get`` (against segment-start state, the
pipelined-client model), then scans as one ``multi_scan``, then all writes
apply atomically as one ``WriteBatch``.  The oracle advances per segment
with the same last-write-wins rule the store applies inside a batch.
"""

from __future__ import annotations

import numpy as np

from ..core.batch import WriteBatch

from .generator import Runner, WorkloadSpec

YCSB_MIX = {
    "A": dict(read=0.5, update=0.5),
    "B": dict(read=0.95, update=0.05),
    "C": dict(read=1.0),
    "D": dict(read_latest=0.95, insert=0.05),
    "E": dict(scan=0.95, insert=0.05),
    "F": dict(read=0.5, rmw=0.5),
}


def run_ycsb(store, spec: WorkloadSpec, workload: str, n_ops: int,
             runner: Runner | None = None, batch: int = 64) -> dict:
    """Run one YCSB workload; assumes the store is already loaded+updated
    (paper: 100GB load + 300GB updates before each YCSB run)."""
    mix = YCSB_MIX[workload.upper()]
    r = runner or Runner(store, spec)
    rng = r.rng
    t0 = store.io.clock_us
    kinds = list(mix.keys())
    probs = np.array([mix[k] for k in kinds])
    choice = rng.choice(len(kinds), size=n_ops, p=probs / probs.sum())
    next_key = spec.n_keys
    recent: list[int] = []
    errors = 0
    for s0 in range(0, n_ops, batch):
        seg = choice[s0:s0 + batch]
        read_keys: list[int] = []
        write_keys: list[int] = []
        write_sizes: list[int] = []
        scan_starts: list[int] = []
        for c in seg.tolist():
            kind = kinds[c]
            if kind in ("read", "rmw"):
                k = int(r.keys.sample(rng, 1)[0])
                read_keys.append(k)
                if kind == "rmw":
                    write_keys.append(k)
                    write_sizes.append(int(spec.value_dist.sample(rng, 1)[0]))
            elif kind == "update":
                k = int(r.keys.sample(rng, 1)[0])
                write_keys.append(k)
                write_sizes.append(int(spec.value_dist.sample(rng, 1)[0]))
            elif kind == "insert":
                write_keys.append(next_key)
                write_sizes.append(int(spec.value_dist.sample(rng, 1)[0]))
                recent.append(next_key)
                next_key += 1
            elif kind == "read_latest":
                pool = recent[-100:] if recent else [0]
                read_keys.append(int(pool[int(rng.integers(0, len(pool)))]))
            elif kind == "scan":
                scan_starts.append(int(rng.integers(0, spec.n_keys)))
        if read_keys:
            res = store.multi_get(np.array(read_keys, np.uint64))
            expect = np.array([r.oracle.get(k, 0) for k in read_keys],
                              np.uint64)
            errors += int((res["vid"] != expect).sum())
        if scan_starts:
            store.multi_scan(np.array(scan_starts, np.int64),
                             rng.integers(1, 101, len(scan_starts)))
        if write_keys:
            vids = store.write(
                WriteBatch().puts(np.array(write_keys, np.uint64),
                                  np.array(write_sizes, np.int64)))
            r.oracle.update(zip(write_keys, vids.tolist()))
    assert errors == 0, f"{errors} YCSB read mismatches"
    sim_s = (store.io.clock_us - t0) / 1e6
    return {"workload": workload, "ops": n_ops, "sim_s": sim_s,
            "kops_per_s": n_ops / sim_s / 1e3 if sim_s else float("inf")}
