"""Workload generators and YCSB mixes (port of ``repro.workloads``): NumPy,
the reference's draws for the same seeds, driving any store through its
public batched calls."""

from .generator import (Fixed, HotspotKeys, Mixed, Pareto, Runner,
                        UniformKeys, WorkloadSpec, ZipfKeys, fixed, mixed_8k,
                        pareto_1k)
from .ycsb import run_ycsb, YCSB_MIX

__all__ = ["Fixed", "HotspotKeys", "Mixed", "Pareto", "Runner",
           "UniformKeys", "WorkloadSpec", "ZipfKeys", "fixed", "mixed_8k",
           "pareto_1k", "run_ycsb", "YCSB_MIX"]
