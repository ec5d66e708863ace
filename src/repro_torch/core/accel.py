"""Kernel dispatch for the batched hot paths (port of ``repro.core.accel``).

The read and value layers stay written against their NumPy host
implementations; this module routes eligible batches through the
``repro_torch.kernels`` ops on the store's device instead.  Every routed op
gives the same integers as its host path, so routing is a pure performance
decision: ``EngineConfig.use_kernels`` turns it on, and ``kernel_min_batch``
keeps tiny probes on the host where launch and copy overhead would dominate.

Every routed call returns ``None`` when it declines (kernels off or batch
too small) — callers fall back to the host path, which produces the same
bytes.  Keys reach the kernels as int64 tensors holding the u64 bit
patterns, and the kernels take the full 64-bit range.  Immutable columns
(sorted key runs, bloom words, level bounds, memtable snapshots) go to the
device once, through the store's ``DeviceCache``; per call, the query
columns go up and the results come back, with one wait for the card.  On
a CUDA device the ops launch the CUDA kernels; on the CPU they run their
plain torch versions.

The adaptive tracker (``core/adaptive/``) routes its sketch and histogram
updates itself, through the same policy, on the device the store passes
down; ``op_timer`` times its observation as one op class.

Wall-clock spent inside routed ops is emitted to the observer as a
``kernel_<op>_us`` histogram per fused op class (real host microseconds,
not simulated time).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import kernels
from ..kernels.common import U32_MAX, to_device, to_host


class KernelPolicy:
    """Resolved per-config routing decision (cached on the config)."""

    __slots__ = ("enabled", "min_batch", "window")

    def __init__(self, enabled: bool, min_batch: int = 0, window=None):
        self.enabled = bool(enabled)
        self.min_batch = int(min_batch)
        self.window = window

    def ready(self, n: int) -> bool:
        return self.enabled and n >= self.min_batch


OFF_POLICY = KernelPolicy(False)


def policy_of(cfg) -> KernelPolicy:
    pol = getattr(cfg, "_kernel_policy", None)
    if pol is None:
        pol = (KernelPolicy(True, cfg.kernel_min_batch, cfg.coalesce_window)
               if cfg.use_kernels else OFF_POLICY)
        cfg._kernel_policy = pol
    return pol


def resolve_device(device) -> torch.device:
    """The store's device: CUDA unless the caller names one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run the store's probes on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _emit(store, opclass: str, t0: float) -> None:
    store.obs.on_op(store, f"kernel_{opclass}_us",
                    (time.perf_counter() - t0) * 1e6)


@contextlib.contextmanager
def op_timer(store, opclass: str):
    """Time a fused-op region (host + kernel work) into the observer's
    ``kernel_<opclass>_us`` histogram; no-op while kernels are off."""
    if not policy_of(store.cfg).enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _emit(store, opclass, t0)


# ------------------------------------------------------------ read path
def memtable_probe(store, mt, keys):
    """Kernel-routed ``Memtable.get_batch``; None -> host path."""
    pol = policy_of(store.cfg)
    if not pol.ready(len(keys)):
        return None
    mk, seqs, ety, vids, vsz, vf = mt.snapshot()
    n = len(mk)
    t0 = time.perf_counter()
    found, rank = to_host(*kernels.rank_probe(to_device(keys, store.device),
                                              store.dev_cache.get(mk)))
    _emit(store, "lookup_probe", t0)
    if n == 0:       # host get_batch's placeholder columns
        return (found,) + tuple(np.zeros(len(keys), c.dtype)
                                for c in (seqs, ety, vids, vsz, vf))
    safe = np.where(rank < n, rank, 0)   # host get_batch's gather guard
    return (found, seqs[safe], ety[safe], vids[safe], vsz[safe], vf[safe])


def table_probe(store, t, keys, kraw):
    """Fused bloom + ``SSTable.find`` for one table; None -> host path.

    ``kraw`` is the hoisted (k, Q) u64 ``hash_family`` column slice; the
    u64 modulo to the table's filter size runs on the host and the
    resulting bit indices feed the fused probe."""
    pol = policy_of(store.cfg)
    if not pol.ready(len(keys)):
        return None
    t0 = time.perf_counter()
    bf = t.bloom
    bit_idx = (kraw % np.uint64(bf.nbits)).T                  # (Q, k)
    may, found, rank = to_host(*kernels.lookup_probe(
        to_device(keys, store.device), store.dev_cache.get(t.keys),
        to_device(bit_idx, store.device), store.dev_cache.get(bf.bits)))
    _emit(store, "lookup_probe", t0)
    return may, np.where(found, rank, -1)


def assign_files(store, lvl: int, keys):
    """Kernel-routed ``Version.assign_files``; None -> host path."""
    pol = policy_of(store.cfg)
    if not pol.ready(len(keys)):
        return None
    mins, maxs = store.version.level_bounds(lvl)
    t0 = time.perf_counter()
    (fidx,) = to_host(kernels.interval_rank(to_device(keys, store.device),
                                            store.dev_cache.get(mins),
                                            store.dev_cache.get(maxs)))
    _emit(store, "lookup_probe", t0)
    return fidx


# ----------------------------------------------------------- value path
def table_find(store, t, keys):
    """Kernel-routed ``SSTable.find``; None -> host path."""
    pol = policy_of(store.cfg)
    if not pol.ready(len(keys)):
        return None
    t0 = time.perf_counter()
    found, rank = to_host(*kernels.rank_probe(to_device(keys, store.device),
                                              store.dev_cache.get(t.keys)))
    _emit(store, "lookup_probe", t0)
    return np.where(found, rank, -1)


def plan_runs(store, ranks, pos):
    """Kernel-routed fetch planning: sort by (file-rank, position), dedup,
    mark adjacency runs (capped at ``coalesce_window`` kept records when
    configured).  None -> host ``np.unique`` + ``np.split`` planning.

    The operands' range, [0, 2^32 - 1), is checked here on the host: the
    kernel does not check it."""
    pol = policy_of(store.cfg)
    if not pol.ready(len(ranks)):
        return None
    t0 = time.perf_counter()
    if len(ranks) and (min(ranks.min(), pos.min()) < 0
                       or max(ranks.max(), pos.max()) >= U32_MAX):
        raise ValueError("plan_runs: file ranks and positions must lie in "
                         "[0, 2^32 - 1)")
    out = to_host(*kernels.run_coalesce(to_device(ranks, store.device),
                                        to_device(pos, store.device),
                                        window=pol.window))
    _emit(store, "run_coalesce", t0)
    return out
