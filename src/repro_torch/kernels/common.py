"""Shared pieces of the CUDA kernels: the library build, the u64 order
helper, host<->device column copies and the device cache of immutable
host columns.

Build: ``csrc/kernels.cu`` holds every kernel behind a plain C interface.
``library()`` compiles it with ``nvcc`` for ``sm_90a`` into ``_build/``
(keyed by a hash of the source and the flags, so an edited source
rebuilds) on first use, loads it with ``ctypes`` and declares each
function's argument types.  A failed build or load raises.  Nothing here
runs at import time: the CPU tests import every module without ``nvcc``.

u64 keys: torch has no usable unsigned 64-bit arithmetic, so key columns
travel as int64 tensors holding the u64 bit patterns
(``ndarray.view(np.int64)``).  The CUDA code compares them as
``uint64_t``; the plain torch versions compare ``u64_order(x)``, which
flips the sign bit so that signed order equals unsigned order.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import weakref
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent / "csrc" / "kernels.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

SIGN_BIT = -(1 << 63)           # int64 with only the top bit set
U32_MAX = (1 << 32) - 1


def u64_order(t: torch.Tensor) -> torch.Tensor:
    """int64 tensor of u64 bit patterns -> int64 values whose signed order
    is the unsigned order of the patterns (sign-bias XOR)."""
    return t ^ SIGN_BIT


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A u64/i64 host column as an int64 tensor on ``device`` (always a
    copy: a tensor sharing the host buffer would keep the array alive)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).to(
        device, copy=True)


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


# ------------------------------------------------------------ the library
def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_library() -> Path:
    """Compile ``csrc/kernels.cu`` into ``_build/`` unless a library built
    from the same source and flags is already there.  -> its path."""
    src = CSRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"libscavenger_kernels_{tag}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC)],
                          capture_output=True, text=True)
    (BUILD_DIR / f"build_{tag}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, so)          # atomic: a concurrent build loads whole
    return so


_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    # name: argument types; every function returns its cudaError_t
    "rank_probe": (_P, _I64, _P, _I64, _P, _P, _P),
    "lookup_probe": (_P, _I64, _P, _I64, _P, _I64, _P, _P, _P, _P, _P),
    "count_le": (_P, _I64, _P, _I64, _P, _I64, _P, _P),
    "run_coalesce": (_P, _P, _I64, _I64, _P, _I64, _P, _P, _P, _P, _P),
    "segment_sum": (_P, _I64, _I64, _P, _P),
    "gather_min64": (_P, _I64, _I64, _P, _I64, _P, _P),
}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build_library()))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    lib.scav_error_string.argtypes = [ctypes.c_int]
    lib.scav_error_string.restype = ctypes.c_char_p
    lib.scav_smem_sort_cap.argtypes = []
    lib.scav_smem_sort_cap.restype = ctypes.c_int64
    lib.scav_stream_sync.argtypes = [_P]
    lib.scav_stream_sync.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def smem_sort_cap() -> int:
    """Pairs ``run_coalesce`` sorts in one CTA's shared memory (the
    library's own constant); a longer column needs a scratch buffer."""
    return int(library().scav_smem_sort_cap())


def launch(name: str, device: torch.device, *args) -> None:
    """Call library function ``name`` (a kernel's launch, or the stream
    wait) on ``device``'s current stream; raise if it was refused."""
    lib = library()
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx == torch.cuda.current_device():
        rc = getattr(lib, name)(*args, _raw_stream(idx))
    else:
        with torch.cuda.device(idx):
            rc = getattr(lib, name)(*args, _raw_stream(idx))
    if rc != 0:
        msg = lib.scav_error_string(rc).decode()
        raise RuntimeError(f"CUDA call {name} failed: {msg} ({rc})")


def _raw_stream(idx: int) -> int:
    # the current stream's cudaStream_t, without building a Stream object
    # (torch.cuda.current_stream costs more than the kernel launch)
    return torch._C._cuda_getCurrentRawStream(idx)


def outputs(n: int, device: torch.device, *dtypes) -> tuple:
    """Uninitialised (n,) output tensors of the given dtypes on device."""
    return tuple(torch.empty(n, dtype=d, device=device) for d in dtypes)


def to_host(*ts: torch.Tensor) -> tuple:
    """Tensors -> NumPy arrays.  From the card, the copies are queued
    together and waited for once (one synchronisation per call)."""
    if ts[0].device.type != "cuda":
        return tuple(t.numpy() for t in ts)
    hs = [t.to("cpu", non_blocking=True) for t in ts]   # pinned targets
    launch("scav_stream_sync", ts[0].device)
    return tuple(h.numpy() for h in hs)


def check_columns(name: str, *cols: torch.Tensor) -> torch.device:
    """All operands int64, contiguous, on one device.  -> that device."""
    dev = cols[0].device
    for c in cols:
        if c.dtype != torch.int64 or not c.is_contiguous() \
                or c.device != dev:
            raise ValueError(f"{name}: operands must be contiguous int64 "
                             f"tensors on one device, got {c.dtype} "
                             f"on {c.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


# ---------------------------------------- device copies of host columns
class DeviceCache:
    """Device copies of immutable host columns, one per host array.

    Keyed by the host array's identity and dropped when that array is
    garbage collected (table eviction, version turnover, a memtable's next
    snapshot).  Callers must treat the host array as immutable: the cache
    would return a stale copy otherwise."""

    def __init__(self, device: torch.device):
        self.device = device
        self._cache: dict = {}

    def get(self, host_arr: np.ndarray) -> torch.Tensor:
        """int64 device tensor of ``host_arr``'s (u64 or i64) values."""
        key = id(host_arr)
        ent = self._cache.get(key)
        if ent is not None and ent[0]() is host_arr:
            return ent[1]
        dev = to_device(host_arr, self.device)
        self._cache[key] = (weakref.ref(host_arr), dev)
        weakref.finalize(host_arr, self._cache.pop, key, None)
        return dev
