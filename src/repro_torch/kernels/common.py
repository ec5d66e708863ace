"""Shared pieces of the CUDA kernels: the library build, the u64 order
helper, the u32 column helpers, host<->device column copies and the device
cache of immutable host columns.

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

u32 columns (the five benchmark kernels' keys, seqs, vids and filter
words, u32 as in the reference) travel as int32 tensors holding the u32
bit patterns (``ndarray.view(np.int32)``): every int32 tensor is a valid
u32 column, so no range check is needed, and the card moves 4 bytes per
value.  The CUDA code reads them as ``uint32_t``; the plain versions widen
them with ``u32_values`` and narrow results back with ``u32_bits``.
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


def _lsr(t: torch.Tensor, s: int) -> torch.Tensor:
    # logical right shift of u64 patterns (torch's >> on int64 is
    # arithmetic: mask off the copies of the sign bit)
    return (t >> s) & ((1 << (64 - s)) - 1)


def _i64(c: int) -> int:
    return c - (1 << 64) if c >= 1 << 63 else c


_GAMMA = _i64(0x9E3779B97F4A7C15)
_MIX1 = _i64(0xBF58476D1CE4E5B9)
_MIX2 = _i64(0x94D049BB133111EB)


def splitmix64(t: torch.Tensor) -> torch.Tensor:
    """``core/engine/keys.py``'s splitmix64 finalizer on int64 tensors of
    u64 patterns: int64 adds and products wrap as u64 ones do."""
    z = t + _GAMMA
    z = (z ^ _lsr(z, 30)) * _MIX1
    z = (z ^ _lsr(z, 27)) * _MIX2
    return z ^ _lsr(z, 31)


def u64_mod(t: torch.Tensor, m: int) -> torch.Tensor:
    """u64 patterns modulo ``m`` (1 <= m < 2^62) as unsigned integers.

    torch has no unsigned modulo: a pattern with the top bit set is
    2^63 + (its low 63 bits), so its remainder is that of the low bits
    plus 2^63 % m, reduced once more."""
    m = int(m)
    if not 1 <= m < 1 << 62:
        raise ValueError(f"u64_mod: modulus {m} outside [1, 2^62)")
    low = (t & ((1 << 63) - 1)) % m
    return torch.where(t < 0, (low + (1 << 63) % m) % m, low)


def u32_values(t: torch.Tensor) -> torch.Tensor:
    """int32 tensor of u32 bit patterns -> int64 tensor of the u32 values."""
    return t.to(torch.int64) & U32_MAX


def u32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 tensor of values in [0, 2^32) -> int32 tensor of their bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def u32_tensor(a, device=None) -> torch.Tensor:
    """A host column of values in [0, 2^32) as an int32 bit-view tensor."""
    a = np.ascontiguousarray(np.asarray(a).astype(np.uint32, copy=False))
    t = torch.from_numpy(a.view(np.int32).copy())
    return t if device is None else t.to(device)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A u64/i64 host column as an int64 tensor on ``device`` (always a
    copy: a tensor sharing the host buffer would keep the array alive)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).to(
        device, copy=True)


def to_device_async(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``to_device`` that, to a card, queues the copy from pinned memory
    and returns without waiting for the card (nor for the work queued
    before it); torch's pinned-memory allocator keeps the staging buffer
    until the copy has run."""
    t = torch.from_numpy(np.ascontiguousarray(a).view(np.int64))
    if device.type != "cuda":
        return t.to(device, copy=True)
    return t.pin_memory().to(device, non_blocking=True)


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


_P, _I64, _F64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
_SIGNATURES = {
    # name: argument types; every function returns its cudaError_t
    "rank_probe": (_P, _I64, _P, _I64, _P, _P, _I64, _I64, _P),
    "rank_probe_segments": (_P, _I64, _P, _I64, _I64, _I64, _I64, _P, _P,
                            _P, _P),
    "lookup_probe": (_P, _I64, _P, _I64, _P, _I64, _P, _P, _P, _P, _I64,
                     _P),
    "lookup_probe_level": (_P, _I64, _P, _I64, _P, _I64, _I64, _I64, _I64,
                           _P, _P, _P, _P),
    "count_le": (_P, _I64, _P, _I64, _P, _I64, _P, _P),
    "run_coalesce": (_P, _P, _I64, _I64, _P, _I64, _P, _P, _P, _P, _P),
    "segment_sum": (_P, _I64, _I64, _P, _P),
    "sketch_add": (_P, _I64, _I64, _I64, _I64, _P, _I64, _P, _I64, _F64, _P,
                   _P),
    "gather_min64": (_P, _I64, _I64, _P, _I64, _P, _P),
    "sketch_estimate": (_P, _I64, _I64, _I64, _I64, _P, _P, _I64, _P, _P),
    "gc_lookup": (_P, _I64, _P, _P, _P, _I64, _P, _P, _P, _I64, _P),
    "bloom_probe": (_P, _I64, _P, _I64, _I64, _I64, _I64, _P, _P),
    "merge_dedup": (_P, _P, _P, _I64, _P, _P, _P, _I64, _P, _P, _P, _P, _I64,
                    _P),
    "hot_cold_partition": (_P, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _I64,
                           _P),
    "page_gather": (_P, _I64, _P, _I64, _I64, _P, _P),
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
    for name in ("scav_smem_sort_cap", "scav_partition_tile",
                 "scav_probe_tile_words", "scav_count_le_smem_files",
                 "scav_merge_threads", "scav_segment_range"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int64
    lib.scav_stream_sync.argtypes = [_P]
    lib.scav_stream_sync.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def smem_sort_cap() -> int:
    """Pairs ``run_coalesce`` sorts in one CTA's shared memory (the
    library's own constant); a longer column needs a scratch buffer."""
    return int(library().scav_smem_sort_cap())


@functools.lru_cache(maxsize=None)
def count_le_smem_files() -> int:
    """The most files whose bounds ``count_le`` stages in shared memory
    (the library's own constant); a larger level, like one of a few files,
    is searched in device memory."""
    return int(library().scav_count_le_smem_files())


@functools.lru_cache(maxsize=None)
def segment_range() -> int:
    """Slots a CTA of ``segment_sum``'s one-launch index form at the
    tracker's size (the library's constant; longer id columns widen it)."""
    return int(library().scav_segment_range())


@functools.lru_cache(maxsize=None)
def partition_tile() -> int:
    """Records per tile of the partition (the library's constant);
    ``hot_cold_partition`` needs one uint32 of scratch per tile."""
    return int(library().scav_partition_tile())


@functools.lru_cache(maxsize=None)
def merge_threads() -> int:
    """Threads a CTA of ``merge_dedup`` (the library's constant); a CTA
    merges a tile of that many rows times the rows a thread merges."""
    return int(library().scav_merge_threads())


@functools.lru_cache(maxsize=None)
def probe_tile_words() -> int:
    """int64 words of one tile of ``lookup_probe``'s level plan (the
    library's own constant; the wrapper lays tiles out to match)."""
    return int(library().scav_probe_tile_words())


@functools.lru_cache(maxsize=4096)
def fast_mod_magic(d: int) -> tuple:
    """The kernels' modulo by a divisor ``d`` (1 <= d < 2^64) fixed per
    call, as a multiply: (m as an int64 bit pattern, l) with l =
    ceil(log2 d) and m = floor(2^(64+l) / d) - 2^64 + 1 (Granlund and
    Montgomery's unsigned division by an invariant integer); cached, as a
    store's filters share a few sizes."""
    d = int(d)
    if not 1 <= d < 1 << 64:
        raise ValueError(f"fast_mod_magic: divisor {d} outside [1, 2^64)")
    ln = (d - 1).bit_length()
    m = (1 << (64 + ln)) // d - (1 << 64) + 1
    return (m - (1 << 64) if m >= 1 << 63 else m), ln


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


def check_u32_columns(name: str, *cols: torch.Tensor) -> torch.device:
    """All operands 1-d contiguous int32 (u32 bit views) on one device.
    -> that device."""
    dev = cols[0].device
    for c in cols:
        if c.dtype != torch.int32 or c.dim() != 1 or not c.is_contiguous() \
                or c.device != dev:
            raise ValueError(f"{name}: operands must be 1-d contiguous int32 "
                             f"(u32 bit view) tensors on one device, got "
                             f"{c.dtype} {tuple(c.shape)} on {c.device}")
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
        return self._get(host_arr, (host_arr,))

    def get_rows(self, first: np.ndarray, *rest: np.ndarray) -> torch.Tensor:
        """(1 + len(rest), n) int64 device tensor of equal-length columns
        of one table (its keys first, then columns that live as long),
        kept as long as ``first``."""
        return self._get(first, (first, *rest))

    def _get(self, first, cols) -> torch.Tensor:
        key = id(first) if len(cols) == 1 else (id(first), len(cols))
        ent = self._cache.get(key)
        if ent is not None and ent[0]() is first:
            return ent[1]
        dev = to_device(cols[0] if len(cols) == 1 else np.stack(
            [np.asarray(c).view(np.int64) for c in cols]), self.device)
        self._cache[key] = (weakref.ref(first), dev)
        weakref.finalize(first, self._cache.pop, key, None)
        return dev
