"""Wrappers of the lookup-probe kernels (``csrc/kernels.cu``).

Each wrapper checks its operands, then runs the plain torch version
(``ref.py``) for CPU tensors, or launches its CUDA kernel for CUDA tensors
and adds one to its ``launches`` count.  A CUDA operand never reaches the
plain version: the kernel runs or the wrapper raises.  Outputs are
allocated here; the kernels allocate nothing.

Operands are int64 tensors holding u64 bit patterns (keys, filter words,
bit indices); sorted runs are ascending in u64 order and may be empty.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import (check_columns, fast_mod_magic, launch, next_pow2,
                      outputs, probe_tile_words, to_device)
from .ref import (count_le_ref, interval_rank_ref, lookup_probe_ref,
                  lookup_probe_segments_ref, rank_probe_ref,
                  rank_probe_segments_ref)

# The probe's shape on the card: queries a CTA of the level form probes,
# one thread each, and the stride of the fence keys a CTA of either
# lookup_probe form stages in shared memory (a power of two; the kernel
# widens it for a run of more than 2,048 fences).  rank_probe's run form
# takes RUN_TILE queries a CTA and stages every RUN_FENCE_STRIDE-th key
# (widened alike) from RUN_STAGE_MIN keys, searching a shorter run in
# device memory; its segmented form stages every SEGMENT_FENCE_STRIDE-th
# key and takes a tile of the smallest power of two, from
# SEGMENT_MIN_TILE to TILE, that holds its largest segment (threads past
# a segment's queries still stage its fences).  All are measured choices
# (PERF.md §6).
TILE = 512
FENCE_STRIDE = 32
_SHIFT = FENCE_STRIDE.bit_length() - 1
RUN_STAGE_MIN = 64
RUN_TILE = 256
RUN_FENCE_STRIDE = 4
SEGMENT_FENCE_STRIDE = 8
SEGMENT_MIN_TILE = 32


def _shift(stride: int) -> int:
    """log2 of a fence stride, -1 for none (the search in device memory)."""
    if stride < 0 or stride & (stride - 1):
        raise ValueError(f"fence stride {stride} is not 0 or a power of two")
    return stride.bit_length() - 1


def rank_probe(queries: torch.Tensor, run: torch.Tensor, *,
               _stride: int | None = None, _tile: int = RUN_TILE):
    """Membership and searchsorted-left rank of each query in a sorted
    unique run.  -> (found (Q,) bool, rank (Q,) int64).  ``_stride`` sets
    the fence stride the kernel stages (0: none) in place of its choice
    by ``RUN_STAGE_MIN``, and ``_tile`` the threads a CTA, for the tests
    and the timing of the choices."""
    dev = check_columns("rank_probe", queries, run)
    if dev.type == "cpu":
        return rank_probe_ref(queries, run)
    q, n = queries.shape[0], run.shape[0]
    if _stride is None:
        _stride = RUN_FENCE_STRIDE if n >= RUN_STAGE_MIN else 0
    shift = _shift(_stride)
    if not 32 <= _tile <= 1024 or _tile % 32:
        raise ValueError(f"rank_probe: tile {_tile} not a multiple of 32 "
                         f"in [32, 1024]")
    found, rank = outputs(q, dev, torch.bool, torch.int64)
    if q:
        launch("rank_probe", dev, queries.data_ptr(), q, run.data_ptr(), n,
               found.data_ptr(), rank.data_ptr(), shift, _tile)
        rank_probe.launches += 1
    return found, rank


rank_probe.launches = 0


def _check_segments(name: str, nrows: int, seg_start, seg_count,
                    nseg: int) -> tuple:
    """Host int64 segment columns, one entry a segment, each segment
    inside [0, nrows).  -> (seg_start, seg_count)."""
    seg_start = np.asarray(seg_start, np.int64)
    seg_count = np.asarray(seg_count, np.int64)
    if not len(seg_start) == len(seg_count) == nseg:
        raise ValueError(f"{name}: want one start and count a segment")
    if nseg and (seg_start.min() < 0 or seg_count.min() < 0
                 or (seg_start + seg_count).max() > nrows):
        raise ValueError(f"{name}: a segment outside rows")
    return seg_start, seg_count


def _plan_tiles(files: np.ndarray, seg_start, seg_count, tile: int):
    """The tiles of a segmented probe, a row a CTA: its segment's file
    descriptor (``files[s]``: run, n, words, nbits and nbits' modulo
    magic and its log2) and its (first row, first slot, count)."""
    per = (seg_count + tile - 1) // tile
    seg = np.repeat(np.arange(len(files)), per)
    j = (np.arange(len(seg)) - np.repeat(np.cumsum(per) - per, per)) * tile
    out0 = np.cumsum(seg_count) - seg_count
    tiles = np.concatenate([files[seg], np.stack(
        [seg_start[seg] + j, out0[seg] + j,
         np.minimum(tile, seg_count[seg] - j)], axis=1)], axis=1)
    if tiles.shape[1] != probe_tile_words():
        raise RuntimeError("the plan's tile layout differs from the "
                           "library's")
    return tiles


def rank_probe_segments(keys: torch.Tensor, seg_start, seg_count, runs, *,
                        values: bool = False, _tile: int | None = None,
                        _stride: int = SEGMENT_FENCE_STRIDE):
    """``rank_probe`` of many query segments in one launch, each against
    its own sorted unique run (every vSST a multi_get or scan reads).

    ``keys`` (N,) is the call's key column on the device, grouped by
    segment on the host; ``seg_start`` and ``seg_count`` are host int64
    arrays: segment s probes ``keys[seg_start[s]:seg_start[s] +
    seg_count[s]]`` against ``runs[s]``, an (n,) run or, with ``values``,
    a (2, n) tensor holding the run and then a value a run key.
    -> (found, rank), each (sum(seg_count),), segment after segment; with
    ``values`` also ``val``, the value at each key found and 0 elsewhere.
    Launches count on ``rank_probe`` and on this wrapper's own
    ``launches``.  ``_tile`` and ``_stride`` set the kernel's shape
    (threads a CTA; the fence stride, a power of two), for the tests and
    the timing of the choices."""
    dev = check_columns("rank_probe_segments", keys, *runs)
    s = len(runs)
    if values:
        bad = any(r.dim() != 2 or r.shape[0] != 2 for r in runs)
    else:
        bad = any(r.dim() != 1 for r in runs)
    if bad:
        raise ValueError("rank_probe_segments: want (n,) runs, or with "
                         "values (2, n): a key row, then a value row")
    seg_start, seg_count = _check_segments(
        "rank_probe_segments", keys.shape[0], seg_start, seg_count, s)
    if dev.type == "cpu":
        return rank_probe_segments_ref(keys, seg_start, seg_count, runs,
                                       values=values)
    q = int(seg_count.sum())
    if _tile is None:
        _tile = min(TILE, max(SEGMENT_MIN_TILE,
                              next_pow2(seg_count.max(initial=1))))
    if not 1 <= _tile <= 1024:
        raise ValueError(f"rank_probe_segments: tile {_tile} outside "
                         f"[1, 1024]")
    if _stride < 1:
        raise ValueError("rank_probe_segments: the segmented form always "
                         "stages fences (a stride of 1 or more)")
    shift = _shift(_stride)
    found, rank = outputs(q, dev, torch.bool, torch.int64)
    val = outputs(q, dev, torch.int64)[0] if values else None
    if q:
        files = np.zeros((s, 6), np.int64)
        files[:, 0] = [r.data_ptr() for r in runs]
        files[:, 1] = [r.shape[-1] for r in runs]
        if values:              # the value row follows the key row
            files[:, 2] = files[:, 0] + 8 * files[:, 1]
        tiles = to_device(_plan_tiles(files, seg_start, seg_count, _tile),
                          dev)
        launch("rank_probe_segments", dev, keys.data_ptr(), keys.shape[0],
               tiles.data_ptr(), tiles.shape[0], int(files[:, 1].max()),
               _tile, shift,
               found.data_ptr(), rank.data_ptr(),
               None if val is None else val.data_ptr())
        rank_probe.launches += 1
        rank_probe_segments.launches += 1
    return (found, rank) if val is None else (found, rank, val)


rank_probe_segments.launches = 0


def lookup_probe(queries: torch.Tensor, run: torch.Tensor,
                 bit_idx: torch.Tensor, words: torch.Tensor):
    """Fused bloom test (AND of the k bits ``bit_idx`` (Q, k) names in the
    filter's u64 ``words``) plus membership/rank in the sorted run.
    -> (may (Q,) bool, found (Q,) bool, rank (Q,) int64)."""
    dev = check_columns("lookup_probe", queries, run, bit_idx, words)
    q = queries.shape[0]
    if bit_idx.dim() != 2 or bit_idx.shape[0] != q:
        raise ValueError(f"lookup_probe: bit_idx must be ({q}, k), got "
                         f"{tuple(bit_idx.shape)}")
    if dev.type == "cpu":
        return lookup_probe_ref(queries, run, bit_idx, words)
    k = bit_idx.shape[1]
    may, found, rank = outputs(q, dev, torch.bool, torch.bool, torch.int64)
    if q:
        launch("lookup_probe", dev, queries.data_ptr(), q, run.data_ptr(),
               run.shape[0], bit_idx.data_ptr(), k, words.data_ptr(),
               may.data_ptr(), found.data_ptr(), rank.data_ptr(), _SHIFT)
        lookup_probe.launches += 1
    return may, found, rank


lookup_probe.launches = 0


def lookup_probe_segments(keys: torch.Tensor, kraw: torch.Tensor, rows,
                          seg_start, seg_count, runs, words, nbits, *,
                          _tile: int = TILE, _stride: int = FENCE_STRIDE):
    """``lookup_probe`` of many query segments in one launch, each against
    its own sorted run and filter (every L0 table, or every file of one
    level, of a batched lookup).

    ``keys`` (N,) and ``kraw`` (k, N) are the lookup's key column and raw
    ``hash_family`` column (u64 patterns before the modulo) on the device;
    ``rows``, ``seg_start`` and ``seg_count`` are host int64 arrays:
    segment s probes the keys ``rows[seg_start[s]:seg_start[s] +
    seg_count[s]]`` against the sorted run ``runs[s]`` and the filter of
    ``nbits[s]`` bits in the u64 words ``words[s]``, its bit indices
    ``kraw[:, row] % nbits[s]`` computed on the card.  Segments may share
    rows.  -> (may, found, rank), each (sum(seg_count),), segment after
    segment.  Launches count on ``lookup_probe``.  ``_tile`` and
    ``_stride`` set the kernel's shape in place of ``TILE`` and
    ``FENCE_STRIDE``, for the tests and the timing of the choices."""
    dev = check_columns("lookup_probe_segments", keys, kraw, *runs, *words)
    rows = np.asarray(rows, np.int64)
    s = len(runs)
    if kraw.dim() != 2 or kraw.shape[0] < 1 \
            or kraw.shape[1] != keys.shape[0] \
            or not len(words) == len(nbits) == s:
        raise ValueError("lookup_probe_segments: want kraw (k >= 1, N), and "
                         "one run, filter, start and count a segment")
    if len(rows) and not 0 <= rows.min() <= rows.max() < keys.shape[0]:
        raise ValueError("lookup_probe_segments: rows outside [0, N)")
    seg_start, seg_count = _check_segments(
        "lookup_probe_segments", len(rows), seg_start, seg_count, s)
    for w, nb in zip(words, nbits):
        if not 0 < nb <= 64 * w.shape[0]:
            raise ValueError(f"lookup_probe_segments: {nb} filter bits in "
                             f"{w.shape[0]} words")
    if dev.type == "cpu":
        return lookup_probe_segments_ref(keys, kraw, rows, seg_start,
                                         seg_count, runs, words, nbits)
    if not 1 <= _tile <= 1024 or _stride < 1 or _stride & (_stride - 1):
        raise ValueError(f"lookup_probe_segments: tile {_tile} outside "
                         f"[1, 1024] or stride {_stride} not a power of two")
    q = int(seg_count.sum())
    may, found, rank = outputs(q, dev, torch.bool, torch.bool, torch.int64)
    if q:
        # the plan, one upload: the rows, then a row a tile holding its
        # file's (run, n, words, nbits, nbits' modulo magic, its log2) and
        # its (first row, first slot, count)
        files = np.array([(r.data_ptr(), r.shape[0], w.data_ptr(), nb,
                           *fast_mod_magic(nb))
                          for r, w, nb in zip(runs, words, nbits)],
                         np.int64).reshape(s, 6)
        tiles = _plan_tiles(files, seg_start, seg_count, _tile)
        plan = to_device(np.concatenate([rows, tiles.ravel()]), dev)
        launch("lookup_probe_level", dev, keys.data_ptr(), keys.shape[0],
               kraw.data_ptr(), kraw.shape[0], plan.data_ptr(), len(rows),
               len(tiles), _tile, _stride.bit_length() - 1, may.data_ptr(),
               found.data_ptr(), rank.data_ptr())
        lookup_probe.launches += 1
    return may, found, rank


def count_le(queries: torch.Tensor, mins: torch.Tensor) -> torch.Tensor:
    """#{mins <= query} per query over a sorted column (searchsorted
    side='right').  -> (Q,) int64."""
    dev = check_columns("count_le", queries, mins)
    if dev.type == "cpu":
        return count_le_ref(queries, mins)
    return _count_le_launch(dev, queries, mins, None)


count_le.launches = 0


def _count_le_launch(dev, queries, mins, maxs) -> torch.Tensor:
    q = queries.shape[0]
    (cnt,) = outputs(q, dev, torch.int64)
    if q:
        launch("count_le", dev, queries.data_ptr(), q, mins.data_ptr(),
               mins.shape[0], None if maxs is None else maxs.data_ptr(),
               int(maxs is not None), cnt.data_ptr())
        count_le.launches += 1
    return cnt


def interval_rank(queries: torch.Tensor, mins: torch.Tensor,
                  maxs: torch.Tensor) -> torch.Tensor:
    """Index of the covering [min, max] interval per query, -1 if none.

    ``mins`` ascending, intervals disjoint (an LSM level's file bounds):
    ``count_le - 1``, checked against the interval's max.  On the card the
    check runs inside the ``count_le`` kernel (one launch).  -> (Q,) int64."""
    dev = check_columns("interval_rank", queries, mins, maxs)
    if mins.shape[0] != maxs.shape[0]:
        raise ValueError("interval_rank: mins and maxs differ in length")
    if dev.type == "cpu":
        return interval_rank_ref(queries, mins, maxs)
    return _count_le_launch(dev, queries, mins, maxs)
