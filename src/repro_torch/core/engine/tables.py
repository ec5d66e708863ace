"""SSTable layouts: BTable (BlockBasedTable), RTable, DTable.

Entries are parallel numpy arrays (vectorized engine; see DESIGN.md §3 for
why fixed-width u64 keys).  A table never stores value *bytes* — it stores
``vids`` (value identities, the store writes the same vid into both the index
entry and the value record, standing in for Titan's <file,offset> locator)
and ``vsizes`` so all space/I-O is byte-accounted exactly.

Layouts (paper §III-B):
  * BTable  — data blocks + sparse index (one entry per block) + bloom.
  * RTable  — value table with a *dense* per-record <key, offset> index,
              partitioned into index blocks; GC reads only index blocks
              ("lazy read"), foreground reads skip in-block search.
  * DTable  — key table splitting KF entries (<key, file_number>, etype REF)
              and inline KV records into separate block streams with separate
              sparse indexes; GC-Lookup touches only (dense-packed) KF blocks.
"""

from __future__ import annotations

import numpy as np

from .config import EngineConfig
from .keys import BloomFilter

ETYPE_INLINE = 0
ETYPE_REF = 1
ETYPE_TOMB = 2
ETYPE_NONE = 255        # result-column sentinel: key not found

# vSST temperature classes (adaptive segregation, DESIGN.md §8; the
# adaptive layer's TemperatureMap re-exports these)
TEMP_COLD = 0
TEMP_WARM = 1
TEMP_HOT = 2

KIND_KEY = "k"
KIND_VALUE = "v"


def _block_layout(rec_bytes: np.ndarray, block_size: int):
    """Assign records to blocks by cumulative serialized size.

    Returns (block_of[i], n_blocks, block_nbytes[b]).
    """
    if len(rec_bytes) == 0:
        return np.zeros(0, np.int32), 0, np.zeros(0, np.int64)
    offs = np.cumsum(rec_bytes, dtype=np.int64) - rec_bytes
    block_of = (offs // block_size).astype(np.int32)
    n_blocks = int(block_of[-1]) + 1
    block_nbytes = np.bincount(block_of, weights=rec_bytes,
                               minlength=n_blocks).astype(np.int64)
    return block_of, n_blocks, block_nbytes


class SSTable:
    _next_fid = 1

    @classmethod
    def alloc_fid(cls) -> int:
        fid = cls._next_fid
        cls._next_fid += 1
        return fid

    def __init__(self, cfg: EngineConfig, kind: str, layout: str,
                 keys: np.ndarray, seqs: np.ndarray, etype: np.ndarray,
                 vids: np.ndarray, vsizes: np.ndarray, vfiles: np.ndarray,
                 is_hot: bool = False, temperature: int | None = None):
        assert kind in (KIND_KEY, KIND_VALUE)
        n = len(keys)
        self.fid = self.alloc_fid()
        self.cfg = cfg
        self.kind = kind
        self.layout = layout
        self.is_hot = is_hot
        # temperature class (adaptive engines: TEMP_COLD/WARM/HOT); the
        # binary is_hot flag maps to the extremes when not given explicitly
        self.temperature = (TEMP_HOT if is_hot else TEMP_COLD) \
            if temperature is None else int(temperature)
        self.keys = np.asarray(keys, np.uint64)
        self.seqs = np.asarray(seqs, np.uint64)
        self.etype = np.asarray(etype, np.uint8)
        self.vids = np.asarray(vids, np.uint64)
        self.vsizes = np.asarray(vsizes, np.int64)
        self.vfiles = np.asarray(vfiles, np.int64)
        assert np.all(self.keys[1:] > self.keys[:-1]), "keys must be unique+sorted"

        # ---- serialized record sizes ----
        if kind == KIND_VALUE:
            rec = cfg.value_rec_bytes(self.vsizes)
        else:
            rec = np.where(
                self.etype == ETYPE_REF, cfg.ref_rec_bytes(),
                np.where(self.etype == ETYPE_TOMB, cfg.tomb_rec_bytes(),
                         cfg.inline_rec_bytes(self.vsizes)))
        self.rec_bytes = rec.astype(np.int64)

        idx_entry = cfg.key_bytes + cfg.index_entry_extra

        if layout == "dtable":
            # two streams: KF (etype==REF) and KV (everything else)
            self.kf_mask = self.etype == ETYPE_REF
            kv_mask = ~self.kf_mask
            self.stream_of = np.where(self.kf_mask, 0, 1).astype(np.int8)
            self.block_of = np.full(n, -1, np.int32)
            kf_bo, self.n_kf_blocks, kf_bb = _block_layout(
                rec[self.kf_mask], cfg.block_size)
            kv_bo, self.n_kv_blocks, kv_bb = _block_layout(
                rec[kv_mask], cfg.block_size)
            self.block_of[self.kf_mask] = kf_bo
            self.block_of[kv_mask] = kv_bo
            self.block_nbytes = {0: kf_bb, 1: kv_bb}
            self.n_data_blocks = self.n_kf_blocks + self.n_kv_blocks
            index_bytes = (self.n_kf_blocks + self.n_kv_blocks) * idx_entry
            # per-stream first-key arrays for block lookup
            self._kf_keys = self.keys[self.kf_mask]
            self._kv_keys = self.keys[kv_mask]
        else:
            self.stream_of = np.zeros(n, np.int8)
            self.block_of, self.n_data_blocks, bb = _block_layout(
                rec, cfg.block_size)
            self.block_nbytes = {0: bb}
            if layout == "rtable":
                # dense <key, offset> index partitioned into blocks
                index_bytes = n * idx_entry
            else:
                index_bytes = self.n_data_blocks * idx_entry

        # partitioned index blocks (RTable dense index, read by lazy GC)
        if layout == "rtable":
            per_blk = max(1, cfg.block_size // idx_entry)
            self.index_block_of = (np.arange(n) // per_blk).astype(np.int32)
            self.n_index_blocks = int(np.ceil(n / per_blk)) if n else 0
        else:
            self.index_block_of = None
            self.n_index_blocks = 1 if n else 0

        self.bloom = BloomFilter(self.keys, cfg.filter_bits_per_key)
        self.data_bytes = int(self.rec_bytes.sum())
        self.index_bytes = int(index_bytes)
        self.filter_bytes = self.bloom.nbytes
        self.file_bytes = (self.data_bytes + self.index_bytes
                           + self.filter_bytes + cfg.footer_bytes
                           + self.n_data_blocks * cfg.block_overhead)

        # ---- value-store bookkeeping (vSST / blob file) ----
        if kind == KIND_VALUE:
            self.total_value_bytes = int(self.rec_bytes.sum())
            self.garbage_bytes = 0
            self.live_refs = n          # blobdb-style refcount
        self.merged_into: int | None = None

        # compensated size: filled by the store for kSSTs (paper §III-C)
        self.compensated_extra = 0

    # ------------------------------------------------------------------ api
    @property
    def n(self) -> int:
        return len(self.keys)

    @property
    def min_key(self) -> int:
        return int(self.keys[0]) if self.n else 0

    @property
    def max_key(self) -> int:
        return int(self.keys[-1]) if self.n else 0

    @property
    def compensated_bytes(self) -> int:
        return self.file_bytes + self.compensated_extra

    def garbage_ratio(self) -> float:
        assert self.kind == KIND_VALUE
        if self.total_value_bytes == 0:
            return 1.0
        return self.garbage_bytes / self.total_value_bytes

    def find(self, keys: np.ndarray) -> np.ndarray:
        """Positions of keys in this table; -1 where absent. Vectorized."""
        ks = np.atleast_1d(np.asarray(keys, np.uint64))
        pos = np.searchsorted(self.keys, ks)
        ok = (pos < self.n)
        safe = np.where(ok, pos, 0)
        ok &= self.keys[safe] == ks
        return np.where(ok, pos, -1).astype(np.int64)

    def data_block_bytes(self, stream: int, block_id: int) -> int:
        bb = self.block_nbytes[stream]
        return int(bb[block_id]) + self.cfg.block_overhead

    def index_block_bytes(self) -> int:
        if self.layout == "rtable" and self.n_index_blocks:
            return min(self.cfg.block_size,
                       max(1, self.index_bytes // max(1, self.n_index_blocks)))
        return max(1, self.index_bytes)

    # Range helpers -------------------------------------------------------
    def positions_in_range(self, lo: int, hi: int) -> np.ndarray:
        a = int(np.searchsorted(self.keys, np.uint64(lo), side="left"))
        b = int(np.searchsorted(self.keys, np.uint64(hi), side="right"))
        return np.arange(a, b, dtype=np.int64)


def build_ksst(cfg: EngineConfig, keys, seqs, etype, vids, vsizes, vfiles):
    return SSTable(cfg, KIND_KEY, cfg.ksst_layout, keys, seqs, etype, vids,
                   vsizes, vfiles)


def build_vsst(cfg: EngineConfig, keys, seqs, vids, vsizes,
               is_hot: bool = False, temperature: int | None = None):
    n = len(keys)
    return SSTable(cfg, KIND_VALUE, cfg.vsst_layout, keys, seqs,
                   np.zeros(n, np.uint8), vids, vsizes,
                   np.zeros(n, np.int64), is_hot=is_hot,
                   temperature=temperature)
