"""Engine configuration (port of ``repro.core.engine.config``, DESIGN.md §3).

Defaults follow the paper's setup (§IV-A, RocksDB tuning guide): 24B keys,
512B separation threshold, 64MB memtable/kSST, 256MB vSST, 10 bits/key bloom
filters, block cache = 1% of dataset, garbage-ratio threshold 0.2, inter-level
ratio 10, dynamic level sizing.  ``scaled()`` shrinks all absolute sizes while
holding every structural ratio, so laptop-scale runs reproduce the paper's
amplification behaviour.

Feature flags map to the paper's ablation variants (Fig. 16/17):
  - TDB      : engine="terarkdb"
  - TDB-C    : engine="terarkdb", compensated_compaction=True
  - Scavenger: engine="scavenger" (compensated + R lazy-read + L dtable +
               W hot/cold; each independently toggleable)
"""

from __future__ import annotations

import dataclasses

# The engines this package runs (the five paper engines + hybrid +
# scavenger_adaptive), in the port registry's order
# (``repro_torch.core.engines``), the reference's order too.
ENGINES = ("rocksdb", "blobdb", "titan", "terarkdb", "scavenger", "hybrid",
           "scavenger_adaptive")


@dataclasses.dataclass
class EngineConfig:
    engine: str = "scavenger"

    # ---- record format (bytes) ----
    key_bytes: int = 24
    seq_bytes: int = 8
    rec_header_bytes: int = 8
    ref_bytes: int = 16            # <file_number, size/offset> locator
    block_size: int = 4096
    block_overhead: int = 32
    index_entry_extra: int = 8     # offset field in index entries
    footer_bytes: int = 48
    filter_bits_per_key: int = 10
    wal_rec_overhead: int = 12     # per-record WAL framing (seq + header)

    # ---- structure sizes ----
    memtable_bytes: int = 64 << 20
    ksst_bytes: int = 64 << 20
    vsst_bytes: int = 256 << 20
    base_level_bytes: int = 256 << 20   # max_bytes_for_level_base
    level_ratio: int = 10
    max_levels: int = 7
    l0_trigger: int = 4
    l0_slowdown: int = 12
    l0_stop: int = 20

    # ---- cache ----
    cache_bytes: int = 1 << 30
    cache_high_frac: float = 0.5
    dropcache_keys: int = 4096

    # ---- write pressure ----
    max_immutables: int = 2         # immutable memtables before write stall
    delayed_write_rate: float = 16.0   # MB/s, RocksDB default under slowdown

    # ---- KV separation & GC ----
    sep_threshold: int = 512
    hybrid_large_threshold: int = 8 << 10   # hybrid engine: always-separate
    gc_scheme: str | None = None    # None -> engine default (validated)
    gc_garbage_ratio: float = 0.2
    gc_aggressive_ratio: float = 0.05
    gc_batch_files: int = 4         # max candidate vSSTs merged per GC run
    gc_batch_cap: int = 32          # hard cap on files per GC batch
    blobdb_age_cutoff: float = 0.25

    # ---- compaction job sizing ----
    compaction_pick_cap: int = 64   # max input files picked per compaction

    # ---- space management ----
    space_quota_bytes: int | None = None
    soft_quota_frac: float = 0.9
    slowdown_us_per_write: float = 20.0
    quota_stall_rounds: int = 256   # forced-GC rounds per stalled write call

    # ---- scan retry ----
    scan_retry_rounds: int = 32     # max refill rounds per scan call
    scan_retry_growth: int = 4      # per-source limit multiplier per round

    # ---- I/O behaviour ----
    readahead_gc: bool = False      # paper disables GC readahead by default
    readahead_compaction: bool = True

    # ---- Scavenger feature flags (paper ablations) ----
    compensated_compaction: bool | None = None   # None -> per-engine default
    lazy_read: bool | None = None                # R: RTable dense-index read
    index_decoupled: bool | None = None          # L: DTable KF/KV split
    hotcold_write: bool | None = None            # W: DropCache routing

    # ---- adaptive workload tracking (core/adaptive/, DESIGN.md §8) ----
    adaptive_enabled: bool | None = None    # None -> per-engine default
    adaptive_groups: int = 1024             # lifetime/temperature key-groups
    adaptive_sketch_width: int = 4096       # decayed-frequency sketch width
    adaptive_sketch_depth: int = 2          # count-min rows
    adaptive_half_life_ops: float = 50_000.0   # decay half-life, user ops
    adaptive_gc_horizon_ops: float = 25_000.0  # dead-byte prediction window
    adaptive_defer_weight: float = 0.7      # GC deferral strength, [0, 1]
    adaptive_score_refresh_ops: int = 2048  # candidate-score cache window
    temp_hot_mult: float = 4.0              # hot: rate >= mult * mean rate
    temp_cold_mult: float = 0.5             # cold: rate <= mult * mean rate
    adaptive_residual_floor: float = 0.1    # min residual lifetime, frac of mean

    # ---- kernel acceleration (repro_torch.kernels via core/accel.py) ----
    # Byte-identical routing of the batched hot paths through the device
    # kernels; ``coalesce_window`` also bounds host-planned fetch runs
    # (None -> adjacency only), so it is a semantic knob, not a kernel one.
    use_kernels: bool = True
    # accepted so a reference ``state_dict()`` loads; the port has one
    # execution path per device and ignores it
    kernel_interpret: bool | None = None
    kernel_min_batch: int = 128             # below this, stay on the host
    coalesce_window: int | None = None      # max records per coalesced run

    # ---- elastic fleet: live split/merge + replication (§14) ----
    # All off by default: a fleet with elasticity off is byte-identical to
    # the static ShardedStore (golden-locked in tests/test_sharding.py).
    elastic_split_frac: float | None = None  # split when a shard's space or
    #                                          traffic share exceeds this
    elastic_merge_frac: float = 0.0          # merge a shard whose share
    #                                          fell below this (0 = never)
    elastic_max_shards: int = 8              # split ceiling
    elastic_cooldown_ops: int = 1024         # fleet user ops between
    #                                          trigger evaluations
    migration_chunk_records: int = 512       # records copied per pump step
    replica_count: int = 0                   # N-way replication per shard
    replica_lag_ops: int = 32                # applied-op lag per replica
    #                                          rank (replica 0 is synchronous)

    # ---- observability ----
    # Recording observers are not ported yet: ``Store`` runs with the
    # no-op NullObserver and refuses any other.  Excluded from
    # ``state_dict()`` as in the reference.
    observer: object | None = None

    def __post_init__(self):
        # lazy import: the strategy modules import table/IO substrate, which
        # imports this module — resolving at construction breaks the cycle
        from ..engines import get_strategy_class
        strat = get_strategy_class(self.engine)   # raises on unknown engine
        self.kv_separated = strat.kv_separated
        if self.gc_scheme is None:
            self.gc_scheme = strat.gc_schemes[0]
        elif self.gc_scheme not in strat.gc_schemes:
            raise ValueError(
                f"engine {self.engine!r} does not support gc_scheme "
                f"{self.gc_scheme!r} (supported: "
                f"{', '.join(strat.gc_schemes)})")
        for flag in ("compensated_compaction", "lazy_read",
                     "index_decoupled", "hotcold_write", "adaptive_enabled"):
            if getattr(self, flag) is None:
                setattr(self, flag, getattr(strat, flag))
        if self.adaptive_enabled and not strat.adaptive_enabled:
            # only strategies that construct a tracker honor the flag; a
            # silent no-op would masquerade as workload-adaptive GC
            raise ValueError(
                f"engine {self.engine!r} does not support "
                f"adaptive_enabled=True (use engine='scavenger_adaptive')")
        self._validate_adaptive()
        self._validate_kernels()
        self._validate_elastic()

    def _validate_adaptive(self):
        """Bounds for the adaptive-tracker knobs (always checked: the
        fields exist on every engine even when tracking is off)."""
        for field in ("adaptive_groups", "adaptive_sketch_width",
                      "adaptive_sketch_depth"):
            if getattr(self, field) < 1:
                raise ValueError(f"{field} must be >= 1, got "
                                 f"{getattr(self, field)}")
        for field in ("adaptive_half_life_ops", "adaptive_gc_horizon_ops",
                      "adaptive_score_refresh_ops"):
            if getattr(self, field) <= 0:
                raise ValueError(f"{field} must be > 0, got "
                                 f"{getattr(self, field)}")
        if not 0.0 < self.adaptive_residual_floor <= 1.0:
            raise ValueError("adaptive_residual_floor must be in (0, 1], got "
                             f"{self.adaptive_residual_floor}")
        if not 0.0 <= self.adaptive_defer_weight <= 1.0:
            raise ValueError("adaptive_defer_weight must be in [0, 1], got "
                             f"{self.adaptive_defer_weight}")
        if not 0.0 <= self.temp_cold_mult < self.temp_hot_mult:
            raise ValueError(
                "need 0 <= temp_cold_mult < temp_hot_mult, got "
                f"{self.temp_cold_mult} / {self.temp_hot_mult}")

    def _validate_kernels(self):
        """Bounds for the kernel-routing knobs (core/accel.py)."""
        if self.kernel_min_batch < 1:
            raise ValueError("kernel_min_batch must be >= 1, got "
                             f"{self.kernel_min_batch}")
        if self.coalesce_window is not None and self.coalesce_window < 1:
            raise ValueError("coalesce_window must be None or >= 1, got "
                             f"{self.coalesce_window}")

    def _validate_elastic(self):
        """Bounds for the elastic-fleet knobs (sharding/migrate.py, §14)."""
        if self.elastic_split_frac is not None \
                and not 0.0 < self.elastic_split_frac <= 1.0:
            raise ValueError("elastic_split_frac must be None or in (0, 1], "
                             f"got {self.elastic_split_frac}")
        if not 0.0 <= self.elastic_merge_frac < 1.0:
            raise ValueError("elastic_merge_frac must be in [0, 1), got "
                             f"{self.elastic_merge_frac}")
        if self.elastic_split_frac is not None \
                and self.elastic_merge_frac >= self.elastic_split_frac:
            raise ValueError(
                "elastic_merge_frac must be < elastic_split_frac (a shard "
                "eligible for both would split/merge forever), got "
                f"{self.elastic_merge_frac} / {self.elastic_split_frac}")
        if self.elastic_max_shards < 1:
            raise ValueError("elastic_max_shards must be >= 1, got "
                             f"{self.elastic_max_shards}")
        for field in ("elastic_cooldown_ops", "migration_chunk_records"):
            if getattr(self, field) < 1:
                raise ValueError(f"{field} must be >= 1, got "
                                 f"{getattr(self, field)}")
        if self.replica_count < 0:
            raise ValueError("replica_count must be >= 0, got "
                             f"{self.replica_count}")
        if self.replica_lag_ops < 0:
            raise ValueError("replica_lag_ops must be >= 0, got "
                             f"{self.replica_lag_ops}")

    # -------------------------------------------------------- serialization
    def state_dict(self) -> dict:
        """JSON-serializable field dict for MANIFEST/snapshot persistence.

        The live ``observer`` hook object is process state, not
        configuration — it is stripped here (and defaults to None when the
        dict is fed back through ``EngineConfig(**d)`` on recovery)."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self) if f.name != "observer"}

    @classmethod
    def from_state_dict(cls, d: dict) -> "EngineConfig":
        """The config a ``state_dict()`` describes — the reference
        package's too, which has the same fields: a plain dict carries the
        configuration across without importing the reference.  Unknown
        keys raise (``TypeError`` from the dataclass constructor)."""
        return cls(**{k: v for k, v in d.items() if k != "observer"})

    # ------------------------------------------------------------ properties
    @property
    def vsst_layout(self) -> str:
        return "rtable" if self.lazy_read else "btable"

    @property
    def ksst_layout(self) -> str:
        return "dtable" if self.index_decoupled else "btable"

    # record serialized sizes --------------------------------------------
    def inline_rec_bytes(self, vsize):
        return self.key_bytes + self.seq_bytes + self.rec_header_bytes + vsize

    def ref_rec_bytes(self):
        return (self.key_bytes + self.seq_bytes + self.rec_header_bytes
                + self.ref_bytes)

    def tomb_rec_bytes(self):
        return self.key_bytes + self.seq_bytes + self.rec_header_bytes

    def value_rec_bytes(self, vsize):
        return self.key_bytes + self.seq_bytes + self.rec_header_bytes + vsize

    # ---------------------------------------------------------------- scaled
    @classmethod
    def scaled(cls, engine: str, dataset_bytes: int,
               scale_ref_gb: float = 100.0, est_keys: int | None = None,
               **overrides) -> "EngineConfig":
        """Shrink the paper's 100GB configuration to ``dataset_bytes``.

        Ratios held: memtable=kSST=dataset/1600, vSST=4x kSST,
        base level = dataset/400, cache = 1% of dataset.  Block size and
        record formats stay at their real values.  Pass ``est_keys`` (the
        workload's key count) when known; it defaults to a 1KB-value
        estimate.
        """
        scale = dataset_bytes / (scale_ref_gb * (1 << 30))
        mt = max(32 << 10, int((64 << 20) * scale))
        # DropCache: 2% of a 4KB-page keyspace, floored at 512 — but
        # clamped to a quarter of the keyspace (tiny CI datasets hold fewer
        # keys than the floor; a DropCache covering every key would mark
        # all writes hot and disable the hot/cold split)
        if est_keys is None:
            est_keys = dataset_bytes // 1024
        est_keys = max(64, est_keys)
        cfg = dict(
            engine=engine,
            memtable_bytes=mt,
            ksst_bytes=mt,
            vsst_bytes=4 * mt,
            base_level_bytes=max(2 * mt, int((256 << 20) * scale)),
            cache_bytes=max(64 << 10, int(dataset_bytes * 0.01)),
            dropcache_keys=min(max(512, int(dataset_bytes / 4096 * 0.02)),
                               max(16, est_keys // 4)),
            # adaptive-tracker windows scale with the keyspace: decay over
            # ~2 full passes of updates, predict one pass ahead
            adaptive_half_life_ops=float(max(4096, 2 * est_keys)),
            adaptive_gc_horizon_ops=float(max(2048, est_keys)),
        )
        cfg.update(overrides)
        return cls(**cfg)
