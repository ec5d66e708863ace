"""Workloads for elastic fleets: the hotspot seed that heats one shard of a
range fleet, and the small fleet, op stream and latest-write oracle check
of the reference's fleet crash matrix (``tests/test_elastic_fleet.py``).

    seed = hot_seed(n_keys)            # HotspotKeys(..., seed=seed)
    fleet = ShardedStore(EngineConfig(engine=e, **TINY_FLEET), n_shards=2,
                         key_space=FLEET_KEY_SPACE, device=...)
    oracle = {}
    fleet_rounds(fleet, oracle, rng, 4)
    assert oracle_mismatch(fleet, oracle) is None
"""

from __future__ import annotations

import numpy as np

from ..core.batch import WriteBatch
from .generator import HotspotKeys

# the crash matrix's fleet: every structure a few KiB, so a few hundred
# puts flush, compact, GC and split
TINY_FLEET = dict(memtable_bytes=8 << 10, ksst_bytes=8 << 10,
                  vsst_bytes=32 << 10, base_level_bytes=16 << 10,
                  cache_bytes=16 << 10, dropcache_keys=64,
                  sep_threshold=256, max_levels=5)
FLEET_KEY_SPACE = 4096
FLEET_VSIZES = (64, 600, 2000)


def hot_seed(n_keys: int, n_shards: int = 2) -> int:
    """Smallest ``HotspotKeys`` seed whose hot set lies inside one of the
    ``n_shards`` initial range slices, so the hotspot heats exactly one
    shard (the reference's ``benchmarks/elasticity.py`` ``_hot_seed``);
    0 if none of the first 64 does."""
    half = n_keys // n_shards
    for seed in range(64):
        probe = HotspotKeys(n_keys, hot_n=max(1, n_keys // 8),
                            hot_frac=1.0, shift_every=1 << 30, seed=seed)
        ks = probe.sample(np.random.default_rng(0), 512)
        if ks.max() < half or ks.min() >= half:
            return seed
    return 0


def fleet_rounds(fleet, oracle: dict, rng: np.random.Generator,
                 rounds: int = 6, n: int = 64) -> None:
    """Put rounds of ``n`` keys over ``FLEET_KEY_SPACE`` with value sizes
    from ``FLEET_VSIZES``, and in every second round delete 8 live keys,
    one batch a round, mirrored into ``oracle`` (key -> latest vsize)."""
    for r in range(rounds):
        ks = rng.integers(0, FLEET_KEY_SPACE, n).astype(np.uint64)
        vs = rng.choice(FLEET_VSIZES, n).astype(np.int64)
        b = WriteBatch().puts(ks, vs)
        oracle.update(zip(ks.tolist(), vs.tolist()))
        if r % 2 == 1 and oracle:
            dks = rng.choice(np.fromiter(oracle, np.uint64,
                                         count=len(oracle)),
                             min(8, len(oracle)), replace=False)
            for k in dks.tolist():
                b.delete(k)
                oracle.pop(k, None)
        fleet.write(b)


def oracle_mismatch(fleet, oracle: dict) -> str | None:
    """How ``fleet`` departs from the latest-write ``oracle``: a live key
    lost or holding a stale vsize, or a deleted or never-written key of
    ``FLEET_KEY_SPACE`` found (every len // 64-th probed); None if none."""
    if not oracle:
        return "the oracle is empty"
    ks = np.fromiter(sorted(oracle), np.uint64, count=len(oracle))
    res = fleet.multi_get(ks)
    if not res["found"].all():
        return f"lost keys: {ks[~res['found']][:10].tolist()}"
    want = np.array([oracle[int(k)] for k in ks.tolist()], np.int64)
    if not (res["vsize"] == want).all():
        return f"stale values: {ks[res['vsize'] != want][:10].tolist()}"
    dead = np.setdiff1d(np.arange(FLEET_KEY_SPACE, dtype=np.uint64), ks)
    if len(dead):
        probe = dead[:: max(1, len(dead) // 64)]
        if fleet.multi_get(probe)["found"].any():
            return "resurrected deleted or never-written keys"
    return None
