"""Sharding subsystem (port of ``repro.core.sharding``): ShardedStore +
fleet-level GC/compaction scheduler + live elasticity.

``ShardedStore`` partitions the keyspace across N independent ``Store``
shards (hash or range routing) behind the same batched columnar API, and
replaces per-shard ``pump()`` with a ``FleetScheduler`` that ranks GC jobs
by garbage ratio and compaction jobs by compensated-size score across the
whole fleet, under shared I/O-lane and space budgets.  See DESIGN.md §6.

Elasticity (DESIGN.md §14): routers are slice tables supporting online
split/merge with epoch-stamped re-dispatch (``router.py``), migrations run
checkpoint-copy → re-route → delta-replay (``migrate.py``), and each
primary journals its op stream to N replica Stores so ``fail_primary``
can promote the most-caught-up one (``replica.py``).

Host NumPy, as in the reference: the fleet's routing, scheduling and
migration bookkeeping copy the reference's in the same order, and every
shard and replica is a port ``Store`` on the fleet's device, whose batched
probes run the CUDA kernels (``core/accel.py``).
"""

from .fleet import SCHEDULERS, FleetScheduler
from .migrate import ElasticityManager, Migration
from .replica import ShardReplicator
from .router import (POLICIES, HashRouter, RangeRouter, SliceRouter,
                     make_router, restore_router, scatter)
from .store import ShardedStore

__all__ = ["ShardedStore", "FleetScheduler", "SCHEDULERS", "POLICIES",
           "HashRouter", "RangeRouter", "SliceRouter", "make_router",
           "restore_router", "scatter", "ElasticityManager", "Migration",
           "ShardReplicator"]
