"""The reference's fleet suites, replayed on the port on the CPU.

The reference package's ``tests/test_sharding.py`` (``n_shards=1``
byte-identical to ``Store`` on every engine, read-your-writes and ordered
scans over range and hash fleets, the dict-oracle property, the fleet
quota, starvation aging, the routers' topology invariants) and
``tests/test_elastic_fleet.py`` (the split/merge/failover crash matrix
on every engine, split and merge round trips, epoch-stamped re-dispatch,
auto-split and auto-merge, and the promoted replica against a golden
replay of its log) are loaded afresh with every ``repro.X`` import bound
to ``repro_torch.X``, ``Store`` and ``ShardedStore`` to the port's stores
on the CPU, by the machinery of ``tests/_torch_replay.py``.  Nothing is
left out.  The two suites have a file of their own so that a test run
spread over workers by file gives them a worker.
"""

from __future__ import annotations

from _torch_replay import (CpuShardedStore, CpuStore, assert_binds_port,
                           expose, load)

SUITES = ("test_sharding", "test_elastic_fleet")
LEFT_OUT: dict = {}

MODULES = {suite: load(suite) for suite in SUITES}
expose(globals(), MODULES, LEFT_OUT)


def test_replayed_fleet_suites_bind_the_port():
    """Every class, function and module the suites took from ``repro`` is
    the port's (the routers, ``scatter``, ``manifest_summary``,
    ``replay_into``), and ``Store``/``ShardedStore`` are the CPU stores."""
    assert_binds_port(MODULES)
    sharding = MODULES["test_sharding"]
    assert sharding.ShardedStore is CpuShardedStore
    assert sharding.Store is CpuStore
    assert sharding.make_router.__module__ == \
        "repro_torch.core.sharding.router"
    fleet = MODULES["test_elastic_fleet"]
    assert fleet.manifest_summary.__module__ == \
        "repro_torch.core.durability"
    assert fleet.replay_into.__module__ == "repro_torch.core.durability.wal"
    assert not LEFT_OUT
