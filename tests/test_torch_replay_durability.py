"""The reference's durability suite, replayed on the port on the CPU.

The reference package's ``tests/test_durability.py`` (the crash matrix
over every engine and crash point, recovery without a checkpoint, torn
MANIFEST and WAL tails, the MANIFEST round-trip and WAL prefix-replay
properties, and the three fleet-recovery cases) is loaded afresh with
every ``repro.X`` import bound to ``repro_torch.X``, ``Store`` and
``ShardedStore`` to the port's stores on the CPU, by the machinery of
``tests/_torch_replay.py`` that also replays the store suites
(``tests/test_torch_replay_store_suites.py``).  It has a file of its own
so that a test run spread over workers by file gives it a worker.
Nothing is left out.

``test_serve_page_table_restore`` drives the port's recovered store
through the reference's ``repro.serve`` modules, which the port does not
have yet: it holds the port's serve modules once they land (ROADMAP §1
item 5).
"""

from __future__ import annotations

from _torch_replay import (CpuShardedStore, assert_binds_port, expose,
                           load)

LEFT_OUT: dict = {}

MODULES = {"test_durability": load("test_durability")}
expose(globals(), MODULES, LEFT_OUT)


def test_replayed_durability_suite_binds_the_port():
    """Every class, function and module the suite took from ``repro`` is
    the port's, ``Store`` is the CPU store, ``ShardedStore`` the CPU
    fleet, and every case of the suite runs, the fleet cases too."""
    assert_binds_port(MODULES)
    module = MODULES["test_durability"]
    assert module.ShardedStore is CpuShardedStore
    assert module.Durability.__module__.startswith("repro_torch.")
    fleet = {n for n in vars(module) if n.startswith("test_fleet_")}
    assert len(fleet) == 3
    assert {f"test_durability__{n}" for n in fleet} <= set(globals())
    assert not LEFT_OUT
