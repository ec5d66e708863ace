"""The reference's durability suite, replayed on the port on the CPU.

The reference package's ``tests/test_durability.py`` (the crash matrix
over every engine and crash point, recovery without a checkpoint, torn
MANIFEST and WAL tails, the MANIFEST round-trip and WAL prefix-replay
properties) is loaded afresh with every ``repro.X`` import bound to
``repro_torch.X`` and ``Store`` to the port's store on the CPU, by the
machinery of ``tests/_torch_replay.py`` that also replays the store suites
(``tests/test_torch_replay_store_suites.py``).  It has a file of its own
so that a test run spread over workers by file gives it a worker.

``test_serve_page_table_restore`` drives the port's recovered store
through the reference's ``repro.serve`` modules, which the port does not
have yet: it holds the port's serve modules once they land (ROADMAP §1
item 5).  Left out, because they need what the port does not have yet:

* ``test_fleet_one_shard_recovery_matches_store``,
  ``test_fleet_crash_recovery`` and ``test_fleet_crash_mid_fleet_checkpoint``:
  ``ShardedStore`` is not ported (ROADMAP §1 item 2), so the name binds
  ``None``.
"""

from __future__ import annotations

from _torch_replay import assert_binds_port, expose, load

# ShardedStore not ported, ROADMAP §1 item 2
LEFT_OUT = {"test_durability": (
    "test_fleet_one_shard_recovery_matches_store",
    "test_fleet_crash_recovery",
    "test_fleet_crash_mid_fleet_checkpoint")}

MODULES = {"test_durability": load("test_durability")}
expose(globals(), MODULES, LEFT_OUT)


def test_replayed_durability_suite_binds_the_port():
    """Every class, function and module the suite took from ``repro`` is
    the port's, ``Store`` is the CPU store, and the names left out are the
    fleet cases alone, the only ones that need ``ShardedStore``."""
    assert_binds_port(MODULES)
    module = MODULES["test_durability"]
    assert module.ShardedStore is None
    assert module.Durability.__module__.startswith("repro_torch.")
    fleet = {n for n in vars(module) if n.startswith("test_fleet_")}
    assert fleet == set(LEFT_OUT["test_durability"])
