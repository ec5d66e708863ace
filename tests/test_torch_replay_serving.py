"""The reference's serving suite, replayed on the port on the CPU.

The reference package's ``tests/test_serving.py`` is loaded afresh with
every ``repro.X`` import bound to ``repro_torch.X`` by the machinery of
``tests/_torch_replay.py``, so its four pager cases (admit, extend and
finish; no page booked twice; GC relocation keeping the tables; the
manager's invariants under hypothesis) run on the port's
``PagedKVCacheManager``.  Its three engine cases are left out: they seed
the reference model's params with ``jax.random.key``, which the port's
model does not take, and they call ``ServeEngine(model, params,
batch_slots=...)``, while the port's ``ServeEngine`` takes no ``params``
(its ``Model`` holds them), so ``params`` would bind to ``batch_slots``
(ROADMAP §3).  Their counterparts, which run both packages on the same
carried-over params and requests, each engine called its own way, are in
``tests/test_torch_serving.py``.
"""

from __future__ import annotations

from _torch_replay import assert_binds_port, expose, load

LEFT_OUT = {"test_serving": ("test_serve_engine_end_to_end",
                             "test_serve_duplicate_rid_rejected",
                             "test_serve_greedy_matches_forward")}

MODULES = {"test_serving": load("test_serving")}
expose(globals(), MODULES, LEFT_OUT)


def test_replayed_serving_suite_binds_the_port():
    """Every class, function and module the suite took from ``repro`` is
    the port's, and exactly the three engine cases are left out."""
    assert_binds_port(MODULES)
    module = MODULES["test_serving"]
    assert module.PagedKVCacheManager.__module__ == \
        "repro_torch.serve.paged_cache"
    assert module.ServeEngine.__module__ == "repro_torch.serve.engine"
    assert module.get_config.__module__ == "repro_torch.configs"
    assert module.build_model.__module__ == "repro_torch.models.model"
    cases = {n for n in vars(module) if n.startswith("test_")}
    left_out = set(LEFT_OUT["test_serving"])
    assert left_out <= cases and len(cases - left_out) == 4
    assert {f"test_serving__{n}" for n in cases - left_out} \
        <= set(globals())
    assert not {f"test_serving__{n}" for n in left_out} & set(globals())
