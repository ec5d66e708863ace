"""The port's serving path (``repro_torch.serve``, ``repro_torch.launch.serve``)
against the reference package's, on the CPU.

The reference's three engine cases (``tests/test_serving.py``: the
end-to-end run, the duplicate-rid guard, greedy decode against a full
forward) run on both packages with the same params (the reference's,
carried over by ``params_from_jax``) and the same requests.  Every decode
call's logits agree at rtol = atol = 1e-4 (float32), every sampled step's
top-two gap is asserted above twice that tolerance, so the token streams
must be identical, and they are; so are the pager's and the metadata
store's ``stats()``.  The end-to-end case runs with 2 slots (one slot's
call writes every slot's cache rows, as in the reference), with the
default, a 2-shard and a ``scavenger_adaptive`` metadata store.  The
durable metadata store is crashed and recovered under both engines, and
``launch.serve.main`` prints the reference launcher's pager line.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as RCore
import repro.launch.serve as RLaunch
import repro.serve as RS
import repro_torch.core as TCore
import repro_torch.launch.serve as TLaunch
import repro_torch.serve as TS
from repro.configs import get_config as ref_config
from repro.models.model import build_model as ref_build
from repro_torch.configs import get_config
from repro_torch.models import Model, params_from_jax

TOL = {"rtol": 1e-4, "atol": 1e-4}
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small CPU ops on many threads contend for the cores (100x slower)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch, seed):
    """The reference's model and params, and the port's model on the CPU
    holding the same params."""
    jm = ref_build(ref_config(arch, smoke=True))
    jp = jm.init_params(jax.random.key(seed))
    tm = Model(get_config(arch, smoke=True), device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp),
                                       tm.cfg))
    return jm, jp, tm


class Pair:
    """The reference's engine and the port's on the same params, each
    recording every decode call's logits and which slot it sampled."""

    def __init__(self, arch, seed, **engine_kw):
        self.jm, self.jp, self.tm = _models(arch, seed)
        self.ref = RS.ServeEngine(self.jm, self.jp, **engine_kw)
        self.port = TS.ServeEngine(self.tm, device="cpu", **engine_kw)
        self.calls = {"ref": [], "port": []}
        self._record("ref", self.ref, "_step_fn")
        self._record("port", self.port.model, "serve_step")

    def _record(self, side, obj, attr):
        calls, step = self.calls[side], getattr(obj, attr)
        eng = self.ref if side == "ref" else self.port
        single = eng._single

        def stepped(*args):
            logits, cache = step(*args)
            calls[-1]["logits"] = np.asarray(logits, np.float32) \
                if side == "ref" else logits.float().numpy()
            return logits, cache

        def single_call(slot, token, sample=False):
            calls.append({"slot": slot, "sample": sample})
            single(slot, token, sample)
        setattr(obj, attr, stepped)
        eng._single = single_call

    def submit(self, specs):
        """specs: (rid, prompt, max_new[, hot]); -> (ref reqs, port reqs)"""
        out = []
        for mod, eng in ((RS, self.ref), (TS, self.port)):
            reqs = [mod.Request(rid=s[0], prompt=list(s[1]), max_new=s[2],
                                hot=s[3] if len(s) > 3 else True)
                    for s in specs]
            for r in reqs:
                eng.submit(r)
            out.append(reqs)
        return out

    def check(self, min_calls=1):
        """Every decode call's logits agree; every sampled step is
        decisive (top-two gap above twice the tolerance)."""
        ref, port = self.calls["ref"], self.calls["port"]
        assert len(ref) == len(port) >= min_calls
        vocab = self.tm.cfg.vocab
        for r, p in zip(ref, port):
            assert (r["slot"], r["sample"]) == (p["slot"], p["sample"])
            np.testing.assert_allclose(p["logits"], r["logits"], **TOL)
            if r["sample"]:
                row = np.sort(r["logits"][r["slot"], 0, :vocab])
                tol = TOL["atol"] + TOL["rtol"] * abs(row[-1])
                assert row[-1] - row[-2] > 2 * tol, "indecisive step"

    def check_stats(self):
        assert self.port.stats() == self.ref.stats()
        assert self.port.meta.stats() == self.ref.meta.stats()


META = {"default": {}, "meta_shards_2": {"meta_shards": 2},
        "adaptive_meta": {"meta_engine": "scavenger_adaptive"}}


@pytest.mark.parametrize("meta", list(META))
def test_serve_engine_end_to_end_matches_reference(meta):
    """``test_serving.py::test_serve_engine_end_to_end`` on both packages:
    2 slots, so prompts and decodes sit at different positions and each
    call writes the other slot's cache rows too."""
    pair = Pair("smollm_360m", 0, batch_slots=2, cache_len=64,
                **META[meta])
    rng = np.random.default_rng(0)
    specs = [(i, rng.integers(0, 512, 5).tolist(), 4, i % 3 != 0)
             for i in range(5)]
    ref_reqs, port_reqs = pair.submit(specs)
    pair.ref.run()
    pair.port.run()
    pair.check(min_calls=5 * (4 + 3))
    assert [r.out for r in port_reqs] == [r.out for r in ref_reqs]
    assert all(r.done and len(r.out) == 4 for r in port_reqs)
    assert all(0 <= t < 512 for r in port_reqs for t in r.out)
    pair.check_stats()
    pair.port.pager.run_gc()
    pair.ref.pager.run_gc()
    assert pair.port.pager.stats()["live_pages"] == 0
    assert pair.port.pager.stats() == pair.ref.pager.stats()
    if meta == "meta_shards_2":
        assert isinstance(pair.port.meta, TCore.ShardedStore)
    if meta == "adaptive_meta":
        assert pair.port.meta.strategy.tempmap is not None


def test_serve_duplicate_rid_rejected_like_reference():
    """``test_serving.py::test_serve_duplicate_rid_rejected`` on both."""
    pair = Pair("smollm_360m", 0, batch_slots=2, cache_len=64)
    out = []
    for mod, eng in ((RS, pair.ref), (TS, pair.port)):
        eng.submit(mod.Request(rid=7, prompt=[1, 2, 3], max_new=64))
        eng.step()
        eng.submit(mod.Request(rid=7, prompt=[4, 5], max_new=4))
        ok = mod.Request(rid=8, prompt=[6], max_new=1)
        eng.submit(ok)
        with pytest.raises(ValueError, match="already admitted"):
            eng.step()
        eng.run(max_steps=10)       # duplicate dropped; the queue drains
        assert ok.done
        out.append(ok.out)
    assert out[0] == out[1]
    pair.check()
    pair.check_stats()


def test_serve_greedy_matches_forward_and_reference():
    """``test_serving.py::test_serve_greedy_matches_forward``: the port's
    engine decode equals greedy decode through the port's full forward,
    and both equal the reference's."""
    pair = Pair("qwen2_05b", 1, batch_slots=1, cache_len=32)
    prompt = [3, 7, 11, 2]
    ref_reqs, port_reqs = pair.submit([(0, prompt, 3)])
    pair.ref.run()
    pair.port.run()
    pair.check(min_calls=len(prompt) + 2)
    toks, jtoks = list(prompt), list(prompt)
    for _ in range(3):
        with torch.no_grad():
            logits = pair.tm.forward({"tokens": torch.tensor([toks])})
        toks.append(int(torch.argmax(logits[0, -1, :pair.tm.cfg.vocab])))
        jl = pair.jm.forward(pair.jp, {"tokens": jnp.asarray([jtoks])})
        jtoks.append(int(jnp.argmax(jl[0, -1, :pair.tm.cfg.vocab])))
    assert port_reqs[0].out == toks[len(prompt):] == jtoks[len(prompt):]
    assert ref_reqs[0].out == port_reqs[0].out
    pair.check_stats()


def test_durable_meta_store_restores_page_tables_like_reference(tmp_path):
    """Run part of the traffic over a durable metadata store, abandon it
    as a crash, recover it, and restore a fresh engine's page tables:
    exactly the rids admitted and not finished, on both packages; then the
    requests never admitted finish on the fresh engines."""
    specs = [(i, [1 + i, 2, 3, 4 + i], 3 + i % 3) for i in range(10)]
    jm, jp, tm = _models("smollm_360m", 0)
    restored, outs, metas = [], [], []
    for side, (mod, core, kw) in {
            "ref": (RS, RCore, {}),
            "port": (TS, TCore, {"device": "cpu"})}.items():
        cfg = core.EngineConfig.scaled("scavenger", 4 << 20)
        model = (jm, jp) if side == "ref" else (tm,)
        eng = mod.ServeEngine(*model, batch_slots=4, cache_len=32,
                              meta_store=core.Store(
                                  cfg, durability_dir=tmp_path / side,
                                  **kw), **kw)
        reqs = [mod.Request(rid=s[0], prompt=s[1], max_new=s[2])
                for s in specs]
        for r in reqs:
            eng.submit(r)
        for _ in range(5):
            eng.step()
        live = sorted(r.rid for r in eng.slot_req if r is not None)
        done = {r.rid for r in reqs if r.done}
        assert live and done
        del eng                                     # crash: no close
        meta = core.Store.open(tmp_path / side, **kw)
        fresh = mod.ServeEngine(*model, batch_slots=4, cache_len=32,
                                meta_store=meta, **kw)
        got = fresh.restore_page_tables()
        assert got == live
        rest = [mod.Request(rid=s[0], prompt=s[1], max_new=s[2])
                for s in specs if s[0] not in done and s[0] not in live]
        for r in rest:
            fresh.submit(r)
        fresh.run()
        assert rest and all(r.done and len(r.out) == r.max_new
                            for r in rest)
        rows = meta.multi_scan(np.array([0], np.int64), count=64)[0]
        assert [k for k, _ in rows] == live
        restored.append(got)
        outs.append([r.out for r in rest])
        metas.append(meta.stats())
    assert restored[0] == restored[1] and outs[0] == outs[1]
    assert metas[0] == metas[1]


def test_launch_serve_prints_the_reference_lines(monkeypatch):
    """``python -m repro_torch.launch.serve --arch smollm-360m --smoke
    --device cpu``: the reference launcher's two lines, the pager's
    ``stats()`` equal to the reference launcher's (page accounting
    depends on the requests, not on the weights)."""
    args = ["--arch", "smollm-360m", "--smoke", "--requests", "5"]
    out = {}
    for side, run in (("port", lambda: TLaunch.main(args + ["--device",
                                                            "cpu"])),
                      ("ref", RLaunch.main)):
        monkeypatch.setattr(sys, "argv", ["serve"] + args)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run()
        out[side] = buf.getvalue().splitlines()
    for lines in out.values():
        assert len(lines) == 2
        assert re.fullmatch(r"\[serve\] 5 requests, 60 tokens in "
                            r"[\d.]+s \([\d.]+ tok/s\)", lines[0])
        assert lines[1].startswith("[serve] pager: ")
    stats = [json.loads(out[s][1][len("[serve] pager: "):])
             for s in ("port", "ref")]
    assert stats[0] == stats[1]
    assert stats[0]["live_pages"] == 0


@pytest.mark.parametrize("seed,n,max_new", [(0, 8, 12), (3, 9, 5)])
def test_draw_requests_is_the_reference_launchers_draw(monkeypatch, seed,
                                                      n, max_new):
    """``draw_requests`` gives the requests the reference launcher submits
    (its engine's ``run`` stubbed out): the same rids, prompts, max_new
    and hot flags."""
    submitted = []
    monkeypatch.setattr(RS.ServeEngine, "submit",
                        lambda self, req: submitted.append(req))
    monkeypatch.setattr(RS.ServeEngine, "run", lambda self: None)
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "smollm-360m", "--smoke", "--seed", str(seed),
        "--requests", str(n), "--max-new", str(max_new)])
    with contextlib.redirect_stdout(io.StringIO()):
        RLaunch.main()
    vocab = get_config("smollm-360m", smoke=True).vocab
    drawn = TLaunch.draw_requests(vocab, n, max_new, seed=seed)
    assert [(r.rid, r.prompt, r.max_new, r.hot) for r in drawn] == \
        [(r.rid, r.prompt, r.max_new, r.hot) for r in submitted]
    assert len(drawn) == n and any(r.hot for r in drawn) \
        and not all(r.hot for r in drawn)


def test_engine_and_launch_default_to_cuda_and_raise_without_it(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = Model(get_config("smollm_360m", smoke=True), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.ServeEngine(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        TLaunch.main(["--arch", "smollm-360m", "--smoke"])
    eng = TS.ServeEngine(model, device="cpu")
    assert eng.meta.device.type == "cpu"
    assert eng.cache["k"].device.type == "cpu"
    sharded = TS.ServeEngine(model, device="cpu", meta_shards=2)
    assert sharded.meta.device.type == "cpu"
    assert all(s.device.type == "cpu" for s in sharded.meta.shards)


def test_launch_serve_command_needs_cuda_unless_told_otherwise():
    """``python -m repro_torch.launch.serve`` with no card: fails and
    prints no result; with ``--device cpu`` it serves."""
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "smollm-360m", "--smoke", "--requests", "2", "--max-new", "3"]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "[serve]" not in out.stdout
    out = subprocess.run(cmd + ["--device", "cpu"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 2 and lines[0].startswith("[serve] 2 requests, 6 ")
    assert json.loads(lines[1][len("[serve] pager: "):])["live_pages"] == 0
