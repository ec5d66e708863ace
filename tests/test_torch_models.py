"""The port's model stack (``repro_torch.models``, ``repro_torch.configs``)
against the reference package's, on the CPU.

* ``get_config`` equals the reference's for all ten archs at both sizes,
  parameter counts included.
* Each dense layer (norms, RoPE, attention without a cache, with a decode
  cache and with a rolling windowed ring, both FFNs, the loss) gets the
  same seeded NumPy inputs as the reference's: float32, rtol = atol =
  1e-4.
* ``forward``, ``loss``, ``prefill`` and three ``serve_step`` calls on the
  four dense archs' ``SMOKE`` configs, the reference's params carried over
  by ``params_from_jax``: float32 at rtol = atol = 1e-4; the same configs
  in bfloat16 at atol = 2e-2 of the logits' largest magnitude (about five
  bfloat16 ulps at 1.0, as each step rounds both sides independently),
  rtol = 2e-2.
* ``params_from_jax`` rejects a missing, an extra or a misshapen leaf;
  ``build_model`` raises for every family and variant not ported; the
  model runs on CUDA unless told otherwise, and raises without it.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models.layers as RL
import repro.models.model as RM
import repro_torch.configs as TC
import repro_torch.models.layers as TL
from repro_torch.models import Model, build_model, params_from_jax

F32 = {"rtol": 1e-4, "atol": 1e-4}
DENSE = ("smollm_360m", "qwen15_05b", "qwen2_05b", "stablelm_16b")
UNPORTED = ("phi35_moe", "arctic_480b", "whisper_base",
            "llava_next_mistral_7b", "jamba_15_large", "xlstm_125m")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small CPU ops on many threads contend for the cores (100x slower)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _torch(tree):
    return _tree(lambda a: torch.from_numpy(np.array(a)), tree)


def _jax(tree):
    return _tree(jnp.asarray, tree)


def _linear_p(rng, d_in, d_out, bias):
    p = {"w": rng.standard_normal((d_in, d_out), np.float32)
         / np.float32(np.sqrt(d_in))}
    if bias:
        p["b"] = rng.standard_normal(d_out, np.float32) * np.float32(0.1)
    return p


def _attn_p(rng, cfg):
    d, hd = cfg.d_model, cfg.hd
    return {"wq": _linear_p(rng, d, cfg.n_heads * hd, cfg.qkv_bias),
            "wk": _linear_p(rng, d, cfg.n_kv_heads * hd, cfg.qkv_bias),
            "wv": _linear_p(rng, d, cfg.n_kv_heads * hd, cfg.qkv_bias),
            "wo": _linear_p(rng, cfg.n_heads * hd, d, False)}


def _pair(name, smoke):
    return RC.get_config(name, smoke), TC.get_config(name, smoke)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", RC.ARCHS)
def test_config_equals_reference(arch, smoke):
    ref, port = _pair(arch, smoke)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert (port.hd, port.vocab_padded, port.sub_quadratic) \
        == (ref.hd, ref.vocab_padded, ref.sub_quadratic)


def test_config_names_and_aliases_equal_reference():
    assert TC.ARCHS == RC.ARCHS and TC.ALIASES == RC.ALIASES
    for alias, mod in RC.ALIASES.items():
        assert TC.get_config(alias) == TC.get_config(mod)
    assert {k: dataclasses.asdict(v) for k, v in TC.all_configs().items()} \
        == {k: dataclasses.asdict(v) for k, v in RC.all_configs().items()}


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_apply_norm(kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64), np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(64, np.float32)}
    if kind == "ln":
        p["bias"] = rng.standard_normal(64, np.float32)
    _close(TL.apply_norm(_torch(p), torch.from_numpy(x), kind),
           RL.apply_norm(_jax(p), jnp.asarray(x), kind), **F32)


@pytest.mark.parametrize("batched", [False, True])
def test_rope(batched):
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 4096, (3, 7) if batched else (7,))
    x = rng.standard_normal((3, 7, 4, 16), np.float32)
    cos, sin = TL.rope_angles(torch.from_numpy(pos), 16, 10000.0)
    rcos, rsin = RL.rope_angles(jnp.asarray(pos), 16, 10000.0)
    _close(cos, rcos, **F32)
    _close(sin, rsin, **F32)
    _close(TL.apply_rope(torch.from_numpy(x), cos, sin),
           RL.apply_rope(jnp.asarray(x), rcos, rsin), **F32)


ATTN_CASES = {      # config, window, causal
    "gqa_causal": ("smollm_360m", None, True),
    "mha_bias_causal": ("qwen15_05b", None, True),
    "gqa_bias_window": ("qwen2_05b", 3, True),
    "bidirectional": ("stablelm_16b", None, False),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_without_cache(case):
    arch, window, causal = ATTN_CASES[case]
    ref, port = _pair(arch, True)
    ref = dataclasses.replace(ref, window=window)
    port = dataclasses.replace(port, window=window)
    rng = np.random.default_rng(3)
    p = _attn_p(rng, ref)
    x = rng.standard_normal((2, 9, ref.d_model), np.float32)
    out, cache = TL.attention(_torch(p), torch.from_numpy(x), port,
                              causal=causal)
    want, _ = RL.attention(_jax(p), jnp.asarray(x), ref, RL.NO_CTX,
                           causal=causal)
    assert cache is None
    _close(out, want, **F32)


@pytest.mark.parametrize("window", [None, 4], ids=["full", "window_mask"])
def test_attention_decode_with_cache(window):
    """A 5-token prefill into a 16-row cache, then single-token decodes at
    positions 5..7 (the windowed config masks by position, the cache being
    longer than the window); the cache is written in place at every row."""
    ref, port = _pair("qwen2_05b", True)
    ref = dataclasses.replace(ref, window=window)
    port = dataclasses.replace(port, window=window)
    rng = np.random.default_rng(4)
    p = _attn_p(rng, ref)
    shape = (2, 16, ref.n_kv_heads, ref.hd)
    rc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tc = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    x = rng.standard_normal((2, 5, ref.d_model), np.float32)
    want, rc = RL.attention(_jax(p), jnp.asarray(x), ref, RL.NO_CTX,
                            positions=jnp.arange(5), cache=rc, cache_pos=0)
    out, tc = TL.attention(_torch(p), torch.from_numpy(x), port,
                           positions=torch.arange(5), cache=tc, cache_pos=0)
    _close(out, want, **F32)
    for pos in (5, 6, 7):
        x = rng.standard_normal((2, 1, ref.d_model), np.float32)
        want, rc = RL.attention(_jax(p), jnp.asarray(x), ref, RL.NO_CTX,
                                positions=jnp.full((1,), pos), cache=rc,
                                cache_pos=pos)
        out, tc = TL.attention(_torch(p), torch.from_numpy(x), port,
                               positions=torch.full((1,), pos), cache=tc,
                               cache_pos=pos)
        _close(out, want, **F32)
        _close(tc["k"], rc["k"], **F32)
        _close(tc["v"], rc["v"], **F32)


def test_attention_rolling_windowed_ring():
    """A cache of exactly ``window`` rows is a ring: decode writes at
    ``pos % window`` and every slot is valid once it has wrapped."""
    ref, port = _pair("smollm_360m", True)
    ref = dataclasses.replace(ref, window=4)
    port = dataclasses.replace(port, window=4)
    rng = np.random.default_rng(5)
    p = _attn_p(rng, ref)
    shape = (2, 4, ref.n_kv_heads, ref.hd)
    rc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tc = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    for pos in range(11):
        x = rng.standard_normal((2, 1, ref.d_model), np.float32)
        want, rc = RL.attention(_jax(p), jnp.asarray(x), ref, RL.NO_CTX,
                                positions=jnp.full((1,), pos), cache=rc,
                                cache_pos=pos)
        out, tc = TL.attention(_torch(p), torch.from_numpy(x), port,
                               positions=torch.full((1,), pos), cache=tc,
                               cache_pos=pos)
        _close(out, want, **F32)
        _close(tc["k"], rc["k"], **F32)


def test_attention_decode_past_the_cache_clamps_like_the_reference():
    """A position at or past the cache's end: the reference's
    ``dynamic_update_slice`` clamps its start to the last row."""
    ref, port = _pair("smollm_360m", True)
    rng = np.random.default_rng(6)
    p = _attn_p(rng, ref)
    shape = (1, 4, ref.n_kv_heads, ref.hd)
    k0 = rng.standard_normal(shape, np.float32)
    rc = {"k": jnp.asarray(k0), "v": jnp.asarray(k0)}
    tc = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(k0.copy())}
    x = rng.standard_normal((1, 1, ref.d_model), np.float32)
    want, rc = RL.attention(_jax(p), jnp.asarray(x), ref, RL.NO_CTX,
                            positions=jnp.full((1,), 6), cache=rc,
                            cache_pos=6)
    out, tc = TL.attention(_torch(p), torch.from_numpy(x), port,
                           positions=torch.full((1,), 6), cache=tc,
                           cache_pos=6)
    _close(out, want, **F32)
    _close(tc["k"], rc["k"], **F32)
    _close(tc["v"], rc["v"], **F32)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_ffn(act):
    ref, port = _pair("smollm_360m", True)
    ref = dataclasses.replace(ref, act=act)
    port = dataclasses.replace(port, act=act)
    rng = np.random.default_rng(7)
    d, f = ref.d_model, ref.d_ff
    if act == "swiglu":
        p = {"w1": _linear_p(rng, d, f, False), "w3": _linear_p(rng, d, f,
                                                                False),
             "w2": _linear_p(rng, f, d, False)}
    else:
        p = {"w1": _linear_p(rng, d, f, True), "w2": _linear_p(rng, f, d,
                                                               True)}
    x = rng.standard_normal((2, 5, d), np.float32)
    _close(TL.ffn(_torch(p), torch.from_numpy(x), port),
           RL.ffn(_jax(p), jnp.asarray(x), ref, RL.NO_CTX), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy(dtype):
    """Ignored labels (-1) and padded vocab columns, as the reference."""
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((2, 6, 64), np.float32) * 4
    labels = rng.integers(-1, 50, (2, 6))
    jl = jnp.asarray(logits).astype(dtype)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    _close(TL.cross_entropy(tl, torch.from_numpy(labels), 50),
           RL.cross_entropy(jl, jnp.asarray(labels), 50), **F32)
    none = np.full((2, 6), -1)
    assert float(TL.cross_entropy(tl, torch.from_numpy(none), 50)) == 0.0


# ------------------------------------------------------------------- model
def _models(arch, dtype, seed=0):
    ref, port = _pair(arch, True)
    ref = dataclasses.replace(ref, dtype=dtype)
    port = dataclasses.replace(port, dtype=dtype)
    jm = RM.build_model(ref)
    jp = jm.init_params(jax.random.key(seed))
    tm = Model(port, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), port))
    return jm, jp, tm


TOL = {"float32": F32,
       "bfloat16": {"rtol": 2e-2, "atol": 2e-2, "scaled": True}}


def _close_scaled(got, want, tol):
    """atol relative to the reference's largest magnitude (bfloat16)."""
    w = _np(want)
    scale = max(1.0, float(np.abs(w).max())) if tol.get("scaled") else 1.0
    np.testing.assert_allclose(_np(got), w, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_model_forward_prefill_and_serve_steps(arch, dtype):
    jm, jp, tm = _models(arch, dtype)
    tol = TOL[dtype]
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, tm.cfg.vocab, (2, 7))
    jt, tt = jnp.asarray(tokens, jnp.int32), torch.from_numpy(tokens)
    _close_scaled(tm.forward({"tokens": tt}), jm.forward(jp, {"tokens": jt}),
                  tol)
    _close_scaled(tm.loss({"tokens": tt}), jm.loss(jp, {"tokens": jt}), tol)

    want, rc = jm.prefill(jp, {"tokens": jt}, cache_len=16)
    got, tc = tm.prefill({"tokens": tt}, cache_len=16)
    _close_scaled(got, want, tol)
    for name in ("k", "v"):
        _close_scaled(tc[name], rc["slot0"][name], tol)
    step = jax.jit(jm.serve_step)
    for pos in (7, 8, 9):
        tok = rng.integers(0, tm.cfg.vocab, (2, 1))
        want, rc = step(jp, rc, {"token": jnp.asarray(tok, jnp.int32),
                                 "pos": jnp.int32(pos)})
        got, tc = tm.serve_step(tc, {"token": torch.from_numpy(tok),
                                     "pos": pos})
        _close_scaled(got, want, tol)
        for name in ("k", "v"):
            _close_scaled(tc[name], rc["slot0"][name], tol)


def test_init_cache_shape_and_dtype():
    jm, _, tm = _models("qwen2_05b", "bfloat16")
    c = tm.init_cache(3, 20)
    want = jm.cache_shapes(3, 20)["slot0"]["k"]
    assert tuple(c["k"].shape) == want.shape
    assert c["k"].dtype == c["v"].dtype == torch.bfloat16
    assert not c["k"].any() and not c["v"].any()


def test_init_params_seeded_with_the_reference_distributions():
    cfg = dataclasses.replace(TC.get_config("qwen15_05b", smoke=True),
                              d_model=256, d_ff=512)
    a = build_model(cfg, seed=3, device="cpu")
    b = build_model(cfg, seed=3, device="cpu")
    c = build_model(cfg, seed=4, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embed"], sc["embed"])
    assert abs(float(sa["embed"].std()) - 0.02) < 0.002
    for k, t in sa.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "w":
            std = 1.0 / np.sqrt(t.shape[0])
            assert abs(float(t.std()) - std) < 0.1 * std, k
        elif leaf == "scale":
            assert bool((t == 1).all()), k
        elif leaf in ("b", "bias"):
            assert not t.any(), k
    full = build_model(dataclasses.replace(cfg, dtype="bfloat16"), seed=3,
                       device="cpu")
    assert full.embed.dtype == torch.bfloat16


# -------------------------------------------------------- params_from_jax
def _ref_tree(arch="qwen15_05b"):
    ref, port = _pair(arch, True)
    tree = jax.tree.map(np.asarray, RM.build_model(ref).init_params(
        jax.random.key(0)))
    return tree, port


def test_params_from_jax_rejects_a_missing_leaf():
    tree, cfg = _ref_tree()
    del tree["layers"]["slot0"]["attn"]["wq"]["b"]
    with pytest.raises(ValueError, match="missing leaves.*attn.wq.b"):
        params_from_jax(tree, cfg)


def test_params_from_jax_rejects_an_extra_leaf():
    tree, cfg = _ref_tree()
    tree["patch_proj"] = {"w": np.zeros((64, 64), np.float32)}
    with pytest.raises(ValueError, match="unused leaves.*patch_proj.w"):
        params_from_jax(tree, cfg)
    tree, cfg = _ref_tree()
    tree["layers"]["slot1"] = tree["layers"]["slot0"]
    with pytest.raises(ValueError, match="unused leaf"):
        params_from_jax(tree, cfg)


def test_params_from_jax_rejects_a_misshapen_leaf():
    tree, cfg = _ref_tree()
    tree["embed"] = tree["embed"][:, :32]
    with pytest.raises(ValueError, match="embed: shape"):
        params_from_jax(tree, cfg)
    tree, cfg = _ref_tree()
    tree["layers"]["slot0"]["ln1"]["scale"] = \
        tree["layers"]["slot0"]["ln1"]["scale"][:1]
    with pytest.raises(ValueError, match="n_layers"):
        params_from_jax(tree, cfg)


def test_params_from_jax_keeps_bfloat16_bits():
    ref, port = _pair("smollm_360m", True)
    ref = dataclasses.replace(ref, dtype="bfloat16")
    port = dataclasses.replace(port, dtype="bfloat16")
    tree = jax.tree.map(np.asarray, RM.build_model(ref).init_params(
        jax.random.key(0)))
    state = params_from_jax(tree, port)
    assert state["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        state["embed"].view(torch.int16).numpy(),
        tree["embed"].view(np.int16))
    np.testing.assert_array_equal(
        state["layers.1.ffn.w2.w"].float().numpy(),
        tree["layers"]["slot0"]["ffn"]["w2"]["w"][1].astype(np.float32))


# ----------------------------------------------------- unported, devices
UNPORTED_VARIANTS = {
    **{a: (a, {}) for a in UNPORTED},
    "gqa_grouped": ("smollm_360m", {"gqa_grouped": True}),
    "chunked": ("smollm_360m", {"attn_impl": "chunked"}),
}


@pytest.mark.parametrize("case", list(UNPORTED_VARIANTS))
def test_build_model_raises_for_what_is_not_ported(case):
    arch, change = UNPORTED_VARIANTS[case]
    cfg = dataclasses.replace(TC.get_config(arch, smoke=True), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(cfg, device="meta")


def test_model_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.get_config("smollm_360m", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises((RuntimeError, AssertionError)):
        build_model(cfg, device="cpu").to("cuda")
    assert build_model(cfg, device="cpu").embed.device.type == "cpu"
