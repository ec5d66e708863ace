"""Core layers of the dense decoder: linear, norms, RoPE, GQA attention
(cached / windowed), the dense FFN and the loss, in plain PyTorch.

The counterpart of the reference package's ``models/layers.py`` for the
``dense`` family, with its casts at the same points: norms and RoPE in
float32 cast back to the activation dtype, attention logits and softmax in
float32, the softmax weights cast to the value dtype before the second
product.  Params are nested mappings shaped like the reference's param
tree (``p["wq"]["w"]`` is ``(d_in, d_out)``, ``"b" in p`` marks a bias), so
each function takes either plain dicts of tensors or the model's
``ModuleDict``/``ParameterDict`` tree.  The reference's sharding context is
a no-op on one device and is dropped.  MoE, the grouped and chunked
attention variants and cross attention are not ported (ROADMAP §1).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# masked logits, as in the reference
NEG_INF = -1e30


def linear(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ------------------------------------------------------------------- norms
def apply_norm(p, x: torch.Tensor, kind: str = "rms",
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if kind == "rms":
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float()
    if kind == "ln":
        y = y + p["bias"].float()
    return y.to(x.dtype)


# -------------------------------------------------------------------- rope
def rope_angles(positions: torch.Tensor, hd: int, theta: float = 10000.0):
    """positions (...,) -> (cos, sin) of shape (..., hd//2)."""
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=positions.device) / hd))
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B,S,H,hd); cos/sin (B,S,hd//2) or (S,hd//2)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------- attention
def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, kh, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, n_rep, hd).reshape(
        b, s, kh * n_rep, hd)


def _sdpa(q, k, v, mask):
    """q (B,Sq,H,hd), k/v (B,Sk,H,hd), mask broadcastable (B,1,Sq,Sk)."""
    hd = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) / math.sqrt(hd)
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def attention(p, x: torch.Tensor, cfg, *, causal: bool = True,
              positions: torch.Tensor | None = None, cache=None,
              cache_pos: int | None = None):
    """GQA self-attention.

    Decode: ``cache`` dict(k, v) of (B, S_cache, K, hd) views; the new
    keys and values are written in place at ``cache_pos`` (the rolling slot
    for a sliding-window cache of ``cfg.window`` rows; keys are rope'd at
    write time with absolute positions), for every batch row, as the
    reference's ``dynamic_update_slice`` at ``(0, slot, 0, 0)`` writes
    them, its start clamped so that the rows fit.  The query then attends
    over the valid prefix.  Returns (out, cache)."""
    b, s, _ = x.shape
    hd, nh, nkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = linear(p["wq"], x).reshape(b, s, nh, hd)
    k = linear(p["wk"], x).reshape(b, -1, nkv, hd)
    v = linear(p["wv"], x).reshape(b, -1, nkv, hd)

    if positions is None:
        positions = torch.arange(s, device=x.device)
    if cfg.rope:
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if cache is not None:
        s_cache = cache["k"].shape[1]
        rolling = cfg.window is not None and s_cache == cfg.window
        if rolling:
            assert s == 1, "rolling-window cache supports single-token decode"
            slot = cache_pos % s_cache
        else:
            slot = cache_pos
        start = min(max(int(slot), 0), s_cache - s)
        cache["k"][:, start:start + s] = k.to(cache["k"].dtype)
        cache["v"][:, start:start + s] = v.to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
        idx = torch.arange(s_cache, device=x.device)
        if rolling:
            # all slots valid once the ring has wrapped
            valid = ((idx <= cache_pos) | (cache_pos >= s_cache - 1))[None]
            mask = valid[None, None, :, :]
        else:
            # positions are the absolute query positions (s of them,
            # starting at cache_pos): multi-token prefill too
            valid = idx[None, :] <= positions[:, None]
            if cfg.window is not None:
                valid &= (positions[:, None] - idx[None, :]) < cfg.window
            mask = valid[None, None, :, :]
    else:
        ki = torch.arange(k.shape[1], device=x.device)[None, :]
        qi = positions[:, None]
        if causal:
            m = ki <= qi
            if cfg.window is not None:
                m = m & (qi - ki < cfg.window)
        else:
            m = torch.ones((s, k.shape[1]), dtype=torch.bool,
                           device=x.device)
        mask = m[None, None, :, :]

    n_rep = nh // nkv
    out = _sdpa(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep), mask)
    return linear(p["wo"], out.reshape(b, s, nh * hd)), cache


# --------------------------------------------------------------- dense FFN
def ffn(p, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.act == "swiglu":
        h = F.silu(linear(p["w1"], x)) * linear(p["w3"], x)
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(linear(p["w1"], x), approximate="tanh")
    return linear(p["w2"], h)


# ------------------------------------------------------------------- loss
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_real: int) -> torch.Tensor:
    """logits (B,S,Vp); labels (B,S) with -1 = ignore.  Padded vocab
    columns are masked out of the softmax."""
    vp = logits.shape[-1]
    if vp > vocab_real:
        col = torch.arange(vp, device=logits.device)
        logits = logits.masked_fill(col[None, None, :] >= vocab_real,
                                    NEG_INF)
    logits = logits.float()
    mask = labels >= 0
    safe = torch.where(mask, labels, 0)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = torch.where(mask, lse - gold, 0.0)
    return nll.sum() / mask.sum().clamp(min=1)
