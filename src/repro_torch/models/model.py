"""Model assembly for the dense decoder family, as an ``nn.Module``.

The counterpart of the reference package's ``models/model.py`` for
``family="dense"`` configurations: token embedding, ``n_layers`` blocks
(norm, GQA attention, norm, dense FFN, each with a residual), a final norm
and a tied or untied head.  The parameters mirror the reference's param
tree with its stacked ``layers`` split per layer: ``embed``,
``final_norm``, ``head`` (untied only) and ``layers.<i>.{ln1, attn, ln2,
ffn}``; a weight is ``(d_in, d_out)`` as in the reference, so a
reference tree carries over leaf for leaf (``models/convert.py``).

Public surface (the reference's, with the params held by the module):
  build_model(cfg, seed=0, device=None) -> Model
  Model.forward(batch) -> logits;  Model.loss(batch)
  Model.init_cache(batch, cache_len)
  Model.serve_step(cache, batch) -> (logits, cache)   # cache updated in place
  Model.prefill(batch, cache_len=None) -> (last-token logits, cache)

The model runs on CUDA unless the caller names another device, and raises
without one; it is built in ``cfg.dtype`` (bfloat16 at full width, float32
for the ``SMOKE`` configs).  The families and variants not ported yet
raise ``NotImplementedError`` (ROADMAP §1); none runs a substitute path.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core.accel import resolve_device

from .config import ModelConfig
from .layers import apply_norm, attention, cross_entropy, ffn, linear

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a configuration the port cannot run yet."""
    missing = []
    if cfg.family != "dense":
        missing.append(f"family {cfg.family!r}")
    if set(cfg.block_pattern) != {"attn"}:
        missing.append(f"blocks {sorted(set(cfg.block_pattern))}")
    if set(cfg.ffn_pattern) != {"dense"}:
        missing.append(f"FFNs {sorted(set(cfg.ffn_pattern))}")
    if cfg.enc_dec or cfg.modality != "text":
        missing.append("encoder-decoder and multimodal frontends")
    if cfg.gqa_grouped:
        missing.append("gqa_grouped=True")
    if cfg.attn_impl != "naive":
        missing.append(f"attn_impl={cfg.attn_impl!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP §1); "
            f"the port builds the dense decoder only")


def _linear(d_in: int, d_out: int, bias: bool, **kw) -> nn.ParameterDict:
    p = nn.ParameterDict({"w": nn.Parameter(torch.empty(d_in, d_out, **kw))})
    if bias:
        p["b"] = nn.Parameter(torch.empty(d_out, **kw))
    return p


def _norm(d: int, kind: str, **kw) -> nn.ParameterDict:
    p = nn.ParameterDict({"scale": nn.Parameter(torch.empty(d, **kw))})
    if kind == "ln":
        p["bias"] = nn.Parameter(torch.empty(d, **kw))
    return p


def _block(cfg: ModelConfig, **kw) -> nn.ModuleDict:
    d, hd, f = cfg.d_model, cfg.hd, cfg.d_ff
    attn = nn.ModuleDict({
        "wq": _linear(d, cfg.n_heads * hd, cfg.qkv_bias, **kw),
        "wk": _linear(d, cfg.n_kv_heads * hd, cfg.qkv_bias, **kw),
        "wv": _linear(d, cfg.n_kv_heads * hd, cfg.qkv_bias, **kw),
        "wo": _linear(cfg.n_heads * hd, d, False, **kw)})
    if cfg.act == "swiglu":
        mlp = {"w1": _linear(d, f, False, **kw),
               "w3": _linear(d, f, False, **kw),
               "w2": _linear(f, d, False, **kw)}
    else:
        mlp = {"w1": _linear(d, f, True, **kw),
               "w2": _linear(f, d, True, **kw)}
    return nn.ModuleDict({"ln1": _norm(d, cfg.norm, **kw), "attn": attn,
                          "ln2": _norm(d, cfg.norm, **kw),
                          "ffn": nn.ModuleDict(mlp)})


class Model(nn.Module):
    """The dense decoder; parameters allocated, not initialised (see
    ``init_params`` and ``build_model``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        kw = {"dtype": DTYPES[cfg.dtype], "device": resolve_device(device)}
        self.embed = nn.Parameter(torch.empty(cfg.vocab_padded,
                                              cfg.d_model, **kw))
        self.final_norm = _norm(cfg.d_model, cfg.norm, **kw)
        if not cfg.tie_embeddings:
            self.head = _linear(cfg.d_model, cfg.vocab_padded, False, **kw)
        self.layers = nn.ModuleList(_block(cfg, **kw)
                                    for _ in range(cfg.n_layers))

    # ------------------------------------------------------------- params
    @torch.no_grad()
    def init_params(self, seed: int = 0) -> "Model":
        """The reference's distributions, drawn from a ``torch.Generator``
        seeded with ``seed``: weights N(0, 1/d_in), the embedding
        N(0, 0.02^2), drawn in float32 and cast to ``cfg.dtype``; biases
        and norm shifts 0, norm scales 1."""
        dev = self.embed.device
        gen = torch.Generator(device=dev).manual_seed(seed)

        def normal(t: torch.Tensor, std: float) -> None:
            t.copy_(torch.randn(t.shape, generator=gen, device=dev) * std)
        normal(self.embed, 0.02)
        for name, t in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "w":
                normal(t, 1.0 / math.sqrt(t.shape[0]))
            elif leaf == "scale":
                t.fill_(1.0)
            elif leaf in ("b", "bias"):
                t.zero_()
        return self

    # ------------------------------------------------------------ forward
    def _blocks(self, x, positions, cache=None, cache_pos=None):
        """The residual stream after every block (before the final
        norm); each layer's keys and values go into its cache rows."""
        cfg = self.cfg
        for i, lp in enumerate(self.layers):
            lc = None if cache is None else \
                {"k": cache["k"][i], "v": cache["v"][i]}
            h = apply_norm(lp["ln1"], x, cfg.norm)
            y, _ = attention(lp["attn"], h, cfg, positions=positions,
                             cache=lc, cache_pos=cache_pos)
            x = x + y
            h = apply_norm(lp["ln2"], x, cfg.norm)
            x = x + ffn(lp["ffn"], h, cfg)
        return x

    def _head_logits(self, x: torch.Tensor) -> torch.Tensor:
        x = apply_norm(self.final_norm, x, self.cfg.norm)
        if self.cfg.tie_embeddings:
            return x @ self.embed.T.to(x.dtype)
        return linear(self.head, x)

    def forward(self, batch: dict) -> torch.Tensor:
        tokens = batch["tokens"]
        x = self.embed[tokens]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        return self._head_logits(self._blocks(x, positions))

    def loss(self, batch: dict) -> torch.Tensor:
        logits = self.forward(batch)
        return cross_entropy(logits[:, :-1], batch["tokens"][:, 1:],
                             self.cfg.vocab)

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, cache_len: int) -> dict:
        """Zeroed K/V cache, ``{"k", "v"}`` of (n_layers, batch, cache_len,
        n_kv_heads, hd) in ``cfg.dtype`` on the model's device.  Callers
        pass min(seq, window) for rolling-ring decode or the full length
        for prefill plus windowed-mask decode."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.hd)
        kw = {"dtype": DTYPES[cfg.dtype], "device": self.embed.device}
        return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}

    @torch.no_grad()
    def serve_step(self, cache: dict, batch: dict):
        """One decode step.  batch: {"token": (B,1) int, "pos": int}, one
        position for every row.  The new keys and values are written into
        ``cache`` in place (at ``pos`` for every row); returns (logits
        (B,1,vocab_padded), cache)."""
        pos = int(batch["pos"])
        x = self.embed[batch["token"]]
        positions = torch.full((1,), pos, device=x.device)
        x = self._blocks(x, positions, cache, pos)
        return self._head_logits(x), cache

    @torch.no_grad()
    def prefill(self, batch: dict, cache_len: int | None = None):
        """Process a full prompt, returning (last-token logits, cache)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache_len = cache_len or s
        assert self.cfg.window is None or cache_len >= s, \
            "rolling-cache prefill not supported; decode token by token"
        cache = self.init_cache(b, cache_len)
        positions = torch.arange(s, device=tokens.device)
        x = self._blocks(self.embed[tokens], positions, cache, 0)
        return self._head_logits(x[:, -1:]), cache


def build_model(cfg: ModelConfig, seed: int = 0, device=None) -> Model:
    """A dense model on ``device`` (CUDA unless named; raises without
    one), its parameters drawn from ``seed``."""
    return Model(cfg, device).init_params(seed)
