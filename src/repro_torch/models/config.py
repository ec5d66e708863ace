"""Model configuration for the assigned architectures (a copy of the
reference package's ``models/config.py``).

A single ModelConfig describes decoder-only LMs (dense / MoE / hybrid /
SSM), the whisper encoder-decoder, and the llava VLM backbone.  Layer
heterogeneity (jamba's mamba:attn 1:7 interleave, xlstm's mLSTM/sLSTM
alternation, MoE every other layer) is expressed as a repeating *period*:
``block_pattern`` and ``ffn_pattern`` describe one period.  The port's
model (``models/model.py``) builds the ``dense`` family only; the
configuration and its parameter counts cover every family.
"""

from __future__ import annotations

import dataclasses
import math


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # block structure (one period; cycled over layers)
    block_pattern: tuple = ("attn",)          # attn | mamba | mlstm | slstm
    ffn_pattern: tuple = ("dense",)           # dense | moe | moe+dense | none

    # attention details
    head_dim: int | None = None
    qkv_bias: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    window: int | None = None                 # sliding-window attention

    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25

    # SSM (mamba)
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    # norms / activations
    norm: str = "rms"                         # rms | ln
    act: str = "swiglu"                       # swiglu | gelu

    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0

    # modality frontend stubs
    modality: str = "text"                    # text | audio | vlm
    n_patches: int = 0                        # vlm: image patch stub length

    # numerics / padding
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256
    tie_embeddings: bool = False

    # performance variants (§Perf; baseline = naive/False)
    attn_impl: str = "naive"        # naive | chunked (flash-style)
    gqa_grouped: bool = False       # grouped einsum, no KV-head repeat

    # bookkeeping
    family: str = "dense"                     # dense|moe|hybrid|ssm|audio|vlm
    source: str = ""

    def __post_init__(self):
        assert self.n_layers % len(self.block_pattern) == 0, \
            f"{self.name}: n_layers must be a multiple of the period"
        assert len(self.ffn_pattern) == len(self.block_pattern)

    # ------------------------------------------------------------- derived
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return round_up(self.vocab, self.vocab_pad_multiple)

    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, self.d_model // 16)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the 500k-token decode shape?  Per the brief:
        SSM / hybrid (attention is a small minority of layers) / windowed
        attention qualify; pure full-attention archs are skipped."""
        attn_layers = sum(b == "attn" for b in self.block_pattern)
        if self.enc_dec:
            return False
        if attn_layers == 0:
            return True
        if self.window is not None:
            return True
        return (self.family in ("ssm", "hybrid")
                and attn_layers * 4 <= len(self.block_pattern))

    @property
    def has_attention(self) -> bool:
        return any(b == "attn" for b in self.block_pattern) or self.enc_dec

    # --------------------------------------------------------- param count
    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, f, hd = self.d_model, self.d_ff, self.hd
        n_q, n_kv = self.n_heads, self.n_kv_heads
        total = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        if self.modality == "vlm":
            total += d * d                          # patch projector stub
        def attn_params():
            p = d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d
            if self.qkv_bias:
                p += n_q * hd + 2 * n_kv * hd
            return p
        def dense_ffn():
            if self.act == "swiglu":
                return 3 * d * f
            return 2 * d * f
        def moe_ffn():
            per = 3 * d * f if self.act == "swiglu" else 2 * d * f
            return self.n_experts * per + d * self.n_experts
        def mamba_params():
            di = self.d_inner
            return (d * 2 * di + di * self.d_conv
                    + di * (self.dt_rank + 2 * self.d_state)
                    + self.dt_rank * di + di * self.d_state + di + di * d)
        def lstm_params(kind):
            di = d
            if kind == "mlstm":
                return d * 3 * n_q * hd + 2 * d * n_q + d * n_q * hd \
                    + n_q * hd * d
            return 4 * (d * d + d) + d * d
        for b, fk in zip(self.block_pattern, self.ffn_pattern):
            per_layer = 0
            if b == "attn":
                per_layer += attn_params()
            elif b == "mamba":
                per_layer += mamba_params()
            elif b == "mlstm":
                per_layer += lstm_params("mlstm")
            elif b == "slstm":
                per_layer += lstm_params("slstm")
            if fk == "dense":
                per_layer += dense_ffn()
            elif fk == "moe":
                per_layer += moe_ffn()
            elif fk == "moe+dense":
                per_layer += moe_ffn() + dense_ffn()
            total += per_layer * self.n_periods
        if self.enc_dec:
            # encoder self-attn + ffn, decoder cross-attn already in blocks
            total += self.n_enc_layers * (attn_params() + dense_ffn())
            total += self.n_layers * attn_params()      # cross attention
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        per = 3 * d * f if self.act == "swiglu" else 2 * d * f
        inactive = 0
        for fk in self.ffn_pattern:
            if fk in ("moe", "moe+dense"):
                inactive += (self.n_experts - self.top_k) * per
        return self.param_count() - inactive * self.n_periods

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(self.period, 2 * self.period if self.period == 1
                         else self.period),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads
            < self.n_heads else 4,
            d_ff=128 if self.d_ff else 0,
            head_dim=16,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            n_enc_layers=min(self.n_enc_layers, 2),
            n_patches=min(self.n_patches, 8),
            vocab_pad_multiple=64,
            dtype="float32",
        )
