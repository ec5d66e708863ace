"""jamba-1.5-large-398b: hybrid Mamba+attention 1:7 with MoE every other
layer (16 experts top-2).  Period of 8: layers 0-6 mamba, layer 7
attention; MoE on odd layers within the period (4 of 8), dense on even —
matches arXiv:2403.19887's interleave and the ~398B total / ~94B active
budget within rounding.
[arXiv:2403.19887; hf]  72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab=65536, head_dim=128,
    block_pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "mamba",
                   "mamba", "attn"),
    ffn_pattern=("dense", "moe", "dense", "moe", "dense", "moe", "dense",
                 "moe"),
    n_experts=16, top_k=2, d_state=16, d_conv=4, expand=2,
    norm="rms", act="swiglu", rope=True,
    source="arXiv:2403.19887",
)
SMOKE = CONFIG.smoke()
