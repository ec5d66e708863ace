"""phi3.5-moe-42b-a6.6b: MoE LM, 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]  32L d_model=4096 32H (GQA kv=8)
d_ff=6400 vocab=32064."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab=32064, head_dim=128, ffn_pattern=("moe",), n_experts=16,
    top_k=2, norm="ln", act="swiglu", rope=True,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
SMOKE = CONFIG.smoke()
