"""arctic-480b: Dense-MoE hybrid — 128 experts top-2 IN PARALLEL with a
dense residual FFN per layer (Snowflake Arctic architecture).
[hf:Snowflake/snowflake-arctic-base; hf]  35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab=32000, head_dim=128, ffn_pattern=("moe+dense",), n_experts=128,
    top_k=2, norm="rms", act="swiglu", rope=True,
    source="hf:Snowflake/snowflake-arctic-base",
)
SMOKE = CONFIG.smoke()
