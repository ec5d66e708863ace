"""qwen2-0.5b: dense LM, aggressive GQA (kv=2), QKV bias.
[arXiv:2407.10671; hf]  24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense", tie_embeddings=True,
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab=151936, head_dim=64, qkv_bias=True, norm="rms", act="swiglu",
    rope=True, source="arXiv:2407.10671",
)
SMOKE = CONFIG.smoke()
