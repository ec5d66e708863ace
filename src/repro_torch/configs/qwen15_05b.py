"""qwen1.5-0.5b: dense LM with QKV bias, MHA (kv=16).
[hf:Qwen/Qwen1.5-0.5B; hf]  24L d_model=1024 16H d_ff=2816 vocab=151936."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=2816,
    vocab=151936, head_dim=64, qkv_bias=True, norm="rms", act="swiglu",
    rope=True, source="hf:Qwen/Qwen1.5-0.5B",
)
SMOKE = CONFIG.smoke()
