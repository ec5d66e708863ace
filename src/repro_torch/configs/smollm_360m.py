"""smollm-360m: llama-arch small dense LM.
[hf:HuggingFaceTB/SmolLM-360M; hf]  32L d_model=960 15H (GQA kv=5)
d_ff=2560 vocab=49152."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense", tie_embeddings=True,
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_ff=2560,
    vocab=49152, head_dim=64, norm="rms", act="swiglu", rope=True,
    source="hf:HuggingFaceTB/SmolLM-360M",
)
SMOKE = CONFIG.smoke()
