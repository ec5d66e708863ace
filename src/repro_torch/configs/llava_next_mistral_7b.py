"""llava-next-mistral-7b: VLM — anyres tiling frontend is a STUB
(input_specs() provides precomputed patch embeddings); the backbone is
Mistral-7B with sliding-window attention (window 4096 -> sub-quadratic
long-context decode with a rolling KV ring).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]  32L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=32000."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm", modality="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, head_dim=128, norm="rms", act="swiglu", rope=True,
    window=4096, n_patches=2880,        # anyres: 5 tiles x 576 patches
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
SMOKE = CONFIG.smoke()
