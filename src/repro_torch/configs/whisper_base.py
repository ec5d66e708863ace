"""whisper-base: encoder-decoder ASR backbone; conv frontend is a STUB —
input_specs() provides precomputed frame embeddings (B, S, 512).
[arXiv:2212.04356; unverified]  6L enc + 6L dec, d_model=512 8H d_ff=2048
vocab=51865 (padded to 51968 for 16-way TP)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio", modality="audio", tie_embeddings=True,
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab=51865, head_dim=64, norm="ln", act="gelu", rope=False,
    enc_dec=True, n_enc_layers=6,
    source="arXiv:2212.04356",
)
SMOKE = CONFIG.smoke()
