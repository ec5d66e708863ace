"""xlstm-125m: pure recurrent LM — alternating mLSTM / sLSTM blocks (1:1),
no separate FFN (d_ff=0; the cells carry their own projections).
[arXiv:2405.04517; unverified]  12L d_model=768 4H vocab=50304."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, head_dim=192,
    block_pattern=("mlstm", "slstm"),
    ffn_pattern=("none", "none"),
    norm="ln", act="gelu", rope=False,
    source="arXiv:2405.04517",
)
SMOKE = CONFIG.smoke()
