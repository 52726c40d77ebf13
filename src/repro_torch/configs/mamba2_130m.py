"""Mamba2-130M [arXiv:2405.21060] — attention-free SSD (state-space duality)."""
from repro_torch.configs.base import ModelConfig, SSMConfig, _shrink

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,          # attention-free
    n_kv_heads=0,
    d_ff=0,             # no MLP; SSM mixer only (mamba block includes gating)
    vocab=50280,
    head_dim=64,
    pos_embed="none",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)


def reduced():
    return _shrink(CONFIG)
