"""MusicGen-large [arXiv:2306.05284] — decoder-only over EnCodec tokens.

Backbone only: 4 EnCodec codebook token streams (vocab 2048 each) are
sum-embedded; 4 parallel LM heads predict the next token of each codebook
(the delay pattern is the data pipeline's).  Sinusoidal positions as in
the paper.
"""
from repro_torch.configs.base import ModelConfig, _shrink

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    head_dim=64,
    pos_embed="sinusoidal",
    act="gelu",
    n_codebooks=4,
    source="arXiv:2306.05284",
)


def reduced():
    return _shrink(CONFIG)
