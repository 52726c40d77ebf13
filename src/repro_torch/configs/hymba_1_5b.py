"""Hymba-1.5B [arXiv:2411.13676] — parallel attention + mamba heads per layer.

Each layer runs an attention branch (sliding-window GQA) and an SSM branch on
the same input; branch outputs are mean-fused after per-branch normalization,
as in the paper.  (Meta-tokens and the global/local layer mix are simplified
to uniform SWA layers, as in the reference's config.)
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, _shrink

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    head_dim=64,
    sliding_window=1024,
    hybrid=True,
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, conv_width=4, chunk=128),
    rope_theta=10_000.0,
    source="arXiv:2411.13676",
)


def reduced():
    return _shrink(CONFIG, n_heads=5, n_kv_heads=1, sliding_window=64)
