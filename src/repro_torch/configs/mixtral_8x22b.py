"""Mixtral-8x22B [arXiv:2401.04088] — 8 experts top-2, sliding-window attn."""
from repro_torch.configs.base import ModelConfig, MoEConfig, _shrink

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,             # == per-expert width; no dense layers
    vocab=32768,
    head_dim=128,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=16384, router="softmax"),
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088",
)


def reduced():
    return _shrink(CONFIG, sliding_window=64)
