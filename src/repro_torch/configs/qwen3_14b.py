"""Qwen3-14B [hf:Qwen/Qwen3-8B family] — qk_norm, GQA kv=8."""
from repro_torch.configs.base import ModelConfig, _shrink

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
)


def reduced():
    return _shrink(CONFIG)
