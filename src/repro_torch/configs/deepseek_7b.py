"""DeepSeek-7B [arXiv:2401.02954] — llama-arch dense, MHA kv=32."""
from repro_torch.configs.base import ModelConfig, _shrink

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    head_dim=128,
    rope_theta=10_000.0,
    source="arXiv:2401.02954",
)


def reduced():
    return _shrink(CONFIG)
