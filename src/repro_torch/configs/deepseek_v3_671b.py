"""DeepSeek-V3 671B [arXiv:2412.19437] — MLA, 1 shared + 256 routed top-8, MTP."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, _shrink

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,          # MLA: kv heads == q heads post-decompression
    d_ff=18432,              # dense-layer FFN width (first 3 layers)
    vocab=129280,
    head_dim=128,
    qk_norm=False,
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=256, top_k=8, d_ff=2048, n_shared=1,
                  router="sigmoid"),
    n_dense_layers=3,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    mtp=True,
    source="arXiv:2412.19437",
)


def reduced():
    return _shrink(CONFIG, mtp=True)
