"""Phi-3-vision 4.2B [hf:microsoft/Phi-3-vision-128k-instruct].

Backbone = phi3-mini decoder (MHA kv=32).  The CLIP ViT vision encoder is a
stub: the batch carries precomputed patch embeddings ``[B, P, vision_d]``;
a learned 2-layer projector maps them into d_model and they are prepended
to the text token embeddings.
"""
from repro_torch.configs.base import ModelConfig, _shrink

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    head_dim=96,
    rope_theta=10_000.0,
    vision_stub=True,
    vision_d=1024,
    vision_patches=256,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)


def reduced():
    return _shrink(CONFIG)
