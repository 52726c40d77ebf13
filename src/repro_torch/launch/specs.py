"""Serving inputs, the port's own copy.

Ports ``sample_prompts`` of ``repro/launch/specs.py`` on the port's
``data.synthetic.BigramLM``, so one seed gives the same prompts in both
packages.  The rest of the reference's ``specs.py`` is its JAX dry-run
contract and is not ported.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import BigramLM


def sample_prompts(cfg: ModelConfig, batch: int, prompt_len: int,
                   seed: int = 0):
    """Synthetic prompts matching the architecture's input contract:
    BigramLM token streams, stacked ``[B, S, n_codebooks]`` for codebook
    models, and the vision stub's patch tensor as the ``extra`` prefill
    input.  Returns ``(prompts int32, extra | None)``, both numpy."""
    src = BigramLM(cfg.vocab, seed)
    rng = np.random.default_rng(seed)
    if cfg.n_codebooks:
        prompts = np.stack([src.sample(rng, batch, prompt_len)
                            for _ in range(cfg.n_codebooks)], -1)
    else:
        prompts = src.sample(rng, batch, prompt_len)
    extra = None
    if cfg.vision_stub:
        extra = {"patches": rng.standard_normal(
            (batch, cfg.vision_patches, cfg.vision_d)).astype("float32")}
    return prompts.astype("int32"), extra
