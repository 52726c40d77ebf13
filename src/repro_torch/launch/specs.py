"""Serving inputs, the port's own copy.

Ports ``sample_prompts`` and ``request_queue`` of
``repro/launch/specs.py`` on the port's ``data.synthetic.BigramLM``, so
one seed gives the same prompts in both packages, and, for
context-parallel decode, :func:`cache_shard`, the counterpart of its
``cache_shardings`` under ``cp``.  The rest of the reference's
``specs.py`` is its JAX dry-run contract and is not ported.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import BigramLM
from repro_torch.sharding import spmd

#: the caches whose positions context-parallel decode splits: GQA's k/v
#: ``[B, S, KV, hd]``, MLA's c/kr ``[B, S, r]`` (an SSM state is whole)
CP_CACHE = ("k", "v", "c", "kr")


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


def request_queue(cfg: ModelConfig, lengths, max_new: int = 16,
                  seed: int = 0):
    """Variable-length :class:`repro_torch.launch.batching.Request` queue:
    one BigramLM draw at the longest length, trimmed per request (the
    continuous batcher's admission and retirement need ragged prompts).
    Plain token streams only: the slot-pool engine takes no ``extra``
    inputs."""
    from repro_torch.launch.batching import Request
    if cfg.n_codebooks or cfg.vision_stub:
        raise ValueError(
            "request_queue feeds the continuous-batching engine, which "
            "serves plain token prompts only (no codebook/vision extras)")
    lengths = list(lengths)
    prompts, _ = sample_prompts(cfg, len(lengths), max(lengths), seed=seed)
    return [Request(i, prompts[i, :n], max_new=max_new)
            for i, n in enumerate(lengths)]


def cache_shard(caches, mesh, axis="data"):
    """This rank's shard of full caches (``Model.prefill`` /
    ``init_cache``'s flat ``{path: [B, S, ...]}``) for context-parallel
    decode: the sequence dim of every ``k``/``v``/``c``/``kr`` cut into the
    mesh ``axis``'s contiguous blocks (``cp_rules``' ``cache_seq`` on
    ``data``), the rank keeping its own (a view); other caches whole."""
    n, idx = spmd.axis_size(mesh, axis), spmd.axis_index(mesh, axis)
    out = {}
    for path, x in caches.items():
        if path.rsplit("/", 1)[-1] in CP_CACHE:
            if x.shape[1] % n:
                raise ValueError(f"cache {path} holds {x.shape[1]} positions,"
                                 f" not a multiple of the {axis!r} axis's {n}")
            x = x.chunk(n, dim=1)[idx]
        out[path] = x
    return out
