"""Dry-run plans and serving inputs, the port's own copy.

Ports ``DryrunPlan``, ``TRAIN_CAPACITY``, ``K_LOCAL``, ``data_axes``,
``submodel_config``, ``batch_spec``, ``serve_batch`` and ``make_plan``
(the dry-run contract, with the reference's ``remat=True``), and
``sample_prompts`` and ``request_queue`` of ``repro/launch/specs.py``
(the latter on the port's ``data.synthetic.BigramLM``, so one seed gives
the same prompts in both packages), and, for context-parallel decode,
:func:`cache_shard`, the counterpart of its ``cache_shardings`` under
``cp``.  :func:`run_plan` plans one ``RunConfig``.

A plan is built on ``meta``: params from ``Model.init(device="meta")``,
batches and caches as meta tensors of the reference's layouts and dtypes.
Nothing is allocated.  ``world`` is the number of ``torch.distributed``
ranks the mesh round splits the clients over (clients only: a rank holds
whole params), and a plan is one rank's share: ``C / world`` clients a
round through the mesh round's collectives (on meta, ``sharding.spmd``
returns their shapes and reports their bytes); ``long_500k``'s decode
holds ``S / world`` cache positions (:func:`cache_shard`); the other
serving shapes hold ``global_batch / world`` sequences, a replica's share.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import (INPUT_SHAPES, ModelConfig, RunConfig,
                                      ShapeConfig, SubmodelConfig,
                                      get_config)
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


# -- the dry-run contract ------------------------------------------------------


@dataclasses.dataclass
class DryrunPlan:
    arch: str
    shape: ShapeConfig
    cfg: ModelConfig
    model: Any
    scfg: SubmodelConfig
    multi_pod: bool
    world: int                     # ranks the clients (cache) split over
    mesh: Any                      # PlanMesh (world > 1) or None
    kind: str                      # train | prefill | decode
    cp: bool                       # context-parallel decode (long_500k)
    abstract_args: Tuple           # meta tensors for the step fn
    param_dtype: torch.dtype
    mesh_agg: str = "gather"
    client_opt: Any = None         # the round's client optimizer
    server_opt: Any = None         # its server optimizer (state in args)


# per-arch client capacity for the production fed round (memory-driven)
TRAIN_CAPACITY = {
    "deepseek_v3_671b": 0.25,
    "mixtral_8x22b": 0.25,
    "qwen3_32b": 0.5,
    "qwen3_14b": 0.5,
    "musicgen_large": 0.5,
    "deepseek_7b": 0.5,
    "phi_3_vision_4_2b": 0.5,
    "tinyllama_1_1b": 0.5,
    "mamba2_130m": 0.5,
    "hymba_1_5b": 0.5,
}

K_LOCAL = 2  # local steps per round in the production fed round


def data_axes(multi_pod):
    return ("pod", "data") if multi_pod else ("data",)


def submodel_config(arch: str, multi_pod: bool) -> SubmodelConfig:
    clients = 32 if multi_pod else 16
    return SubmodelConfig(
        scheme="rolling",
        capacity=TRAIN_CAPACITY.get(arch, 0.5),
        local_steps=K_LOCAL,
        clients_per_round=clients,
        client_lr=0.05,
        align=128 if arch != "hymba_1_5b" else 1,   # 25 heads / 5 kv
    )


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_spec(cfg: ModelConfig, shape: ShapeConfig, scfg: SubmodelConfig,
               multi_pod: bool):
    """Training batch meta tensors, layout ``[K, C, mb, ...]``: int32
    tokens (``[..., S, n_codebooks]`` for codebook models, ``S - patches``
    for the vision stub) and bf16 patches."""
    C = scfg.clients_per_round
    mb = max(shape.global_batch // C, 1)
    S = shape.seq_len
    P_ = cfg.vision_patches if cfg.vision_stub else 0
    toks = (S - P_) if cfg.vision_stub else S
    lead = (scfg.local_steps, C, mb)
    batch = {}
    if cfg.n_codebooks:
        batch["tokens"] = _meta(lead + (toks, cfg.n_codebooks), torch.int32)
    else:
        batch["tokens"] = _meta(lead + (toks,), torch.int32)
    if cfg.vision_stub:
        batch["patches"] = _meta(lead + (P_, cfg.vision_d), torch.bfloat16)
    return batch


def serve_batch(cfg: ModelConfig, shape: ShapeConfig, batch=None):
    """Serving inputs as meta tensors: a prefill's prompt (``[B, S -
    patches]`` int32, ``[B, S, n_codebooks]``, bf16 patches) or a decode
    step's one token a sequence.  ``batch`` overrides the shape's
    ``global_batch`` (a rank's share)."""
    B, S = shape.global_batch if batch is None else batch, shape.seq_len
    if shape.kind == "prefill":
        P_ = cfg.vision_patches if cfg.vision_stub else 0
        out = {}
        if cfg.n_codebooks:
            out["tokens"] = _meta((B, S, cfg.n_codebooks), torch.int32)
        else:
            out["tokens"] = _meta((B, S - P_), torch.int32)
        if cfg.vision_stub:
            out["patches"] = _meta((B, P_, cfg.vision_d), torch.bfloat16)
        return out
    if cfg.n_codebooks:
        return {"tokens": _meta((B, cfg.n_codebooks), torch.int32)}
    return {"tokens": _meta((B,), torch.int32)}


class PlanMesh:
    """A one-axis mesh of ``world`` ranks for a plan on meta: the names
    and sizes ``sharding.spmd`` reads, rank 0's coordinates, no process
    group (its collectives take their meta route)."""

    def __init__(self, world: int, axis: str = "data"):
        self.axis_names = (axis,)
        self.shape = {axis: int(world)}

    def get_local_rank(self, axis):
        return 0

    def get_group(self, axis):
        raise RuntimeError("a plan's mesh has no process group")


def make_plan(arch: str, shape, *, world: Optional[int] = None,
              multi_pod: bool = False, capacity: Optional[float] = None,
              scheme: str = "rolling", k_local: Optional[int] = None,
              param_dtype=torch.float32, cfg: Optional[ModelConfig] = None,
              scfg: Optional[SubmodelConfig] = None,
              mesh_agg: str = "gather", client_opt=None, server_opt=None,
              remat: bool = True) -> DryrunPlan:
    """One rank's share of ``arch`` at input ``shape`` (a name of
    ``INPUT_SHAPES`` or a ``ShapeConfig``) on meta.  ``world`` defaults to
    one client a rank (``submodel_config``'s 16, or 32 with
    ``multi_pod``); ``cfg`` and ``scfg`` replace the architecture's config
    and the production sub-model plan (e.g. a depth cut, the chip smoke's
    round); ``client_opt`` and ``server_opt`` are ``api.fed_round``'s (a
    train plan with a server optimizer takes its state as an argument, as
    a ``Trainer`` holds it from the first round on); ``remat`` the model's
    (``Model.remat``: a train plan recomputes each layer's forward in the
    backward), on by default as in the reference."""
    cfg = cfg or get_config(arch)
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    from repro_torch.models import build_model
    model = build_model(cfg, param_dtype=param_dtype, remat=remat)
    world = int(world or submodel_config(arch, multi_pod).clients_per_round)
    scfg = scfg or submodel_config(arch, multi_pod)
    if capacity is not None:
        scfg = dataclasses.replace(scfg, capacity=capacity)
    if scheme != "rolling":
        scfg = dataclasses.replace(scfg, scheme=scheme)
    if k_local:
        scfg = dataclasses.replace(scfg, local_steps=k_local)
    cp = shape.name == "long_500k"
    mesh = PlanMesh(world) if world > 1 else None
    params = model.init(device="meta")
    if shape.kind == "train":
        if scfg.clients_per_round % world:
            raise ValueError(f"{scfg.clients_per_round} clients do not split "
                             f"over {world} ranks")
        args = (params, batch_spec(cfg, shape, scfg, multi_pod))
        if server_opt is not None:
            from repro_torch import api
            opt = api._resolve_server_opt(server_opt, scfg)
            args = (params, opt.init(params), args[1])
        kind = "train"
    elif shape.kind == "prefill" or not cp:
        share = max(shape.global_batch // world, 1)
        args = (params, serve_batch(cfg, shape, batch=share))
        kind = shape.kind
        if kind == "decode":
            cache = model.init_cache(share, shape.seq_len, param_dtype,
                                     device="meta")
            args = args + (cache, shape.seq_len - 1)
    else:
        batch = serve_batch(cfg, shape)
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 param_dtype, device="meta")
        if mesh is not None:     # this rank's positions, their own storage
            cache = {k: v.clone() for k, v in cache_shard(cache,
                                                         mesh).items()}
        args = (params, batch, cache, shape.seq_len - 1)
        kind = "decode"
    return DryrunPlan(arch=arch, shape=shape, cfg=cfg, model=model,
                      scfg=scfg, multi_pod=multi_pod, world=world, mesh=mesh,
                      kind=kind, cp=cp and mesh is not None,
                      abstract_args=args, param_dtype=param_dtype,
                      mesh_agg=mesh_agg, client_opt=client_opt,
                      server_opt=server_opt)


#: ``RunConfig.dtype`` -> the params' torch dtype
RUN_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def run_plan(run: RunConfig, **kw) -> DryrunPlan:
    """:func:`make_plan` of one :class:`RunConfig`: its architecture,
    shape, sub-model plan, params' dtype, ``remat`` and ``multi_pod``
    (``fsdp`` has no effect in the port); ``kw`` go to ``make_plan``."""
    return make_plan(run.arch, run.shape, multi_pod=run.multi_pod,
                     scfg=run.submodel, param_dtype=RUN_DTYPES[run.dtype],
                     remat=run.remat, **kw)
