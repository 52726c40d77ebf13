"""What the mesh round's parity tests run in each rank (and in the test
process itself, for the single-process rounds and a world of one).

The ranks are new processes (``repro_torch.launch.mesh.spawn``), so the
functions here must be importable without the test module, which loads
JAX: this module imports torch and the port only.  Inputs come as numpy
arrays (the reference's params and batches, its window offsets as lists)
and results go back as CPU tensors.
"""
from dataclasses import replace

import torch
import torch.distributed as dist

from repro_torch import api, convert
from repro_torch.configs.base import SubmodelConfig, get_reduced_config
from repro_torch.launch.mesh import host_mesh
from repro_torch.launch.specs import cache_shard, sample_prompts
from repro_torch.models import build_model
from repro_torch.models.attention import cp_decode_attention
from repro_torch.sharding import spmd

ROUNDS = 2
LM = dict(scheme="rolling", capacity=0.5, local_steps=2,
          clients_per_round=4, client_lr=0.1)
LSQ = dict(capacity=0.5, local_steps=2, clients_per_round=4, client_lr=0.3)
#: name -> (model, SubmodelConfig fields, fed_round keywords): the
#: reference's ``tests/test_mesh.py`` configurations
CASES = {
    "lm_rolling_fused": ("lm", LM, dict(fused_forward="on")),
    "lm_stagger_fused": ("lm", dict(LM, stagger=True),
                         dict(fused_forward="on")),
    "lm_stagger_extract": ("lm", dict(LM, stagger=True),
                           dict(fused_forward="off")),
    "lm_rolling_adam": ("lm", LM, dict(server_opt="adam")),
    "lsq_rolling": ("lsq", dict(LSQ, scheme="rolling"), {}),
    "lsq_stagger": ("lsq", dict(LSQ, scheme="rolling", stagger=True), {}),
    "lsq_full": ("lsq", dict(LSQ, scheme="full"), {}),
}
#: the reduced architectures decoded context-parallel; prompt and steps
DECODE_ARCHS = ("tinyllama_1_1b", "deepseek_v3_671b")
PROMPT, STEPS, ROWS = 24, 8, 2


def tiny_config():
    """``tests/test_mesh.py``'s tiny TinyLlama."""
    return replace(get_reduced_config("tinyllama_1_1b"), n_layers=2,
                   vocab=64, d_model=64, d_ff=128, n_heads=4, n_kv_heads=2,
                   head_dim=16)


def lsq_loss(w, batch):
    """The reference test's least-squares loss, per client (``[C]``): no
    ``window=``, so its rounds take the extract client phase."""
    r = w["w"] - batch["target"].mean(-1, keepdim=True)
    return 0.5 * (r * r).mean(-1), {}


def _model(kind):
    if kind == "lm":
        return build_model(tiny_config())
    return lsq_loss, {"w": torch.Size([8])}, {"w": ("d_ff",)}


def run_case(name, inputs, mesh=None, agg="gather", rounds=ROUNDS):
    """``rounds`` rounds of case ``name`` from ``inputs[kind]`` (``params``
    in the reference's layout, ``batches``) with ``inputs["offsets"]
    [name]`` injected: after each round the params, the client losses and
    the server Adam state (None without a server optimizer)."""
    kind, scfg, kw = CASES[name]
    fed = api.fed_round(_model(kind), SubmodelConfig(**scfg), mesh=mesh,
                        mesh_agg=agg, device="cpu", **kw)
    params = convert.from_reference(inputs[kind]["params"], device="cpu")
    state = fed.server_opt.init(params) if fed.server_opt else None
    after, losses, states = [], [], []
    for r in range(rounds):
        batch = {k: torch.as_tensor(v) for k, v in
                 inputs[kind]["batches"][r].items()}
        batch = {k: v.long() if not v.is_floating_point() else v
                 for k, v in batch.items()}
        off = inputs["offsets"][name][r]
        if state is None:
            params, m = fed.round(params, batch, r, offsets=off)
        else:
            params, state, m = fed.round_with_server_opt(
                params, state, batch, r, offsets=off)
        after.append({k: v.clone() for k, v in params.items()})
        losses.append(m["client_loss"].clone())
        states.append(None if state is None else dict(
            t=state["t"], **{part: {k: v.clone() for k, v in
                                    state[part].items()}
                             for part in ("m", "v")}))
    return dict(params=after, losses=losses, states=states)


def _same_on_every_rank(params):
    """Whether every rank of the world holds these params, bit for bit."""
    flat = torch.cat([v.reshape(-1) for v in params.values()])
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, flat)
    return all(torch.equal(parts[0], p) for p in parts)


def decode(arch, mesh=None):
    """Teacher-forced decode of ``STEPS`` tokens after a ``PROMPT``-token
    prefill of reduced ``arch`` (random weights from seed 0): the logits
    ``[STEPS, ROWS, V]``; with a mesh, context-parallel from this rank's
    shard of the caches."""
    cfg = get_reduced_config(arch)
    model = build_model(cfg, moe_path="dense")
    params = model.init(0, device="cpu")
    prompts, _ = sample_prompts(cfg, ROWS, PROMPT + STEPS, seed=0)
    tokens = torch.as_tensor(prompts, dtype=torch.long)
    out = []
    with torch.no_grad():
        _, caches = model.prefill(params, tokens[:, :PROMPT],
                                  max_len=PROMPT + STEPS)
        if mesh is not None:
            caches = cache_shard(caches, mesh)
        for i in range(STEPS):
            logits, caches = model.decode_step(
                params, tokens[:, PROMPT + i], caches, PROMPT + i, mesh=mesh,
                cp=mesh is not None)
            out.append(logits)
    return torch.stack(out)


def cp_attention(mesh, attn):
    """``cp_decode_attention`` on this rank's block of ``attn``'s k, v and
    valid (numpy, whole)."""
    n, i = spmd.axis_size(mesh, "data"), spmd.axis_index(mesh, "data")
    k, v, valid = (torch.as_tensor(attn[x]).chunk(n, 1)[i]
                   for x in ("k", "v", "valid"))
    return cp_decode_attention(mesh, torch.as_tensor(attn["q"]), k, v, valid)


def run_world(inputs, attn, spec=None):
    """Everything a mesh of the world's ranks checks, on every rank: each
    case's gather round and (but the extract case) psum round, whether
    every rank ends them with the same params, context-parallel attention
    and decode; in a world of 4 also a 2 x 2 mesh's gather round.  The
    gather rounds run ``ROUNDS`` rounds; psum, which
    reassociates the server's sums, one (its later rounds start from other
    params).  ``spec``: the mesh (``--mesh`` form; None: every rank on
    ``data``).  Rank 0's results are what the caller sees."""
    mesh = host_mesh(spec or str(dist.get_world_size()))
    out = {"rounds": {}, "same": {}}
    for name in CASES:
        for agg in (("gather",) if name == "lm_stagger_extract"
                    else ("gather", "psum")):
            got = run_case(name, inputs, mesh, agg,
                           ROUNDS if agg == "gather" else 1)
            out["same"][name, agg] = _same_on_every_rank(got["params"][-1])
            out["rounds"][name, agg] = got
    if dist.get_world_size() == 4:
        # ranks along "model" train the same clients
        out["model_axis"] = run_case("lm_stagger_fused", inputs,
                                     host_mesh("2x2"))
    out["cp_attention"] = cp_attention(mesh, attn)
    out["decode"] = {arch: decode(arch, mesh) for arch in DECODE_ARCHS}
    return out
