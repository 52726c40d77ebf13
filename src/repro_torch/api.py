"""repro_torch.api — the port's public entry surface.

Ports ``MODES``, ``resolve_mode``, ``_resolve_server_opt``, ``fed_round``
(window mode with one shared window, per-client windows or none, through
the fused or the extract client phase, heterogeneous capacities, and mask
mode; client and server optimizers, the bf16 uplink), ``Trainer``,
``checkpoint_callback`` and ``AsyncTrainer`` of ``repro/api.py`` (the mesh
round too: ``mesh=``, ``spmd_axis=``, ``mesh_agg=``), with its
re-exports of ``output_model``, ``run_rounds``, the optimizers and the
fleet (the same ``__all__``)::

    from repro_torch import api
    from repro_torch.configs.base import SubmodelConfig, get_config
    from repro_torch.models import build_model

    model = build_model(get_config("tinyllama_1_1b"))
    params = model.init(seed=0)                       # on the card
    scfg = SubmodelConfig(scheme="rolling", capacity=0.5, local_steps=2,
                          clients_per_round=4, client_lr=0.1,
                          axes=("d_ff", "heads", "kv_heads"))
    fed = api.fed_round(model, scfg)                  # window mode
    params, history = api.Trainer(fed, params).run(batches, 3)

    # Algorithm 1: unstructured Bernoulli masks resolve to mask mode
    fed = api.fed_round(model, SubmodelConfig(scheme="bernoulli", ...))
    params, history = api.Trainer(fed, params, rng=0).run(batches, 3)

    # Algorithm 2 as written: compact per-client copies (the extract phase)
    fed = api.fed_round(model, scfg, fused_forward="off")
    # the FedAvg baseline: every client trains a full replica
    fed = api.fed_round(model, SubmodelConfig(scheme="full", ...))

    # per-client windows (staggered rolling; also "random", "importance"),
    # client momentum, FedAdam on the server, a bf16 uplink
    fed = api.fed_round(model, SubmodelConfig(stagger=True, ...),
                        client_opt="momentum", server_opt="adam",
                        uplink_compression="bf16")
    params, history = api.Trainer(fed, params).run(batches, 3)

    # the mesh round: each torch.distributed rank trains its block of the
    # clients (torchrun --nproc-per-node 4, NCCL; or launch.mesh.spawn on
    # the CPU), the changes gathered back in client order
    from repro_torch.launch.mesh import host_mesh, init_world
    init_world("cuda")          # torchrun's world, or a world of one
    fed = api.fed_round(model, scfg, mesh=host_mesh("4"))

    # heterogeneous capacities: one homogeneous bucket round per width
    fed = api.fed_round(model, scfg, capacities=[1.0, 0.5, 0.5, 0.25])

    # the asynchronous fleet: 8 clients, a quarter of them 10x slower,
    # 4 in flight, aggregating every 2 reports
    fleet = api.FleetSimulator(8, api.LatencyModel(straggler_frac=0.25))
    params, history = api.AsyncTrainer(fed, params, buffer_size=2,
                                       fleet=fleet).run(batches, 3)

    # held-out loss each round, logged, with a checkpoint (reference layout)
    trainer = api.Trainer(
        fed, params, eval_every=1, log_every=1,
        eval_fn=lambda p: {"eval": model.loss(p, eval_batch)[0]},
        callbacks=[api.checkpoint_callback("ckpt.npz")])

Everything runs on the card (``device="cuda"``) unless the caller passes
``device="cpu"``, which runs the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import inspect
from typing import Any, Optional, Tuple

import numpy as np

from repro_torch.configs.base import SubmodelConfig
from repro_torch.core.fedavg import (MESH_AGGS, CapacityBucket, MaskFedAvg,
                                     WindowFedAvg, build_mask_fed,
                                     build_window_fed, output_model,
                                     run_rounds)
from repro_torch.core.server_opt import SERVER_OPTS, ServerOpt
from repro_torch.core.trainer import Trainer, checkpoint_callback
from repro_torch.device import resolve_device
from repro_torch.fleet import (SERVER_LR_SCHEDULES, STALENESS_POLICIES,
                               AsyncTrainer, EpochPermutationSampler,
                               FleetSimulator, LatencyModel)
from repro_torch.optim.client import (CLIENT_OPTS, ClientOpt,
                                      client_momentum, client_proximal,
                                      client_sgd, resolve_client_opt)
from repro_torch.sharding.spmd import axis_size, resolve_client_axis

__all__ = ["fed_round", "Trainer", "checkpoint_callback", "output_model",
           "run_rounds", "WindowFedAvg",
           "MaskFedAvg", "CapacityBucket", "MODES", "resolve_mode",
           "ClientOpt", "CLIENT_OPTS", "client_sgd", "client_momentum",
           "client_proximal", "ServerOpt", "SERVER_OPTS", "AsyncTrainer",
           "FleetSimulator", "LatencyModel", "EpochPermutationSampler",
           "STALENESS_POLICIES", "SERVER_LR_SCHEDULES"]

MODES = ("auto", "window", "mask")


def resolve_mode(mode: str, scheme: str) -> str:
    """``auto`` -> ``mask`` for unstructured Bernoulli masks, else
    ``window``."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if mode == "auto":
        return "mask" if scheme == "bernoulli" else "window"
    if mode == "window" and scheme == "bernoulli":
        raise ValueError(
            "scheme 'bernoulli' (unstructured Algorithm-1 masks) has no "
            "compact window form; use mode='mask' or 'auto'")
    return mode


def _model_parts(model) -> Tuple[Any, Any, Any]:
    if all(hasattr(model, a) for a in ("loss", "abstract_params", "axes")):
        return model.loss, model.abstract_params(), model.axes()
    if isinstance(model, (tuple, list)) and len(model) == 3:
        return tuple(model)
    raise TypeError(
        "model must expose the model-zoo protocol (.loss, "
        ".abstract_params(), .axes()) or be a (loss_fn, abstract, "
        f"axes_tree) triple; got {type(model).__name__}")


def _windowed_loss(loss_fn):
    """``loss_fn`` itself when it is window-aware (accepts a ``window=``
    kwarg, like ``Model.loss``), else None: the fused client phase is only
    offered where it exists, and the round takes the extract phase."""
    try:
        if "window" in inspect.signature(loss_fn).parameters:
            return loss_fn
    except (TypeError, ValueError):
        pass
    return None


def _resolve_server_opt(server_opt, scfg: SubmodelConfig
                        ) -> Optional[ServerOpt]:
    """None or ``"none"``/``""`` -> None (the paper's plain average); a
    registry name -> ``sgd``/``momentum`` at ``lr=scfg.server_lr`` (so
    ``"sgd"`` is the paper's update), ``adam`` at its own defaults; a
    ``ServerOpt`` -> itself."""
    if server_opt is None or isinstance(server_opt, str) and \
            server_opt in ("", "none"):
        return None
    if isinstance(server_opt, str):
        if server_opt not in SERVER_OPTS:
            raise ValueError(
                f"unknown server optimizer {server_opt!r}; expected one of "
                f"{sorted(SERVER_OPTS)} or 'none'")
        if server_opt in ("sgd", "momentum"):
            return SERVER_OPTS[server_opt](lr=scfg.server_lr)
        return SERVER_OPTS[server_opt]()
    return server_opt


def fed_round(model, scfg: SubmodelConfig, *, mode: str = "auto",
              client_opt=None, server_opt=None, spmd_axis=None, mesh=None,
              mesh_agg: str = "gather", capacities=None, fused_forward="auto",
              uplink_compression=None, device="cuda"):
    """Build one federated sub-model round: a :class:`WindowFedAvg`
    (Algorithm 2: one shared window, per-client windows or none) or a
    :class:`MaskFedAvg` (dense masks, Algorithm 1).

    Args:
      model: a port ``Model`` (``.loss(params, batch, window=)``,
        ``.abstract_params()``, ``.axes()``) or a ``(loss_fn, abstract,
        axes)`` triple: ``abstract`` is ``{path: torch.Size}``, ``axes``
        ``{path: axis tags}``, and ``loss_fn(params, batch[, window=])``
        takes ``[C, ...]`` params and batch leaves and returns ``([C]
        losses, aux)``.  A loss without ``window=`` runs window mode
        through the extract client phase.
      scfg: the :class:`SubmodelConfig`.
      mode: ``auto`` (``mask`` for ``bernoulli``, else ``window``),
        ``window`` or ``mask``.
      client_opt: the local steps' optimizer: a :class:`ClientOpt`, a
        registry name (``sgd``, ``momentum``, ``proximal``) or None (the
        paper's plain SGD).
      server_opt: a server optimizer on the mean client delta, which
        :class:`Trainer` then steps (``round_with_server_opt``): a
        :class:`ServerOpt`, a registry name (``sgd``/``momentum`` at
        ``lr=scfg.server_lr``, ``adam`` at its defaults) or None (the
        paper's plain average).
      spmd_axis, mesh, mesh_agg: the mesh round (window mode).  ``mesh``
        (a ``DeviceMesh`` over the initialised ``torch.distributed`` world,
        ``launch.mesh.host_mesh``) splits the clients over the mesh axis
        ``spmd_axis`` (None: ``clients``, else ``data``, else the leading
        axis), which must divide ``clients_per_round``; every rank runs
        the round on the same params, batch and offsets and trains its own
        contiguous block of clients.  ``mesh_agg``: ``"gather"`` (the
        clients' changes gathered in client order, then the single-process
        aggregation: the ``mesh=None`` round bit for bit) or ``"psum"``
        (each rank's float32 sum of its clients' scattered changes, added
        over the ranks: model-sized traffic, the same values
        reassociated).  ``spmd_axis`` without a mesh is taken and does
        nothing (the reference pins its client vmap with it).
      capacities: per-client ``[C]`` capacity fractions in ``(0, 1]``.
        Mask mode draws each client's dense mask at its own fraction
        (default ``scfg.capacity`` for every client).  Window mode derives
        each client's window width from its fraction and buckets the
        clients by width (:class:`CapacityBucket`, descending): each
        bucket runs the ordinary homogeneous client phase at its own width
        with per-client aggregation, and the buckets' float32 change sums
        are added in bucket order, so the round composes bit for bit from
        homogeneous rounds.  Not with ``mesh=``, scheme ``full`` or
        ``shared_window=True``; uniform capacities at ``scfg.capacity``
        keep the plain round.
      fused_forward: window mode: ``auto`` (the fused client phase where
        every windowed axis has a fused forward, else the extract phase),
        ``on``/True (the fused phase, or ValueError) or ``off``/False (the
        extract phase).
      uplink_compression: window mode: None (the exact float32 uplink) or
        ``"bf16"`` (each client's change rounded to bfloat16 and widened
        back before the float32 mean; the fused client phase's
        aggregation only, as in the reference).
      device: ``cuda`` (default; raises without a card) or ``cpu``.
    """
    loss_fn, abstract, axes = _model_parts(model)
    dev = resolve_device(device)
    resolved = resolve_mode(mode, scfg.scheme)
    client_opt = resolve_client_opt(client_opt)
    server_opt = _resolve_server_opt(server_opt, scfg)
    if mesh_agg not in MESH_AGGS:
        raise ValueError(f"unknown mesh_agg {mesh_agg!r}; expected one of "
                         f"{MESH_AGGS}")
    if mesh is not None:
        if resolved != "window":
            raise ValueError("mesh execution applies to window mode only "
                             "(mask mode is the dense-mask oracle)")
        spmd_axis = resolve_client_axis(mesh, spmd_axis)
        n_shards = axis_size(mesh, spmd_axis)
        if scfg.clients_per_round % n_shards:
            raise ValueError(
                f"clients_per_round={scfg.clients_per_round} must be "
                f"divisible by the {spmd_axis!r} mesh-axis size {n_shards} "
                f"(each shard runs an equal slice of the client vmap)")
    if resolved == "mask":
        if spmd_axis is not None:
            raise ValueError("spmd_axis applies to window mode only")
        if fused_forward in (True, "on"):
            raise ValueError("fused_forward applies to window mode only "
                             "(mask mode is the dense-mask oracle)")
        if uplink_compression is not None:
            raise ValueError("uplink_compression applies to window mode "
                             "only (mask mode is the dense-mask oracle)")
        if capacities is None:
            capacities = np.full(scfg.clients_per_round, scfg.capacity,
                                 np.float32)
        return build_mask_fed(loss_fn, scfg, abstract, axes, capacities, dev,
                              client_opt=client_opt, server_opt=server_opt)
    return build_window_fed(loss_fn, scfg, abstract, axes, dev,
                            client_opt=client_opt, server_opt=server_opt,
                            windowed_loss_fn=_windowed_loss(loss_fn),
                            fused_forward=fused_forward,
                            capacities=capacities,
                            uplink_compression=uplink_compression,
                            spmd_axis=spmd_axis, mesh=mesh,
                            mesh_agg=mesh_agg)
