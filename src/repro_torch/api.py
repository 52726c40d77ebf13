"""repro_torch.api — the port's public entry surface.

Ports ``fed_round`` (window mode) and ``Trainer`` of ``repro/api.py``::

    from repro_torch import api
    from repro_torch.configs.base import SubmodelConfig, get_config
    from repro_torch.models import build_model

    model = build_model(get_config("tinyllama_1_1b"))
    params = model.init(seed=0)                       # on the card
    scfg = SubmodelConfig(scheme="rolling", capacity=0.5, local_steps=2,
                          clients_per_round=4, client_lr=0.1,
                          axes=("d_ff", "heads", "kv_heads"))
    fed = api.fed_round(model, scfg)
    params, history = api.Trainer(fed, params).run(batches, 3)

Everything runs on the card (``device="cuda"``) unless the caller passes
``device="cpu"``, which runs the kernels' plain PyTorch versions.
Arguments the port does not cover yet raise ``NotImplementedError`` naming
their ROADMAP.md item.
"""
from __future__ import annotations

from repro_torch.configs.base import SubmodelConfig
from repro_torch.core.fedavg import WindowFedAvg, build_window_fed
from repro_torch.core.trainer import Trainer
from repro_torch.device import resolve_device

__all__ = ["fed_round", "Trainer", "WindowFedAvg"]


def _not_ported(what, item):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md queue "
                              f"A, {item})")


def fed_round(model, scfg: SubmodelConfig, *, mode: str = "auto",
              client_opt=None, server_opt=None, mesh=None, capacities=None,
              fused_forward="auto", device="cuda") -> WindowFedAvg:
    """Build one federated sub-model round (Algorithm 2, window mode, one
    shared window, fused client phase).

    Args:
      model: a port ``Model`` (``.loss(params, batch, window=)``,
        ``.abstract_params()``, ``.axes()``).
      scfg: the :class:`SubmodelConfig`.
      mode: ``auto`` or ``window``.
      client_opt: None or ``"sgd"`` (the paper's plain SGD).
      fused_forward: ``auto`` or ``on``.
      device: ``cuda`` (default; raises without a card) or ``cpu``.
    """
    dev = resolve_device(device)
    if mode == "mask" or (mode == "auto" and scfg.scheme == "bernoulli"):
        _not_ported("mask mode", "mask mode")
    if mode not in ("auto", "window"):
        raise ValueError(f"unknown mode {mode!r}")
    if server_opt not in (None, "", "none"):
        _not_ported("server optimizers", "optimizers and the uplink")
    if capacities is not None:
        _not_ported("heterogeneous capacities", "heterogeneous capacities")
    if mesh is not None:
        _not_ported("the mesh round", "mesh round")
    return build_window_fed(model.loss, scfg, model.abstract_params(),
                            model.axes(), dev, client_opt=client_opt,
                            fused_forward=fused_forward)
