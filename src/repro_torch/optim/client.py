"""Client (local-step) optimizers of the round.

Ports ``ClientOpt``, ``client_sgd``, ``client_momentum``,
``client_proximal``, ``CLIENT_OPTS`` and ``resolve_client_opt`` of
``repro/optim/client.py``.  Every optimizer ends in the paper's step on
the direction it forms, as the reference's ``_dispatched_step``: ``w <- w
- lr * d`` through the SGD kernel (``kernels.masked_update.sgd_``), or
its masked form ``w <- w - (lr * m) * d`` through the masked SGD kernel
(``masked_sgd_``), in place on each client's copy.  The elementwise
passes that form ``d`` (the velocity, the proximal term) are plain torch,
as they are plain jnp in the reference.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.kernels.masked_update import masked_sgd_, sgd_


class ClientOpt(NamedTuple):
    """(init, update) pair over per-client ``{path: [C, ...]}`` params.

    init:   (params at the round's start) -> state
    update: (params, grads, state, lr, *, masks=None) -> (params, state),
            in place
    """

    name: str
    init: Callable
    update: Callable


def _step(params, direction, lr, masks):
    """``w <- w - lr * d`` (masked: ``w <- w - (lr * m) * d``) on every
    leaf, in place through the update kernels.  ``d`` is cast to the
    param's dtype first (a bf16 param's float32 velocity to bf16), as the
    reference's ``_dispatched_step`` does."""
    for path, p in params.items():
        # a grad through a permuted view (the ResNet's HWIO kernels)
        # comes back strided; the kernels take contiguous operands
        d = direction[path].to(p.dtype).contiguous()
        if masks is None:
            sgd_(p, d, lr)
        else:
            masked_sgd_(p, masks[path], d, lr)
    return params


def client_sgd():
    """The paper's local update: w <- w - lr * g (masked in mask mode)."""

    def init(params):
        return ()

    def update(params, grads, state, lr, *, masks=None):
        return _step(params, grads, lr, masks), state

    return ClientOpt("sgd", init, update)


def client_momentum(beta=0.9):
    """Heavy-ball local steps: v <- beta * v + g; w <- w - lr * v.  The
    float32 velocity ``[C, ...]`` lives for one round."""

    def init(params):
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}

    def update(params, grads, state, lr, *, masks=None):
        for path, v in state.items():
            v.mul_(beta).add_(grads[path].float())
        return _step(params, state, lr, masks), state

    return ClientOpt("momentum", init, update)


def client_proximal(mu=0.01):
    """FedProx local steps: w <- w - lr * (g + mu * (w - w0)), w0 the
    client's copy at the round's start (kept as the state's anchor)."""

    def init(params):
        return {"anchor": {k: p.detach().clone() for k, p in params.items()}}

    def update(params, grads, state, lr, *, masks=None):
        anchor = state["anchor"]
        g = {k: gr + mu * (params[k] - anchor[k]).to(gr.dtype)
             for k, gr in grads.items()}
        return _step(params, g, lr, masks), state

    return ClientOpt("proximal", init, update)


CLIENT_OPTS = {"sgd": client_sgd, "momentum": client_momentum,
               "proximal": client_proximal}


def resolve_client_opt(client_opt) -> ClientOpt:
    """None -> the paper's SGD; a name -> the registry's; a ClientOpt ->
    itself."""
    if client_opt is None:
        return client_sgd()
    if isinstance(client_opt, str):
        try:
            return CLIENT_OPTS[client_opt]()
        except KeyError:
            raise ValueError(
                f"unknown client optimizer {client_opt!r}; expected one of "
                f"{sorted(CLIENT_OPTS)}") from None
    return client_opt
