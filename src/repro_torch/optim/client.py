"""Client (local-step) optimizers of the round.

Ports ``ClientOpt``, ``client_sgd`` and ``resolve_client_opt`` of
``repro/optim/client.py``.  The paper's local update ``w <- w - lr * g``
goes through the SGD kernel (``kernels.masked_update.sgd_``), and its
masked form ``w <- w - (lr * m) * g`` through the masked SGD kernel
(``masked_sgd_``), in place on each client's copy.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.kernels.masked_update import masked_sgd_, sgd_


class ClientOpt(NamedTuple):
    """(init, update) pair over per-client ``{path: [C, ...]}`` params.

    init:   (params) -> state
    update: (params, grads, state, lr, *, masks=None) -> (params, state),
            in place
    """

    name: str
    init: Callable
    update: Callable


def client_sgd():
    """The paper's local update: w <- w - lr * g (masked in mask mode)."""

    def init(params):
        return ()

    def update(params, grads, state, lr, *, masks=None):
        for path, p in params.items():
            # a grad through a permuted view (the ResNet's HWIO kernels)
            # comes back strided; the kernels take contiguous operands
            g = grads[path].contiguous()
            if masks is None:
                sgd_(p, g, lr)
            else:
                masked_sgd_(p, masks[path], g, lr)
        return params, state

    return ClientOpt("sgd", init, update)


def resolve_client_opt(client_opt) -> ClientOpt:
    """None or ``"sgd"`` -> the paper's SGD; a ClientOpt -> itself."""
    if client_opt is None or client_opt == "sgd":
        return client_sgd()
    if isinstance(client_opt, ClientOpt):
        return client_opt
    raise NotImplementedError(
        f"client optimizer {client_opt!r} is not ported yet (ROADMAP.md "
        "queue A, optimizers and the uplink)")
