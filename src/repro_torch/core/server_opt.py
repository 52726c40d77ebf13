"""Server optimizers: the round's mean client delta as a pseudo-gradient.

Ports ``ServerOpt``, ``server_sgd``, ``server_momentum``, ``server_adam``
and ``SERVER_OPTS`` of ``repro/core/server_opt.py`` (Reddi et al.,
"Adaptive Federated Optimization"):

* ``server_sgd``      -- the paper's update (``lr = server_lr``), no state;
* ``server_momentum`` -- FedAvgM: ``m <- beta m + delta; w += lr m``;
* ``server_adam``     -- FedAdam, the step count ``t`` a host integer.

The state is full-shaped float32 on the params' device (``init`` takes the
params, whose device it needs); a windowed round's delta is exactly 0
outside the windows, where the momenta decay.  ``update(params, delta,
state)`` steps every leaf in place, one leaf at a time, rounding in the
reference's order: ``(w.float() + lr * step).to(w.dtype)``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class ServerOpt(NamedTuple):
    init: Callable     # (params) -> state
    update: Callable   # (params, mean_delta, state) -> (params, state)


def _zeros(params):
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _add_(w, step):
    """``w <- w + step`` in float32, rounded once into w's dtype."""
    w.copy_((w.float() + step).to(w.dtype))


def server_sgd(lr=1.0):
    def init(params):
        return ()

    def update(params, delta, state):
        for k, w in params.items():
            _add_(w, lr * delta[k].float())
        return params, state

    return ServerOpt(init, update)


def server_momentum(lr=1.0, beta=0.9):
    def init(params):
        return _zeros(params)

    def update(params, delta, state):
        for k, w in params.items():
            m = state[k].mul_(beta).add_(delta[k].float())
            _add_(w, lr * m)
        return params, state

    return ServerOpt(init, update)


def server_adam(lr=0.1, b1=0.9, b2=0.99, eps=1e-6):
    def init(params):
        return {"m": _zeros(params), "v": _zeros(params), "t": 0}

    def update(params, delta, state):
        t = state["t"] + 1
        # the bias corrections in float32, as the reference's traced int t
        # makes them
        f32 = np.float32
        c1 = float(f32(1) - f32(b1) ** f32(t))
        c2 = float(f32(1) - f32(b2) ** f32(t))
        for k, w in params.items():
            d = delta[k].float()
            m = state["m"][k].mul_(b1).add_((1 - b1) * d)
            v = state["v"][k].mul_(b2).add_((1 - b2) * d.square())
            del d
            _add_(w, lr * (m / c1) / (torch.sqrt(v / c2) + eps))
        return params, {"m": state["m"], "v": state["v"], "t": t}

    return ServerOpt(init, update)


SERVER_OPTS = {"sgd": server_sgd, "momentum": server_momentum,
               "adam": server_adam}
