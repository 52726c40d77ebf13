"""Plain optimizers over ``{path: tensor}`` params, and lr schedules.

Ports ``Optimizer``, ``sgd``, ``momentum``, ``adamw``, ``cosine_schedule``
and ``theory_eta`` of ``repro/optim/optimizers.py`` (the reference's
non-federated optimizers; the round's own are in ``optim/client.py`` and
``core/server_opt.py``).  Each ``update(grads, state, params, step=0)``
returns new params and state and leaves its inputs as they are, as the
reference's do; ``lr`` is a number or a schedule ``lr(step)``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (new_params, new_state)


def _lr(lr, step):
    return lr(step) if callable(lr) else lr


def sgd(lr):
    def init(params):
        return ()

    def update(grads, state, params, step=0):
        lrv = _lr(lr, step)
        return {k: p - lrv * grads[k].to(p.dtype)
                for k, p in params.items()}, state

    return Optimizer(init, update)


def momentum(lr, beta=0.9):
    def init(params):
        return {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}

    def update(grads, state, params, step=0):
        lrv = _lr(lr, step)
        new_m = {k: beta * m + grads[k].float() for k, m in state.items()}
        return {k: p - lrv * new_m[k].to(p.dtype)
                for k, p in params.items()}, new_m

    return Optimizer(init, update)


def adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    def init(params):
        z = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in params.items()}
        return {"m": z, "v": {k: v.clone() for k, v in z.items()}, "t": 0}

    def update(grads, state, params, step=None):
        t = state["t"] + 1
        lrv = _lr(lr, t)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = grads[k].float()
            m = b1 * state["m"][k] + (1 - b1) * g
            v = b2 * state["v"][k] + (1 - b2) * g * g
            mhat = m / (1 - b1 ** t)
            vhat = v / (1 - b2 ** t)
            upd = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
            new_p[k] = (p - lrv * upd).to(p.dtype)
            new_m[k], new_v[k] = m, v
        return new_p, {"m": new_m, "v": new_v, "t": t}

    return Optimizer(init, update)


# -- schedules ----------------------------------------------------------------


def cosine_schedule(base_lr, warmup, total):
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``; ``lr(t)`` is a float32 0-dim tensor."""
    def lr(t):
        t = torch.as_tensor(t, dtype=torch.float32)
        warm = base_lr * t / max(warmup, 1)
        frac = torch.clamp((t - warmup) / max(total - warmup, 1), 0, 1)
        cos = base_lr * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(t < warmup, warm, cos)
    return lr


def theory_eta(mu_bar, K, R):
    """Theorem 1 stepsize: eta = log(KR)^2 / (mu_bar K R)."""
    return math.log(max(K * R, 2)) ** 2 / (mu_bar * K * R)
