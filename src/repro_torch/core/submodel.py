"""Dense-mask mode (the paper's literal formulation) and the projection
helpers of the round.

Ports ``bernoulli_masks``, ``apply_mask``, ``masked_value_and_grad``,
``masked_sgd_step``, ``fillin_average``, ``project_l2`` and ``global_norm``
of ``repro/core/submodel.py``.  Params, masks and grads are flat ``{path:
tensor}`` dicts; the masked step and the fill-in update in place through
the kernels of ``kernels.masked_update``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.masked_update import fillin_agg_, masked_sgd_


def bernoulli_masks(generator, shapes, p, device):
    """Per-coordinate Bernoulli(p) float32 masks, one leaf per parameter
    (Algorithm 1), drawn from ``generator`` on ``device`` (its device: the
    masks of a full-width round are far too large to draw on the host).
    ``p`` is a float, or a ``[C]`` tensor of per-client probabilities, which
    gives masks ``[C, *shape]``.  ``torch``'s stream differs from
    ``jax.random``'s, so the same seed gives other masks than the
    reference's."""
    p = torch.as_tensor(p, dtype=torch.float32, device=device)
    out = {}
    for path, shape in shapes.items():
        u = torch.rand(p.shape + tuple(shape), generator=generator,
                       device=device)
        out[path] = u.lt_(p.view(p.shape + (1,) * len(shape)))
    return out


def apply_mask(params, masks):
    return {k: p * masks[k].to(p.dtype) for k, p in params.items()}


def masked_value_and_grad(loss_fn):
    """``d/dw loss(m * w) = m * grad f(m * w)``, the paper's local update,
    in its literal form.  ``wrapped(params, masks, batch)`` returns
    ``((loss, aux), grads)``; ``loss_fn`` returns one loss per client
    (``[C]``), and the gradient of their sum gives each client its own."""

    def wrapped(params, masks, batch):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss, aux = loss_fn(apply_mask(p, masks), batch)
        grads = torch.autograd.grad(loss.sum(), list(p.values()))
        return (loss.detach(), aux), dict(zip(p, grads))

    return wrapped


def masked_sgd_step(params, masks, grads, lr):
    """``w <- w - (lr * m) * g`` on every leaf, in place."""
    for path, p in params.items():
        masked_sgd_(p, masks[path], grads[path], lr)
    return params


def fillin_average(server, client_params, masks, server_lr=1.0):
    """``w <- w + (server_lr / C) * sum_c m_c * (w_c - w)`` on every leaf,
    in place: at ``server_lr = 1`` the paper's ``w_{r+1} = (1/C) sum_c (w_c
    + (1 - m_c) * w_r)`` in delta form.  It follows the reference's Pallas
    arm, ``(1/C) * sum``; its jnp arm divides the sum by C, which agrees
    bit for bit at C = 2^k and within 1 ulp otherwise."""
    for path, w in server.items():
        fillin_agg_(w, client_params[path], masks[path], server_lr)
    return server


def global_norm(params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in params.values()))


def project_l2(params, radius):
    """P_W: projection onto the l2 ball of ``radius`` (0 = off), in place
    (scaling every leaf where it lies saves a copy of the model)."""
    if not radius:
        return params
    norm = global_norm(params)
    scale = torch.clamp(radius / torch.clamp_min(norm, 1e-12), max=1.0)
    for x in params.values():
        x.mul_(scale.to(x.dtype))
    return params
