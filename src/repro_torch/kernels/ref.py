"""Plain PyTorch versions of the port's kernels.

They define what each CUDA kernel computes.  The wrappers take them only
for tensors on the CPU; the CPU tests hold them against the JAX
reference, and ``chip_smoke.py`` holds each kernel against them on the card.
``offsets`` are host integers, one per client.
"""
from __future__ import annotations

import numpy as np
import torch


def rolling_matmul_batched_ref(x, ws, offsets, win):
    """``ys[t][c] = x[c] @ ws[t][c][:, offsets[c] : offsets[c] + win]``
    (the reference's ``rolling_matmul_ref`` per client, per weight)."""
    return tuple(
        torch.stack([x[c] @ w[c, :, o:o + win]
                     for c, o in enumerate(offsets)])
        for w in ws)


def rolling_matmul_batched_dx_ref(dys, ws, offsets, win):
    """``dx[c] = sum_t dys[t][c] @ ws[t][c][:, offsets[c] : offsets[c] +
    win]^T``, summed over t in order (the reference's pairwise sum)."""
    out = None
    for dy, w in zip(dys, ws):
        term = torch.stack([dy[c] @ w[c, :, o:o + win].mT
                            for c, o in enumerate(offsets)])
        out = term if out is None else out + term
    return out


def sgd_ref(w, g, lr):
    """``w <- w - lr * g`` in place, rounding the product and the difference
    separately as the reference's ``p - lr * g`` does; returns ``w``."""
    return w.sub_(g * lr)


def masked_sgd_ref(w, m, g, lr):
    """``w <- w - (lr * m) * g`` in place: the product rounds first, then
    the difference, as the reference's ``p - lr * m * g``; returns ``w``."""
    return w.sub_(m * float(np.float32(lr)) * g)


def fillin_agg_ref(w, w_clients, m_clients, scale):
    """``w <- w + scale * acc`` in place, ``acc = sum_c m_c * (w_c - w)``
    summed over c = 0 .. C-1 in order from 0 (the reference's
    ``_fillin_kernel``); ``scale`` (``server_lr / C``) is rounded once to
    float32.  ``w_clients`` and ``m_clients`` are ``[C, *w.shape]``;
    returns ``w``."""
    acc = torch.zeros_like(w)
    for wc, mc in zip(w_clients, m_clients):
        acc += mc * (wc - w)
    return w.add_(acc * float(np.float32(scale)))
