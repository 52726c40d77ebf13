"""Windowed (rolling) matrix products with per-client offsets.

Ports the batched-offset kernels of ``repro/kernels/rolling_matmul_batched.py``
(``rolling_matmul_batched``, ``_dx``, ``_multi``, ``_dx_multi``) and their
custom VJPs in ``repro/kernels/dispatch.py`` (``_rolling_mm_b_bwd`` and
``_rolling_mm_multi_bwd``).  Clients are the leading dimension of every
operand, as the reference's client vmap makes them:

    ys[t][c] = x[c] @ ws[t][c][:, off[c] : off[c] + win]        t < T <= 2

T weights share one x and one window (the MLP's gate/up pair is T = 2).

One model (no client dimension) takes the scalar-offset forms, which port
``rolling_matmul``/``rolling_matmul_multi`` (``repro/kernels/
rolling_matmul.py``), ``rolling_matmul_dx``/``rolling_matmul_dx_multi``
(``rolling_matmul_bwd.py``) and the custom VJP of ``dispatch.rolling_matmul``
and ``dispatch.rolling_matmul_multi``: ``x [M, K]``, ``w [K, N]``, one
offset.  They run as C = 1 launches of the same kernels, through the same
autograd function, on ``unsqueeze(0)`` views (no copy of the weight),
counted under the reference's scalar names.
The kernels take any offset, where the TPU's need one aligned to their
blocks; a batch of tokens folds into the M rows, the reference's rule for a
shared weight and offset (``dispatch.py:276-287``).

On a CUDA tensor each wrapper launches its kernel (``csrc/rolling_mm.cu``)
or raises; on a CPU tensor it runs the plain version in ``kernels.ref``.
There is no other arm and no fallback.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels import _build, ref


class Offsets(NamedTuple):
    """One window offset per client, twice: host integers (shape checks,
    the plain versions and the dW window writes) and an int32 ``[C]``
    tensor on the data's device, which the kernels read."""

    host: Tuple[int, ...]
    dev: torch.Tensor


def make_offsets(host: Sequence[int], device) -> Offsets:
    host = tuple(int(o) for o in host)
    return Offsets(host, torch.tensor(host, dtype=torch.int32, device=device))


def _check(x, ws, offsets, win, x_name="x"):
    """Validate what the kernels take; returns (C, M, K, N, ldw, w_bs)."""
    if not 1 <= len(ws) <= 2:
        raise ValueError(f"1 or 2 weights share one {x_name}; got {len(ws)}")
    if x.dtype != torch.float32 or any(w.dtype != torch.float32 for w in ws):
        raise TypeError("the windowed products take float32 operands")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{x_name} must be a contiguous [C, M, *] tensor; "
                         f"got shape {tuple(x.shape)}")
    w0 = ws[0]
    if w0.dim() != 3 or any(w.shape != w0.shape or w.stride() != w0.stride()
                            for w in ws):
        raise ValueError("weights must be [C, K, N] tensors of one shape and "
                         "layout")
    C, K, N = w0.shape
    if w0.stride(2) != 1 or w0.stride(1) < N:
        raise ValueError("weight rows must be contiguous (stride(2) == 1)")
    if x.shape[0] != C or len(offsets.host) != C:
        raise ValueError(f"{x_name}, weights and offsets disagree on the "
                         f"client count: {x.shape[0]}, {C}, "
                         f"{len(offsets.host)}")
    if not 0 < win <= N or any(not 0 <= o <= N - win for o in offsets.host):
        raise ValueError(f"window [{offsets.host}, +{win}) leaves the "
                         f"{N} weight columns")
    devices = {x.device, offsets.dev.device, *(w.device for w in ws)}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {devices}")
    if (offsets.dev.dtype != torch.int32
            or tuple(offsets.dev.shape) != (C,)):
        raise ValueError("device offsets must be int32 [C]")
    return C, x.shape[1], K, N, w0.stride(1), w0.stride(0)


def rolling_mm_fwd(x, ws, offsets: Offsets, win, name=None):
    """``ys[t] = x @ ws[t][:, :, window]`` per client; ``x [C, M, K]``,
    each ``ws[t] [C, K, N]``; returns a tuple of T ``[C, M, win]``.  A
    launch counts under ``name`` (default ``rolling_mm_fwd<T>``)."""
    C, M, K, N, ldw, w_bs = _check(x, ws, offsets, win)
    if x.shape[2] != K:
        raise ValueError(f"x has {x.shape[2]} columns, weights {K} rows")
    if x.device.type == "cpu":
        return ref.rolling_matmul_batched_ref(x, ws, offsets.host, win)
    T = len(ws)
    ys = tuple(torch.empty((C, M, win), dtype=x.dtype, device=x.device)
               for _ in range(T))
    wp = [w.data_ptr() for w in ws] + [0] * (2 - T)
    yp = [y.data_ptr() for y in ys] + [0] * (2 - T)
    err = _build.library().rolling_mm_fwd(
        T, x.data_ptr(), wp[0], wp[1], yp[0], yp[1], offsets.dev.data_ptr(),
        C, M, K, N, win, w_bs, ldw, torch.cuda.current_stream(
            x.device).cuda_stream)
    _build.check_launch(name or f"rolling_mm_fwd<{T}>", err)
    return ys


def rolling_mm_dx(dys, ws, offsets: Offsets, win, name=None):
    """``dx = sum_t dys[t] @ ws[t][:, :, window]^T`` per client;
    ``dys[t] [C, M, win]``; returns ``[C, M, K]``.  A launch counts under
    ``name`` (default ``rolling_mm_dx<T>``)."""
    dy0 = dys[0]
    C, M, K, N, ldw, w_bs = _check(dy0, ws, offsets, win, x_name="dy")
    if len(dys) != len(ws) or any(
            d.shape != (C, M, win) or not d.is_contiguous()
            or d.dtype != torch.float32 or d.device != dy0.device
            for d in dys):
        raise ValueError(f"each dy must be a contiguous float32 [C, M, win] "
                         f"tensor, one per weight; got "
                         f"{[tuple(d.shape) for d in dys]}")
    if dy0.device.type == "cpu":
        return ref.rolling_matmul_batched_dx_ref(dys, ws, offsets.host, win)
    T = len(ws)
    dx = torch.empty((C, M, K), dtype=dy0.dtype, device=dy0.device)
    wp = [w.data_ptr() for w in ws] + [0] * (2 - T)
    dp = [d.data_ptr() for d in dys] + [0] * (2 - T)
    err = _build.library().rolling_mm_dx(
        T, dp[0], dp[1], wp[0], wp[1], dx.data_ptr(), offsets.dev.data_ptr(),
        C, M, K, N, win, w_bs, ldw, torch.cuda.current_stream(
            dy0.device).cuda_stream)
    _build.check_launch(name or f"rolling_mm_dx<{T}>", err)
    return dx


def block_tile(kind, T, C, M, K, win):
    """The ``(rows, columns)`` output tile of each block that the
    ``kind`` ("fwd" or "dx") kernel takes for these sizes on the current
    card: the kernel picks it per launch, the largest whose grid covers
    every SM, else the narrowest."""
    code = _build.library().rolling_mm_tile(int(kind == "dx"), T, C, M, K,
                                             win)
    return code >> 16, code & 0xFFFF


class RollingMatmulBatched(torch.autograd.Function):
    """Differentiable ``rolling_mm_fwd``, with the reference's VJP split
    (``dispatch.py:486-503`` and ``:662-683``): ``dx`` through the
    ``rolling_mm_dx`` kernel, and each ``dW_t`` a window write of
    ``x[c]^T @ dy_t[c]`` into a full-shaped zero gradient, so coordinates
    outside the window get exactly 0.

    ``RollingMatmulBatched.apply(x, offsets, win, names, *ws)`` returns a
    tuple of T outputs; ``names`` is the (forward, dx) pair of launch-count
    names, or None for the kernels' own."""

    @staticmethod
    def forward(ctx, x, offsets, win, names, *ws):
        fwd_name, ctx.dx_name = names or (None, None)
        ys = rolling_mm_fwd(x, ws, offsets, win, name=fwd_name)
        ctx.save_for_backward(x, *ws)
        ctx.offsets, ctx.win = offsets, win
        return ys

    @staticmethod
    def backward(ctx, *dys):
        x, *ws = ctx.saved_tensors
        offsets, win = ctx.offsets, ctx.win
        dys = [d.contiguous() for d in dys]
        dx = (rolling_mm_dx(dys, ws, offsets, win, name=ctx.dx_name)
              if ctx.needs_input_grad[0] else None)
        dws = []
        for w, dy in zip(ws, dys):
            dw = torch.zeros_like(w)
            for c, o in enumerate(offsets.host):
                # the product writes straight into the window view of dW
                dw[c, :, o:o + win].addmm_(x[c].mT, dy[c])
            dws.append(dw)
        return (dx, None, None, None, *dws)


def rolling_matmul_batched(x, ws, offsets: Offsets, win, names=None):
    """Differentiable windowed product; see :class:`RollingMatmulBatched`."""
    return RollingMatmulBatched.apply(x, offsets, win, names, *ws)


# -- one model: a scalar offset, C = 1 launches --------------------------------

#: (forward, dx) launch-count names of one model's products, by T: the
#: reference's scalar-offset kernels (TPU rows 1-4)
SCALAR_NAMES = {1: ("rolling_matmul", "rolling_matmul_dx"),
                2: ("rolling_matmul_multi", "rolling_matmul_dx_multi")}


def rolling_matmul(x, ws, offset: int, win):
    """One model's differentiable ``ys[t] = x [M, K] @ ws[t] [K, N][:,
    offset : offset + win]`` for T <= 2 weights sharing one x and one
    window (the reference's ``rolling_matmul`` at T = 1,
    ``rolling_matmul_multi`` at T = 2); returns a tuple of T ``[M, win]``.
    :func:`rolling_matmul_batched` on C = 1 views, counted under
    :data:`SCALAR_NAMES`."""
    ys = rolling_matmul_batched(
        x.contiguous().unsqueeze(0), [w.unsqueeze(0) for w in ws],
        make_offsets((offset,), x.device), win, names=SCALAR_NAMES[len(ws)])
    return tuple(y[0] for y in ys)
