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

The operands are float32, or all bfloat16: the bf16 arm (the Pallas
kernels on bf16 operands: float32 accumulation, the output rounded once
to the operands' dtype) launches ``rolling_mm_fwd_bf16`` /
``rolling_mm_dx_bf16`` and counts under the launch's name with ``/bf16``
appended.  Its entry point runs one of two bodies, from the data's
alignment: ``wgmma`` fed by TMA where the tensor map takes the operands
(16-byte rows and bases, every offset a multiple of 8 elements), else
``mma.sync`` fed by copies that take any alignment; each launch also
counts under ``"<name>/bf16 <body>"`` in ``_build.BODIES``.  Mixed dtypes
are refused.

On a ``meta`` tensor (the planning path) each wrapper checks its operands
as on the card, returns empty outputs of the kernel's shape and dtype and
reports its launch's :func:`cost` to the active counters
(``repro_torch.accounting``); it launches nothing and counts no launch.
On the card it reports the same cost beside the launch, while a counter
is active.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch import accounting
from repro_torch.device import check_f32_sums
from repro_torch.kernels import _build, ref


class Offsets(NamedTuple):
    """One window offset per client, twice: host integers (shape checks,
    the plain versions and the dW window writes) and an int32 ``[C]``
    tensor on the data's device, which the kernels read."""

    host: Tuple[int, ...]
    dev: torch.Tensor


def cost(kind, T, C, M, K, win, dtype=torch.float32):
    """``(flops, hbm_bytes, rate_class)`` of one ``kind`` ("fwd" or "dx")
    launch over T weights: ``2 * C * M * K * win`` a weight, at the 3xTF32
    rate (f32) or the dense bf16 rate (bf16); x or dx ``[C, M, K]``, the T
    weight windows ``[C, K, win]`` and the T ys or dys ``[C, M, win]``,
    each moved once (the same count in both directions)."""
    esize = dtype.itemsize
    flops = 2 * C * M * K * win * T
    nbytes = esize * (C * M * K + T * C * K * win + T * C * M * win)
    return flops, nbytes, ("bfloat16" if dtype == torch.bfloat16
                           else "tf32x3")


def _declare(kind, name, T, C, M, K, win, dtype):
    """The launch's cost, under its launch-count name (``/bf16`` for the
    bf16 arm, as ``_build.launch`` counts it), where a counter is
    active."""
    if not accounting.ACTIVE:
        return
    accounting.declare(name + ("/bf16" if dtype == torch.bfloat16 else ""),
                  *cost(kind, T, C, M, K, win, dtype))


def make_offsets(host: Sequence[int], device) -> Offsets:
    host = tuple(int(o) for o in host)
    return Offsets(host, torch.tensor(host, dtype=torch.int32, device=device))


def _check(x, ws, offsets, win, x_name="x"):
    """Validate what the kernels take; returns (C, M, K, N, ldw, w_bs)."""
    if not 1 <= len(ws) <= 2:
        raise ValueError(f"1 or 2 weights share one {x_name}; got {len(ws)}")
    if str(x.dtype) not in _build.ARMS or any(w.dtype != x.dtype for w in ws):
        raise TypeError(f"the windowed products take float32 or bfloat16 "
                        f"operands, all of one dtype; got {x.dtype} and "
                        f"{[w.dtype for w in ws]}")
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


def _bf16_args(dtype, offsets):
    """The bf16 arm's extra argument: whether every client's offset is a
    multiple of 8 elements (16 bytes), which its wgmma body's TMA copies
    need of a window's first column."""
    if dtype != torch.bfloat16:
        return ()
    return (int(all(o % 8 == 0 for o in offsets.host)),)


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
    name = name or f"rolling_mm_fwd<{T}>"
    meta = x.device.type == "meta"
    if not meta:
        _build.make_current(x.device)
    _declare("fwd", name, T, C, M, K, win, x.dtype)
    ys = tuple(torch.empty((C, M, win), dtype=x.dtype, device=x.device)
               for _ in range(T))
    if meta:
        return ys
    wp = [w.data_ptr() for w in ws] + [0] * (2 - T)
    yp = [y.data_ptr() for y in ys] + [0] * (2 - T)
    _build.launch("rolling_mm_fwd", name, x.dtype, T, x.data_ptr(), wp[0],
                  wp[1], yp[0], yp[1], offsets.dev.data_ptr(), C, M, K, N,
                  win, w_bs, ldw, torch.cuda.current_stream(x.device).cuda_stream,
                  *_bf16_args(x.dtype, offsets))
    return ys


def rolling_mm_dx(dys, ws, offsets: Offsets, win, name=None):
    """``dx = sum_t dys[t] @ ws[t][:, :, window]^T`` per client;
    ``dys[t] [C, M, win]``; returns ``[C, M, K]``.  A launch counts under
    ``name`` (default ``rolling_mm_dx<T>``)."""
    dy0 = dys[0]
    C, M, K, N, ldw, w_bs = _check(dy0, ws, offsets, win, x_name="dy")
    if len(dys) != len(ws) or any(
            d.shape != (C, M, win) or not d.is_contiguous()
            or d.dtype != dy0.dtype or d.device != dy0.device
            for d in dys):
        raise ValueError(f"each dy must be a contiguous [C, M, win] tensor "
                         f"of the weights' dtype, one per weight; got "
                         f"{[tuple(d.shape) for d in dys]}")
    if dy0.device.type == "cpu":
        return ref.rolling_matmul_batched_dx_ref(dys, ws, offsets.host, win)
    T = len(ws)
    name = name or f"rolling_mm_dx<{T}>"
    meta = dy0.device.type == "meta"
    if not meta:
        _build.make_current(dy0.device)
    _declare("dx", name, T, C, M, K, win, dy0.dtype)
    dx = torch.empty((C, M, K), dtype=dy0.dtype, device=dy0.device)
    if meta:
        return dx
    wp = [w.data_ptr() for w in ws] + [0] * (2 - T)
    dp = [d.data_ptr() for d in dys] + [0] * (2 - T)
    _build.launch("rolling_mm_dx", name, dy0.dtype, T, dp[0], dp[1], wp[0],
                  wp[1], dx.data_ptr(), offsets.dev.data_ptr(), C, M, K, N,
                  win, w_bs, ldw, torch.cuda.current_stream(dy0.device).cuda_stream,
                  *_bf16_args(dy0.dtype, offsets))
    return dx


def block_tile(kind, T, C, M, K, win, dtype=torch.float32):
    """The ``(rows, columns)`` output tile of each block that the
    ``kind`` ("fwd" or "dx") kernel takes for these sizes on the current
    card: the kernel picks it per launch, the largest whose grid covers
    every SM, else the narrowest.  The f32 arm and the bf16 arm's
    mma.sync body pick from 128 x 128, 128 x 64, 64 x 64 and 64 x 32; the
    bf16 arm's wgmma body (``dtype`` bfloat16; the launches whose operands
    TMA takes) from 128 x 128, 64 x 128, 64 x 64 and, in dx, 64 x 32."""
    code = _build.library().rolling_mm_tile(
        int(kind == "dx"), T, C, M, K, win, int(dtype == torch.bfloat16))
    return code >> 16, code & 0xFFFF


def _lanes(x, ws, offsets, experts):
    """The launches of one product: ``(x, ws, offsets, at)`` each, ``at``
    the index of the launch's weights in the full ``ws`` (and so of its
    share of ``dW``).  Without ``experts``, one launch of every client;
    with them, one a client on its window of experts."""
    if experts is None:
        return [(x, ws, offsets, ())]
    G = x.shape[1]
    return [(x[c], [w[c, e:e + G] for w in ws], offsets[c],
             (c, slice(e, e + G))) for c, e in enumerate(experts)]


def _window_grad(dw, x, dy, offsets, win):
    """``dw[c][:, window_c] = x[c]^T @ dy[c]`` into zeros: the product writes
    straight into the window of ``dw`` (no compact-shaped temporary on the
    card), one batched product for a shared window, one per client for
    per-client windows.  On the CPU per-client windows take one bmm and a
    scatter, the extract client phase's product (one mm per client rounds
    otherwise past about 256 columns).  At bf16 the product sums in
    float32 and rounds once into ``dw`` (``dispatch.py:377-381``): cuBLAS
    does so on the card, into zeros (``device.check_f32_sums``); on the
    CPU the operands are widened, the extract client phase's product
    (``models.layers.bmm``)."""
    check_f32_sums(x)
    o = ref.shared_offset(offsets.host)
    if dw.device.type == "cpu" and (o is None or dw.dtype != torch.float32):
        g = torch.bmm(x.mT.float(), dy.float())
        for c, oc in enumerate(offsets.host):
            dw[c, :, oc:oc + win] = g[c]
    elif o is not None:
        dw[:, :, o:o + win].baddbmm_(x.mT, dy)
    else:
        for c, oc in enumerate(offsets.host):
            dw[c, :, oc:oc + win].addmm_(x[c].mT, dy[c])


class RollingMatmulBatched(torch.autograd.Function):
    """Differentiable ``rolling_mm_fwd``, with the reference's VJP split
    (``dispatch.py:486-503`` and ``:662-683``): ``dx`` through the
    ``rolling_mm_dx`` kernel, and each ``dW_t`` a window write of
    ``x[c]^T @ dy_t[c]`` into a full-shaped zero gradient, so coordinates
    outside the window get exactly 0.

    ``RollingMatmulBatched.apply(x, offsets, win, names, experts, *ws)``
    returns a tuple of T outputs; ``names`` is the (forward, dx) pair of
    launch-count names, or None for the kernels' own.

    ``experts`` (None, or host offsets ``[C]``) reads each client's window
    of a leading expert axis in place: x ``[C, G, M, K]``, each ``ws[t]
    [C, E, K, N]`` and ``offsets`` a list of C :class:`Offsets`, client
    c's column offset repeated G times.  Client c's experts ``ws[t][c, e_c
    : e_c + G]`` (a view: the kernels take one batch stride, and two
    clients' windows lie at another) go through one launch a client, the
    experts in the kernel's leading dimension."""

    @staticmethod
    def forward(ctx, x, offsets, win, names, experts, *ws):
        fwd_name, ctx.dx_name = names or (None, None)
        ys = [rolling_mm_fwd(xl, wl, ol, win, name=fwd_name)
              for xl, wl, ol, _ in _lanes(x, ws, offsets, experts)]
        ctx.save_for_backward(x, *ws)
        ctx.offsets, ctx.win, ctx.experts = offsets, win, experts
        if experts is None:
            return ys[0]
        return tuple(torch.stack(y) for y in zip(*ys))

    @staticmethod
    def backward(ctx, *dys):
        x, *ws = ctx.saved_tensors
        win, experts = ctx.win, ctx.experts
        lanes = _lanes(x, ws, ctx.offsets, experts)
        dys = [d.contiguous() for d in dys]
        lane_dys = ([dys] if experts is None else
                    [[d[c] for d in dys] for c in range(len(experts))])
        dx = None
        if ctx.needs_input_grad[0]:
            dxs = [rolling_mm_dx(d, wl, ol, win, name=ctx.dx_name)
                   for d, (_, wl, ol, _) in zip(lane_dys, lanes)]
            dx = dxs[0] if experts is None else torch.stack(dxs)
        dws = [torch.zeros_like(w) for w in ws]
        for d, (xl, _, ol, at) in zip(lane_dys, lanes):
            for dw, dy in zip(dws, d):
                _window_grad(dw[at], xl, dy, ol, win)
        return (dx, None, None, None, None, *dws)


def rolling_matmul_batched(x, ws, offsets, win, names=None, experts=None):
    """Differentiable windowed product; see :class:`RollingMatmulBatched`."""
    return RollingMatmulBatched.apply(x, offsets, win, names, experts, *ws)


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
