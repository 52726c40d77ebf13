"""The intra-chunk SSD block of Mamba-2, and the chunked SSD built on it.

Ports ``ssd_chunk_intra`` of ``repro/kernels/ssd_chunk.py`` (with its
head-window variant) and ``ssd_chunk_scan`` of ``repro/kernels/ops.py``.
For each (batch, chunk, head), with ``L = cumsum(dt * A)`` over the chunk::

    y = ((C B^T) * exp(L_q - L_t) * 1[q >= t] * dt_t) x
    S = sum_t exp(L_last - L_t) * dt_t * x_t (x) B_t

On a CUDA tensor :func:`ssd_chunk_intra` launches ``ssd_chunk_intra_fwd``
(``csrc/ssd_chunk.cu``) or raises; on a CPU tensor it runs the plain
version, ``kernels.ref.ssd_chunk_intra_ref``, a transcription of the Pallas
body.  The TPU's head block (``nh_block``) and its rule that a window's
offset be a multiple of it were its tiling: any ``head_offset`` works.
x, dt, B and C are all float32 or all bfloat16 (A is float32); the bf16
arm (``ssd_chunk_intra_fwd_bf16``, counted as ``ssd_chunk_intra/bf16``)
computes what the Pallas body computes at bf16 (its inputs widened, y
rounded once to bf16, the states float32) in one kernel on bf16 tensor-core
passes: ``C B^T`` exactly in one, ``M x`` and the state in two, on the two
bf16 parts ``hi = bf16(v)``, ``lo = bf16(v - hi)`` of the float32 weighted
operand (M, and x times the state's key weights), within 2^-17 of it; it
reads each head's x once for y and the state alike.  There is no
backward, as the reference kernel has none: with autograd recording,
inputs that require a gradient are refused, and the message points to
``models.ssm.ssd_chunked``, the differentiable transcription the
federated round trains through (a backward kernel is ROADMAP.md queue B,
beta 1).

:func:`ssd_chunk_scan` is the kernel plus the inter-chunk recurrence in
plain torch (a loop over chunks, as the reference's ``lax.scan``), with the
contract of ``repro.models.ssm.ssd_chunked``.

On ``meta`` tensors (the planning path) :func:`ssd_chunk_intra` checks its
operands as on the card, returns empty outputs and reports its launch's
:func:`cost` to the active counters (``repro_torch.accounting``); on the
card it reports the same cost beside the launch, while a counter is
active.
"""
from __future__ import annotations

import torch

from repro_torch import accounting
from repro_torch.kernels import _build, ref

#: head dims the CUDA kernel is built for (its tiles are compile-time)
HEAD_DIMS = (16, 32, 64, 128)
#: the largest chunk and state the kernel's shared memory holds
MAX_Q, MAX_N = 256, 128
#: the profiler range around the inter-chunk loop (its launches and time)
RECURRENCE = "ssd_chunk_scan.recurrence"


def cost(Bt, nc, Q, nh, hd, N, dtype=torch.float32):
    """``(flops, hbm_bytes, rate_class)`` of one launch over ``nh`` heads
    (the head window): per (batch, chunk) ``C B^T`` over the chunk's
    causal pairs once (it does not depend on the head), and per head ``M
    x`` over the same pairs and the chunk-exit state, 2 FLOPs a
    multiply-add.  f32: all in 3xTF32 (``tf32x3``); bf16: ``C B^T`` in one
    bf16 pass and ``M x`` and the state in two (their f32 weights' two
    bf16 parts), at the dense bf16 rate.  x and y ``[Bt, nc, Q, nh, hd]``,
    dt, B and C in the operands' dtype, A and the states float32, each
    moved once."""
    pairs = Q * (Q + 1) // 2
    f_cb = Bt * nc * 2 * pairs * N
    f_rest = Bt * nc * nh * (2 * pairs * hd + 2 * Q * hd * N)
    esize = dtype.itemsize
    nbytes = (esize * (2 * Bt * nc * Q * nh * hd + Bt * nc * Q * nh
                       + 2 * Bt * nc * Q * N)
              + 4 * (nh + Bt * nc * nh * hd * N))
    if dtype == torch.bfloat16:
        return f_cb + 2 * f_rest, nbytes, "bfloat16"
    return f_cb + f_rest, nbytes, "tf32x3"


def _check(x, dt, A, B, C, head_offset, head_win):
    """Validate the operands; returns the head window ``(offset, win)``."""
    ts = (x, dt, A, B, C)
    if len({t.dtype for t in (x, dt, B, C)}) != 1 or x.dtype not in (
            torch.float32, torch.bfloat16) or A.dtype != torch.float32:
        raise TypeError(
            f"ssd_chunk_intra takes x, dt, B and C of one dtype, float32 or "
            f"bfloat16, and float32 A; got {[str(t.dtype) for t in ts]}")
    if x.dim() != 5 or dt.shape != x.shape[:4] or A.shape != x.shape[3:4] \
            or B.dim() != 4 or B.shape != C.shape \
            or B.shape[:3] != x.shape[:3]:
        raise ValueError(
            f"want x [Bt, nc, Q, nh, hd], dt [Bt, nc, Q, nh], A [nh], B and "
            f"C [Bt, nc, Q, N]; got {tuple(x.shape)}, {tuple(dt.shape)}, "
            f"{tuple(A.shape)}, {tuple(B.shape)}, {tuple(C.shape)}")
    if len({t.device for t in ts}) != 1:
        raise ValueError("x, dt, A, B and C lie on several devices")
    if any(t.stride(-1) != 1 for t in (x, A, B, C)):
        raise ValueError("x, A, B and C need unit stride along their last "
                         "axis")
    nh = x.shape[3]
    off = 0 if head_offset is None else int(head_offset)
    win = int(head_win) or nh - off
    if head_offset is None and win != nh:
        raise ValueError("head_win needs a head_offset")
    if off < 0 or win < 1 or off + win > nh:
        raise ValueError(f"head window [{off}, {off + win}) is not inside "
                         f"the {nh} heads")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "the SSD chunk kernel has no backward (the reference kernel has "
            "none either): call it under torch.no_grad(), or train through "
            "the differentiable models.ssm.ssd_chunked, as the federated "
            "round's [C, ...] form does")
    return off, win


def ssd_chunk_intra(x, dt, A, B, C, *, head_offset=None, head_win=0):
    """x ``[Bt, nc, Q, nh, hd]``; dt ``[Bt, nc, Q, nh]``; A ``[nh]``; B, C
    ``[Bt, nc, Q, N]``.  Returns ``(y [Bt, nc, Q, win, hd], states [Bt, nc,
    win, hd, N])`` for the heads ``head_offset .. head_offset + head_win -
    1`` (all ``nh`` when ``head_offset`` is None)."""
    off, win = _check(x, dt, A, B, C, head_offset, head_win)
    if x.device.type == "cpu":
        heads = slice(off, off + win)
        return ref.ssd_chunk_intra_ref(x[..., heads, :], dt[..., heads],
                                       A[heads], B, C)
    Bt, nc, Q, nh, hd = x.shape
    N = B.shape[-1]
    if hd not in HEAD_DIMS or Q > MAX_Q or N > MAX_N:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS}, "
                         f"chunks of at most {MAX_Q} and d_state of at most "
                         f"{MAX_N}; got {hd}, {Q}, {N}")
    if accounting.ACTIVE:
        accounting.declare(
            "ssd_chunk_intra" + ("/bf16" if x.dtype == torch.bfloat16
                                 else ""),
            *cost(Bt, nc, Q, win, hd, N, x.dtype))
    y = torch.empty((Bt, nc, Q, win, hd), dtype=x.dtype, device=x.device)
    states = torch.empty((Bt, nc, win, hd, N), dtype=torch.float32,
                         device=x.device)
    if x.device.type == "meta":
        return y, states
    strides = ([x.stride(i) for i in range(4)] + list(dt.stride())
               + [B.stride(i) for i in range(3)]
               + [C.stride(i) for i in range(3)])
    _build.launch(
        "ssd_chunk_intra_fwd", "ssd_chunk_intra", x.dtype, x.data_ptr(),
        dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), states.data_ptr(), *strides, Bt, nc, Q, nh, hd, N, off,
        win, torch.cuda.current_stream(x.device).cuda_stream)
    return y, states


def ssd_chunk_scan(xr, dt, A, Br, Cr, chunk, head_offset=None, head_win=0):
    """Chunked SSD: xr ``[B, S, nh, hd]``, dt ``[B, S, nh]``, A ``[nh]``,
    Br and Cr ``[B, S, N]`` -> ``(y [B, S, win, hd], final state [B, win,
    hd, N])``.  The chunk is ``min(chunk, S)``; ``S`` must be a multiple of
    it (the reference's reshape fails otherwise).  ``head_offset`` /
    ``head_win`` window the mixer over a contiguous range of heads of
    full-width inputs; the recurrence then sees the same heads."""
    Bsz, S, nh, hd = xr.shape
    N = Br.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"a sequence of {S} is not a whole number of "
                         f"chunks of {Q}")
    nc = S // Q
    xs = xr.reshape(Bsz, nc, Q, nh, hd)
    dts = dt.reshape(Bsz, nc, Q, nh)
    Bs = Br.reshape(Bsz, nc, Q, N)
    Cs = Cr.reshape(Bsz, nc, Q, N)
    y_intra, states = ssd_chunk_intra(xs, dts, A, Bs, Cs,
                                      head_offset=head_offset,
                                      head_win=head_win)
    if head_offset is not None:
        win = states.shape[2]
        dts = dts[..., head_offset:head_offset + win]
        A = A[head_offset:head_offset + win]
        nh = win

    dA = dts * A
    L = torch.cumsum(dA, dim=2)
    decay = torch.exp(dA.sum(2))                        # [B, nc, nh]
    h = torch.zeros((Bsz, nh, hd, N), dtype=torch.float32, device=xr.device)
    h_entry = torch.empty_like(states)                  # state at each entry
    with torch.profiler.record_function(RECURRENCE):
        for c in range(nc):
            h_entry[:, c] = h
            h = h * decay[:, c, :, None, None] + states[:, c]
    del states
    # summed in float32 on the widened operands, the entry states rounded
    # to Cs's dtype first (the reference's ``ops.ssd_chunk_scan``)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cs.float(),
                           h_entry.to(Cs.dtype).float())
    del h_entry
    y_inter = y_inter * torch.exp(L)[..., None].to(y_inter.dtype)
    y = (y_intra.float() + y_inter).reshape(Bsz, S, nh, hd)
    return y.to(xr.dtype), h
