"""Flash attention forward: causal or sliding-window GQA online softmax.

Ports ``flash_attention`` of ``repro/kernels/flash_attention.py`` with its
public layout: q ``[B, Sq, H, hd]``, k and v ``[B, Skv, KV, hd]`` ->
``[B, Sq, H, hd]``, GQA groups ``G = H // KV``, ``causal``, ``window`` and
``softmax_scale`` (default ``1 / sqrt(hd)``).  Query and key positions both
start at 0; a key is visible when ``qpos >= kpos`` (causal) and ``qpos -
kpos < window`` (window > 0).  The TPU's ``bq``/``bkv`` block sizes were its
tiling and are gone: any ``Sq`` and ``Skv`` work.  q, k and v are all
float32 or all bfloat16: the bf16 arm (``flash_attn_fwd_bf16``, counted
as ``flash_attention/bf16``) computes what the Pallas body computes on
bf16 operands (float32 scores and softmax, P in float32, the output
rounded once) on bf16 tensor-core passes: q k^T exact in one, P v in two
on P's two bf16 parts, which together lie within 2^-17 P of P.

There is no backward, as the reference has none: with autograd recording,
inputs that require a gradient are refused.

On a CUDA tensor the wrapper launches ``flash_attn_fwd``
(``csrc/flash_attn.cu``) or raises; on a CPU tensor it runs the plain
version, ``kernels.ref.flash_attention_ref``, a transcription of the
Pallas body.  A row of a visited block whose keys are all masked briefly
holds ``exp(0)`` weights until its first visible key rescales them by
exactly 0, in the Pallas body and in the kernel alike (the kernel skips
only key tiles that none of a warp's 16 rows can see); so the two agree
whenever every query row sees at least one key.  Only a window with
``Sq >= Skv + window`` leaves a row without one (the Pallas body would give
it the mean of V over its visited blocks, a value of its tiling), and such
inputs are refused on both devices.

On ``meta`` tensors (the planning path) the wrapper checks its operands as
on the card, returns an empty output and reports its launch's :func:`cost`
to the active counters (``repro_torch.accounting``); on the card it
reports the same cost beside the launch, while a counter is active.
"""
from __future__ import annotations

import math

import torch

from repro_torch import accounting
from repro_torch.kernels import _build, ref

#: head dims the CUDA kernel is built for (its tensor-core tiles and
#: accumulators are compile-time; a multiple of the mma's 8)
HEAD_DIMS = (8, 16, 32, 64, 96, 128)
#: the largest kv head group (G query heads share each K/V tile)
MAX_GROUP = 128


def visible_pairs(Sq, Skv, causal=True, window=0):
    """The (query, key) pairs the mask lets through, query and key
    positions both from 0: ``k <= q`` (causal) and ``q - k < window``
    (window > 0).  In closed form: the pairs with ``q - k <= x`` number
    ``upto(x)``, and the mask keeps ``0 <= q - k <= window - 1``."""
    def upto(x):
        # u = q - x over the query rows: a row sees all Skv keys where
        # u <= 0, Skv - u where 0 < u < Skv, none beyond
        a, b = -x, Sq - 1 - x
        n = Skv * max(0, min(b, 0) - a + 1)
        lo, hi = max(a, 1), min(b, Skv - 1)
        if lo <= hi:
            n += (hi - lo + 1) * (2 * Skv - lo - hi) // 2
        return n
    top = upto(window - 1) if window else Sq * Skv
    return top - (upto(-1) if causal else 0)


def cost(B, Sq, Skv, H, KV, hd, causal=True, window=0,
         dtype=torch.float32):
    """``(flops, hbm_bytes, rate_class)`` of one launch: q k^T and P v over
    the visible pairs only (a causal mask halves the key blocks), 2 * hd
    FLOPs a pair each, per query head.  f32: both products in 3xTF32
    (``tf32x3``); bf16: q k^T in one bf16 pass and P v in two (P's two
    bf16 parts), at the dense bf16 rate.  q and the output ``[B, Sq, H,
    hd]``, k and v ``[B, Skv, KV, hd]``, each moved once."""
    f = 2 * B * H * hd * visible_pairs(Sq, Skv, causal, window)
    esize = dtype.itemsize
    nbytes = esize * (2 * B * Sq * H * hd + 2 * B * Skv * KV * hd)
    if dtype == torch.bfloat16:
        return 3 * f, nbytes, "bfloat16"
    return 2 * f, nbytes, "tf32x3"


def _check(q, k, v, window):
    if len({q.dtype, k.dtype, v.dtype}) != 1 or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"flash attention takes q, k and v of one dtype, "
                        f"float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, Sq, H, hd] and k, v one [B, Skv, "
                         f"KV, hd] shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} "
                         "disagree on batch or head_dim, or H % KV != 0")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need unit stride along head_dim")
    if window > 0 and q.shape[1] >= k.shape[1] + window:
        raise ValueError(f"query rows {k.shape[1] + window - 1}.. of "
                         f"{q.shape[1]} see no key in a window of {window} "
                         f"over {k.shape[1]} keys")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v lie on several devices")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention has no backward (the reference kernel has none "
            "either): call it under torch.no_grad(), or leave "
            "REPRO_USE_FLASH unset to train (ROADMAP.md queue A, flash "
            "attention backward)")


def flash_attention(q, k, v, *, causal=True, window=0, softmax_scale=None):
    """``softmax(scale * q k^T + mask) v`` per query head, over the keys of
    its kv head; see the module docstring."""
    _check(q, k, v, window)
    scale = softmax_scale or 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softmax_scale=scale)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    if hd not in HEAD_DIMS or G > MAX_GROUP:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS} and "
                         f"groups of at most {MAX_GROUP}; got {hd}, {G}")
    if accounting.ACTIVE:
        accounting.declare(
            "flash_attention" + ("/bf16" if q.dtype == torch.bfloat16
                                 else ""),
            *cost(B, Sq, Skv, H, KV, hd, causal, window, q.dtype))
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if q.device.type == "meta":
        return out
    strides = [t.stride(i) for t in (q, k, v, out) for i in (0, 1, 2)]
    _build.launch(
        "flash_attn_fwd", "flash_attention", q.dtype, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides, B, KV, G, Sq,
        Skv, hd, int(bool(causal)), int(window), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    return out
