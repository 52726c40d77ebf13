"""Plain PyTorch versions of the port's kernels.

They define what each CUDA kernel computes.  The wrappers take them only
for tensors on the CPU; the CPU tests hold them against the JAX
reference, and ``chip_smoke.py`` holds each kernel against them on the card.
``offsets`` are host integers, one per client.

The products and updates take float32 or bfloat16 operands.  At bf16 they
compute what the Pallas bodies compute: the products in float32 on the
widened operands, the updates' arithmetic in float32 in the f32 arms'
order, each result rounded once to bf16 (never a bf16 operation that
rounds twice).  At float32 every ``.float()`` and ``.to(dtype)`` below is
the tensor itself, so the f32 arms are unchanged.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NEG_INF = -1e30


def shared_offset(offsets):
    """The one offset every client shares, or None."""
    return offsets[0] if len(set(offsets)) == 1 else None


def window_columns(w, offsets, win):
    """``w [C, K, N]`` narrowed to each client's columns ``[offsets[c],
    offsets[c] + win)``: a view for a shared window, else one contiguous
    ``[C, K, win]`` stack, laid out as the extract client phase's compact
    copies."""
    o = shared_offset(offsets)
    if o is not None:
        return w[:, :, o:o + win]
    return torch.stack([w[c, :, oc:oc + win] for c, oc in enumerate(offsets)])


def rolling_matmul_batched_ref(x, ws, offsets, win):
    """``ys[t][c] = x[c] @ ws[t][c][:, offsets[c] : offsets[c] + win]``
    (the reference's ``rolling_matmul_ref`` per client, per weight): one
    ``bmm`` on the clients' windows, the product the extract client phase
    takes on its compact copies (the same bits); at bf16 the float32
    product of the widened operands, rounded once (``preferred_element_type
    =float32``, then the cast to x's dtype)."""
    return tuple(torch.bmm(x.float(), window_columns(w, offsets, win).float())
                 .to(x.dtype) for w in ws)


def rolling_matmul_batched_dx_ref(dys, ws, offsets, win):
    """``dx[c] = sum_t dys[t][c] @ ws[t][c][:, offsets[c] : offsets[c] +
    win]^T``, summed over t in order (the reference's pairwise sum), one
    ``bmm`` per weight, as the forward; at bf16 in float32, the sum over t
    too, rounded once."""
    out = None
    for dy, w in zip(dys, ws):
        term = torch.bmm(dy.float(), window_columns(w, offsets, win).float().mT)
        out = term if out is None else out + term
    return out.to(dys[0].dtype)


def sgd_ref(w, g, lr):
    """``w <- w - lr * g`` in place, rounding the product and the difference
    separately as the reference's ``p - lr * g`` does; returns ``w``.  At
    bf16 the same in float32, rounded once into w."""
    if w.dtype == torch.float32:
        return w.sub_(g * lr)
    return w.copy_(w.float() - g.float() * lr)


def masked_sgd_ref(w, m, g, lr):
    """``w <- w - (lr * m) * g`` in place: the product rounds first, then
    the difference, as the reference's ``p - lr * m * g``; returns ``w``.
    At bf16 the same in float32, rounded once into w."""
    lr = float(np.float32(lr))
    if w.dtype == torch.float32:
        return w.sub_(m * lr * g)
    return w.copy_(w.float() - m.float() * lr * g.float())


def fillin_agg_ref(w, w_clients, m_clients, scale):
    """``w <- w + scale * acc`` in place, ``acc = sum_c m_c * (w_c - w)``
    summed over c = 0 .. C-1 in order from 0 (the reference's
    ``_fillin_kernel``); ``scale`` (``server_lr / C``) is rounded once to
    float32.  ``w_clients`` and ``m_clients`` are ``[C, *w.shape]``;
    returns ``w``.  At bf16 the sum and the update run in float32 on the
    widened operands, rounded once into w."""
    wf = w.float()
    acc = torch.zeros_like(wf)
    for wc, mc in zip(w_clients, m_clients):
        acc += mc.float() * (wc.float() - wf)
    scale = float(np.float32(scale))
    if w.dtype == torch.float32:
        return w.add_(acc * scale)
    return w.copy_(wf + acc * scale)


def flash_attention_ref(q, k, v, *, causal=True, window=0,
                        softmax_scale=None, bq=512, bkv=512):
    """The Pallas flash kernel's body (``repro/kernels/flash_attention.py``
    ``_flash_kernel``) in plain torch, block for block: q ``[B, Sq, H,
    hd]``, k and v ``[B, Skv, KV, hd]`` -> ``[B, Sq, H, hd]``.  For each
    ``bq`` tile of queries, the ``bkv`` tiles of keys in order, skipping
    those wholly above the causal diagonal or outside the window; scores
    masked to ``-1e30``; the online softmax; ``acc / max(l, 1e-30)``.  A
    ragged last tile is simply shorter (the reference asserts that the
    tiles divide the lengths).  bf16 q, k and v are widened at the load,
    as the body's ``astype(float32)``, P stays float32 and the output is
    rounded once to q's dtype."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = softmax_scale or 1.0 / math.sqrt(hd)
    bq, bkv = min(bq, Sq), min(bkv, Skv)
    qg = q.float().reshape(B, Sq, KV, G, hd).permute(0, 2, 1, 3, 4) \
        .reshape(B * KV, Sq, G, hd)
    kg = k.float().permute(0, 2, 1, 3).reshape(B * KV, Skv, hd)
    vg = v.float().permute(0, 2, 1, 3).reshape(B * KV, Skv, hd)
    out = torch.empty_like(qg)
    for q0 in range(0, Sq, bq):
        qb = qg[:, q0:q0 + bq]                       # [B*KV, n, G, hd]
        n = qb.shape[1]
        qpos = (q0 + torch.arange(n, device=q.device))[:, None, None]
        m = torch.full(qb.shape[:3], NEG_INF, device=q.device)
        l = torch.zeros(qb.shape[:3], device=q.device)
        acc = torch.zeros(qb.shape, device=q.device)
        for k0 in range(0, Skv, bkv):
            nk = min(bkv, Skv - k0)
            if causal and k0 > q0 + n - 1:
                continue
            if window and k0 + nk - 1 < q0 - window + 1:
                continue
            kb, vb = kg[:, k0:k0 + nk], vg[:, k0:k0 + nk]
            s = torch.einsum("bqgd,bsd->bqgs", qb, kb) * scale
            kpos = k0 + torch.arange(nk, device=q.device)
            valid = torch.ones((n, 1, nk), dtype=torch.bool, device=q.device)
            if causal:
                valid = valid & (qpos >= kpos)
            if window:
                valid = valid & ((qpos - kpos) < window)
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bqgs,bsd->bqgd", p,
                                                       vb)
            m = m_new
        out[:, q0:q0 + n] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, KV, Sq, G, hd).permute(0, 2, 1, 3, 4) \
        .reshape(B, Sq, H, hd).to(q.dtype)


def ssd_chunk_intra_ref(x, dt, A, B, C):
    """The Pallas body ``_ssd_chunk_kernel`` (``repro/kernels/ssd_chunk.py``)
    in plain torch, for every (batch, chunk) and all heads at once: x
    ``[Bt, nc, Q, nh, hd]``, dt ``[Bt, nc, Q, nh]``, A ``[nh]``, B and C
    ``[Bt, nc, Q, N]`` -> ``(y [Bt, nc, Q, nh, hd], states [Bt, nc, nh, hd,
    N])``.  The body's order of operations: ``L = cumsum(dt * A)``
    (inclusive), ``diff = L_q - L_t``, ``where(causal, exp(diff), 0)``,
    ``M = (C B^T * decay) * dt_t``, ``y = M x``; the state ``sum_t exp(L_last
    - L_t) * dt_t * x_t (x) B_t``.  One batch row at a time, so the ``[nc,
    nh, Q, Q]`` decay tensor is the largest temporary.  bf16 x, dt, B and
    C are widened at the load, as the body's ``astype(float32)``; y is
    rounded once to x's dtype and the states stay float32."""
    Q = x.shape[2]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    ys, states = [], []
    for b in range(x.shape[0]):
        xb, dtb = x[b].float(), dt[b].float()            # [nc,Q,nh,hd]
        Bb, Cb = B[b].float(), C[b].float()              # [nc,Q,N]
        L = torch.cumsum(dtb * A.float(), dim=1)         # [nc,Q,nh]
        CB = torch.einsum("cqn,ctn->cqt", Cb, Bb)        # [nc,Q,Q]
        Lh = L.transpose(1, 2)                           # [nc,nh,Q]
        diff = Lh[..., :, None] - Lh[..., None, :]       # [nc,nh,Q,Q]
        decay = torch.where(causal, torch.exp(diff), 0.0)
        del diff
        dth = dtb.transpose(1, 2)                        # [nc,nh,Q]
        M = CB[:, None] * decay * dth[:, :, None, :]
        del decay
        ys.append(torch.einsum("chqt,cthp->cqhp", M, xb))
        del M
        sdecay = torch.exp(Lh[..., -1:] - Lh) * dth      # [nc,nh,Q]
        states.append(torch.einsum("cthp,ctn,cht->chpn", xb, Bb, sdecay))
    return (torch.stack(ys).to(x.dtype), torch.stack(states))


def ssd_chunk_ref(x, dt, A, B, C):
    """Sequential (recurrent) oracle for one chunk of SSD (the reference's
    ``repro/kernels/ref.py`` ``ssd_chunk_ref``): x ``[Q, nh, hd]``, dt
    ``[Q, nh]``, A ``[nh]``, B and C ``[Q, N]`` -> ``(y [Q, nh, hd], final
    state [nh, hd, N])``, one step per position."""
    Q, nh, hd = x.shape
    h = torch.zeros((nh, hd, B.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(Q):
        decay = torch.exp(dt[t] * A)                     # [nh]
        h = h * decay[:, None, None] + torch.einsum(
            "hp,n,h->hpn", x[t].float(), B[t], dt[t])
        ys.append(torch.einsum("hpn,n->hp", h, C[t]))
    return torch.stack(ys), h
