"""Attention: GQA and MLA, each in training, prefill and decode.

Ports ``attn_params`` (with the ``qk_norm`` leaves), ``_qkv``,
``blockwise_attention``, ``gqa_train``, ``gqa_prefill``, ``gqa_decode``,
``decode_attention``, ``cp_decode_attention``, and the MLA module
(``mla_params``, ``_mla_q``, ``_mla_ckv``, ``mla_train``, ``mla_prefill``,
``mla_decode``) of ``repro/models/attention.py``.  MLA trains and
prefills on the decompressed path (per-head keys and values through
blockwise attention, which has no flash branch in the reference either)
and decodes on the absorbed one (attention over the compressed cache).
``blockwise_attention`` is plain jnp in the reference, so it is plain torch
here: the same online softmax over kv chunks, with the same chunk bounds
for causal and sliding-window masks.  Under ``REPRO_USE_FLASH`` training
attention runs the flash kernel instead (forward only; see
:func:`gqa_train`); prefill runs blockwise attention, as the reference's
does.  Activations and weights carry the leading client dimension ``[C,
...]`` (one model is C = 1); a KV cache is ``[C, B, Sc, KV, hd]``.
Context-parallel decode splits the cache's positions over a mesh axis of
``torch.distributed`` ranks, each rank holding its contiguous block.
"""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (ParamBuilder, apply_rope, bmm,
                                       einsum, head_proj, rms_norm)
from repro_torch.sharding import spmd

NEG_INF = -1e30


def attn_params(b: ParamBuilder, prefix, cfg):
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b.dense(f"{prefix}/wq", (D, H, hd), ("d_model", "heads", "head_dim"))
    b.dense(f"{prefix}/wk", (D, KV, hd), ("d_model", "kv_heads", "head_dim"))
    b.dense(f"{prefix}/wv", (D, KV, hd), ("d_model", "kv_heads", "head_dim"))
    b.dense(f"{prefix}/wo", (H, hd, D), ("heads", "head_dim", "d_model"),
            scale=0.02 / math.sqrt(2 * max(cfg.n_layers, 1)))
    if cfg.qk_norm:
        b.const(f"{prefix}/q_norm", (hd,), ("head_dim",), 1.0)
        b.const(f"{prefix}/k_norm", (hd,), ("head_dim",), 1.0)


def blockwise_attention(q, k, v, *, causal=True, window=0, q_chunk=512,
                        kv_chunk=512, softmax_scale=None):
    """q ``[B, Sq, H, hd]``; k, v ``[B, Sk, KV, hd]``; H % KV == 0.
    Returns ``[B, Sq, H, hd]``.  Only the kv chunks a q chunk can see are
    visited.  QK^T and P V are summed in float32 on widened operands (the
    reference's ``preferred_element_type=float32``): at bf16 no score and
    no partial sum is rounded to 8 mantissa bits; P is cast to V's dtype
    first, as in the reference."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = softmax_scale or 1.0 / math.sqrt(hd)
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Sk)
    nq, nk = Sq // q_chunk, Sk // kv_chunk
    qg = q.reshape(B, Sq, KV, G, hd)
    q_off = Sk - Sq                     # q positions = q_off + [0..Sq)
    ar_q = torch.arange(q_chunk, device=q.device)
    ar_k = torch.arange(kv_chunk, device=q.device)
    outs = []
    for qi in range(nq):
        qc = qg[:, qi * q_chunk:(qi + 1) * q_chunk]   # [B, Qc, KV, G, hd]
        qpos = q_off + qi * q_chunk + ar_q
        m = torch.full((B, KV, G, q_chunk), NEG_INF, device=q.device)
        l = torch.zeros((B, KV, G, q_chunk), device=q.device)
        acc = torch.zeros((B, KV, G, q_chunk, hd), device=q.device)
        if causal or window:
            last = (q_off + (qi + 1) * q_chunk - 1) // kv_chunk
            first = (max(0, (q_off + qi * q_chunk - window + 1) // kv_chunk)
                     if window else 0)
            kv_range = range(first, last + 1)
        else:
            kv_range = range(nk)
        for kj in kv_range:
            kc = k[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            vc = v[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            kpos = kj * kv_chunk + ar_k
            s = torch.einsum("bqkgd,bskd->bkgqs", qc.float(),
                             kc.float()) * scale
            valid = (qpos[:, None] >= kpos[None, :] if causal else
                     torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                                device=q.device))
            if window:
                valid = valid & ((qpos[:, None] - kpos[None, :]) < window)
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(vc.dtype).float(), vc.float())
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        # [B, KV, G, Qc, hd] -> [B, Qc, H, hd]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


def _qkv(p, x, cfg, positions, window=None):
    """q/k/v projections; ``window`` (a ``WindowMap`` or None) windows the
    q heads and the k/v kv-heads (GQA-coupled upstream by the scheme).
    With ``cfg.qk_norm`` q and k are RMS-normalised per head before RoPE,
    in training, prefill and decode alike."""
    hspec = window.get("heads", p["wq"].shape[2]) if window else None
    kvspec = window.get("kv_heads", p["wk"].shape[2]) if window else None
    q = head_proj(x, p["wq"], hspec)
    k = head_proj(x, p["wk"], kvspec)
    v = head_proj(x, p["wv"], kvspec)
    if cfg.qk_norm:
        # per-head RMS norm over head_dim (Qwen3), before the rotation
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_train(p, x, cfg, positions, window=None):
    """x ``[C, B, S, D]`` with per-client weights ``[C, ...]``; the client
    dimension folds into attention's batch.

    With ``REPRO_USE_FLASH`` set (to anything non-empty), attention runs the flash kernel
    (``kernels.flash_attention``), as the reference's does.  The reference
    reads the switch once, at import; the port reads it at every call, so
    one process can train with blockwise attention and evaluate with
    flash.  The flash kernel has no backward (the reference's has none
    either): under the switch, q, k and v must not require a gradient
    (evaluate under ``torch.no_grad()``), or ``NotImplementedError`` is
    raised."""
    C, B, S, D = x.shape
    q, k, v = _qkv(p, x, cfg, positions, window=window)
    fold = (lambda t: t.reshape(C * B, S, t.shape[-2], t.shape[-1]))
    attend = (flash_attention if os.environ.get("REPRO_USE_FLASH")
              else blockwise_attention)
    out = attend(fold(q), fold(k), fold(v), causal=True,
                 window=cfg.sliding_window)
    wo = p["wo"]
    hspec = window.get("heads", wo.shape[1]) if window else None
    if hspec is not None:
        # the contraction runs over the active heads only: each client's
        # window of the output projection's rows (a view for a shared
        # window; grads land as exact zeros outside)
        wo = hspec.take(wo)
    Hw, hd = wo.shape[1], wo.shape[2]
    out = bmm(out.reshape(C, B * S, Hw * hd), wo.reshape(C, Hw * hd, D))
    return out.reshape(C, B, S, D)


def gqa_prefill(p, x, cfg, positions, cache_len):
    """x ``[C, B, S, D]``: attention over the prompt and its KV cache of
    ``cache_len`` positions.  When ``cache_len < S`` (a sliding window) the
    cache is a ring holding the last ``cache_len`` keys, rolled so that
    position ``i`` sits in slot ``i % cache_len``."""
    C, B, S, D = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    fold = (lambda t: t.reshape(C * B, S, t.shape[-2], t.shape[-1]))
    out = blockwise_attention(fold(q), fold(k), fold(v), causal=True,
                              window=cfg.sliding_window)
    if cache_len < S:
        shift = (S - cache_len) % cache_len if cache_len else 0
        kc = torch.roll(k[:, :, -cache_len:], shift, dims=2)
        vc = torch.roll(v[:, :, -cache_len:], shift, dims=2)
    else:
        kc, vc = k, v
    wo = p["wo"]
    H, hd = wo.shape[1], wo.shape[2]
    out = bmm(out.reshape(C, B * S, H * hd), wo.reshape(C, H * hd, D))
    return out.reshape(C, B, S, D), {"k": kc, "v": vc}


def decode_attention(q, k, v, valid, softmax_scale=None):
    """q ``[B, H, hd]``; k, v ``[B, Sc, KV, hd]``; valid ``[B, Sc]`` bool.
    Returns ``[B, H, hd]`` float32.  Both products sum in float32, as in
    :func:`blockwise_attention`."""
    B, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = softmax_scale or 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * scale
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, H, -1)


def cp_decode_attention(mesh, q, k, v, valid, axis="data",
                        softmax_scale=None):
    """Context-parallel exact decode attention: q ``[B, H, hd]`` on every
    rank of mesh axis ``axis``; k, v ``[B, Sl, KV, hd]`` and valid ``[B,
    Sl]`` this rank's contiguous block of the cache's positions.  Local
    scores summed in float32, then one all-reduce MAX and two all-reduce
    SUMs over the axis (linear in the local positions).  Returns ``[B, H,
    hd]`` float32 on every rank.  Every rank computes every head (the
    reference splits heads over ``model``; the results are equal)."""
    B, H, hd = q.shape
    KV = k.shape[2]
    scale = softmax_scale or 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * scale
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = spmd.all_reduce_max(mesh, axis, s.amax(-1))
    p = torch.exp(s - m[..., None])
    l = spmd.all_reduce_sum(mesh, axis, p.sum(-1))
    o = spmd.all_reduce_sum(mesh, axis, torch.einsum(
        "bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float()))
    return (o / torch.clamp_min(l, 1e-30)[..., None]).reshape(B, H, -1)


def _cp_block(mesh, cp, S_local):
    """``(first position, global length)`` of this rank's block of a
    cache split over the ``data`` axis (``cp`` and a mesh), else ``(0,
    S_local)``."""
    if not (cp and mesh is not None):
        return 0, S_local
    return (spmd.axis_index(mesh, "data") * S_local,
            spmd.axis_size(mesh, "data") * S_local)


def _attend(q, k, v, valid, mesh, cp, softmax_scale=None):
    """Decode attention over ``[N, S, KV, hd]`` caches: context-parallel
    (the local block) with ``cp`` and a mesh, else plain."""
    if cp and mesh is not None:
        return cp_decode_attention(mesh, q, k, v, valid,
                                   softmax_scale=softmax_scale)
    return decode_attention(q, k, v, valid, softmax_scale=softmax_scale)


def gqa_decode(p, x, cfg, cache, pos, mesh=None, cp=False,
               valid_override=None, rope_pos=None):
    """x ``[C, B, 1, D]``; cache ``{k, v: [C, B, Sc, KV, hd]}``; ``pos`` the
    host integer position of the token (cache write slot ``pos % Sc`` and
    causal horizon).  ``valid_override [B, Sc]`` bool: per-slot cache
    validity; ``rope_pos [B]``: per-row positions (continuous batching).
    With ``cp`` and ``mesh`` the cache is this rank's contiguous block of
    the ``Sc`` slots, split over the mesh's ``data`` axis: the rank that
    holds slot ``pos % Sc`` writes the token's k and v, validity
    (``valid_override`` too, given for all ``Sc`` slots) is cut to the
    block, and attention is :func:`cp_decode_attention`.  Returns ``(out
    [C, B, 1, D], new cache)``; the cache passed in is not changed."""
    C, B = x.shape[:2]
    pos = int(pos)
    positions = (rope_pos[:, None] if rope_pos is not None else
                 torch.full((B, 1), pos, device=x.device))
    q, k, v = _qkv(p, x, cfg, positions)               # [C, B, 1, ., hd]
    Sl = cache["k"].shape[2]
    lo, Sc = _cp_block(mesh, cp, Sl)
    slot = pos % Sc - lo
    kc, vc = cache["k"].clone(), cache["v"].clone()
    if 0 <= slot < Sl:
        kc[:, :, slot] = k[:, :, 0]
        vc[:, :, slot] = v[:, :, 0]
    idx = torch.arange(Sc, device=x.device)
    if valid_override is not None:
        valid = valid_override
    elif cfg.sliding_window and Sc <= cfg.sliding_window:
        # the ring is fully valid once it has wrapped
        valid = ((idx <= pos) | (pos + 1 >= Sc)).expand(B, Sc)
    else:
        valid = (idx <= pos).expand(B, Sc)
    valid = valid[:, lo:lo + Sl]
    H, hd = q.shape[-2], q.shape[-1]
    out = _attend(q.reshape(C * B, H, hd),
                  kc.reshape(C * B, Sl, *kc.shape[3:]),
                  vc.reshape(C * B, Sl, *vc.shape[3:]),
                  valid.repeat(C, 1), mesh, cp)
    wo = p["wo"]
    out = bmm(out.reshape(C, B, H * hd).to(x.dtype),
              wo.reshape(C, H * hd, wo.shape[-1]))
    return out[:, :, None], {"k": kc, "v": vc}


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def mla_params(b: ParamBuilder, prefix, cfg):
    m, D, H = cfg.mla, cfg.d_model, cfg.n_heads
    qh = m.nope_head_dim + m.rope_head_dim
    b.dense(f"{prefix}/w_dq", (D, m.q_lora_rank), ("d_model", "mla_q_rank"))
    b.const(f"{prefix}/q_norm", (m.q_lora_rank,), ("mla_q_rank",), 1.0)
    b.dense(f"{prefix}/w_uq", (m.q_lora_rank, H, qh),
            ("mla_q_rank", "heads", "head_dim"))
    b.dense(f"{prefix}/w_dkv", (D, m.kv_lora_rank),
            ("d_model", "mla_kv_rank"))
    b.const(f"{prefix}/kv_norm", (m.kv_lora_rank,), ("mla_kv_rank",), 1.0)
    b.dense(f"{prefix}/w_kr", (D, m.rope_head_dim), ("d_model", "rope_dim"))
    b.dense(f"{prefix}/w_uk", (m.kv_lora_rank, H, m.nope_head_dim),
            ("mla_kv_rank", "heads", "head_dim"))
    b.dense(f"{prefix}/w_uv", (m.kv_lora_rank, H, m.v_head_dim),
            ("mla_kv_rank", "heads", "v_head_dim"))
    b.dense(f"{prefix}/wo", (H, m.v_head_dim, D),
            ("heads", "v_head_dim", "d_model"),
            scale=0.02 / math.sqrt(2 * max(cfg.n_layers, 1)))


def _lin(x, w):
    """``x [C, *lead, K] @ w [C, K, N]`` -> ``[C, *lead, N]`` (float32
    sums, one rounding: ``layers.bmm``)."""
    C, K = x.shape[0], x.shape[-1]
    y = bmm(x.reshape(C, -1, K), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _mla_q(p, x, cfg, positions, hspec=None):
    """The queries: ``w_dq``, the RMS ``q_norm``, the per-head up-projection
    ``w_uq`` (windowed by ``hspec``), split into the no-rope part and the
    rope part, RoPE on the latter."""
    m = cfg.mla
    cq = rms_norm(_lin(x, p["w_dq"]), p["q_norm"], cfg.norm_eps)
    q = head_proj(cq, p["w_uq"], hspec)
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_ckv(p, x, cfg, positions):
    """The compressed kv ``c [C, *lead, r]`` (RMS ``kv_norm``) and the
    shared rope key ``kr [C, *lead, rd]``."""
    c = rms_norm(_lin(x, p["w_dkv"]), p["kv_norm"], cfg.norm_eps)
    kr = apply_rope(_lin(x, p["w_kr"])[..., None, :], positions,
                    cfg.rope_theta)[..., 0, :]
    return c, kr


def _mla_attend(p, x, cfg, positions, hspec):
    """The decompressed path on ``x [C, B, S, D]``; returns the output and
    the compressed ``c``, ``kr`` it attended over."""
    m = cfg.mla
    C, B, S, D = x.shape
    q_nope, q_rope = _mla_q(p, x, cfg, positions, hspec)
    c, kr = _mla_ckv(p, x, cfg, positions)
    k_nope = head_proj(c, p["w_uk"], hspec)
    v = head_proj(c, p["w_uv"], hspec)
    k_rope = kr[..., None, :].expand(*k_nope.shape[:-1], m.rope_head_dim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope], -1)
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    # v padded to k's head_dim so that the two share hd, then sliced back
    vp = F.pad(v, (0, k.shape[-1] - v.shape[-1]))
    fold = (lambda t: t.reshape(C * B, S, t.shape[-2], t.shape[-1]))
    out = blockwise_attention(fold(q), fold(k), fold(vp), causal=True,
                              softmax_scale=scale)[..., :m.v_head_dim]
    wo = p["wo"]
    if hspec is not None:
        # the contraction runs over the active heads only
        wo = hspec.take(wo)
    Hw = wo.shape[1]
    out = bmm(out.reshape(C, B * S, Hw * m.v_head_dim),
              wo.reshape(C, Hw * m.v_head_dim, D))
    return out.reshape(C, B, S, D), c, kr


def mla_train(p, x, cfg, positions, window=None):
    """The decompressed path: per-head ``k_nope`` and ``v`` come from the
    compressed ``c`` through ``w_uk``/``w_uv``, the one rope key is shared
    by every head, and blockwise attention runs at ``softmax_scale = 1 /
    sqrt(nope + rope)``.  ``window`` (a ``WindowMap`` or None) applies a
    *standalone* ``heads`` window: every head draws its k/v from the shared
    ``c``, so there is no kv grouping to couple to, and the per-head
    up-projections (``w_uq``/``w_uk``/``w_uv``) are windowed on their own
    through :func:`head_proj`, ``wo`` contracting over the active heads
    only.  The low-rank down-projections, the norms and the rope key stay
    full (they carry no ``heads`` axis)."""
    hspec = window.get("heads", p["wo"].shape[1]) if window else None
    return _mla_attend(p, x, cfg, positions, hspec)[0]


def mla_prefill(p, x, cfg, positions):
    """The prompt through the decompressed path; the cache is the
    compressed ``{"c": [C, B, S, r], "kr": [C, B, S, rd]}``."""
    out, c, kr = _mla_attend(p, x, cfg, positions, None)
    return out, {"c": c, "kr": kr}


def mla_decode(p, x, cfg, cache, pos, mesh=None, cp=False,
               valid_override=None, rope_pos=None):
    """The absorbed path on ``x [C, B, 1, D]``: ``W_uk`` is folded into the
    query (``q_c [B, H, r]``), which attends over the compressed cache
    (keys ``[c, kr]`` and values ``c``, one kv head shared by every head);
    then ``W_uv`` and ``wo``.  The token's ``c`` and ``kr`` are written at
    slot ``pos``, in the caches' dtype (bf16 for bf16 params).  The three
    products sum in float32 and round once (``layers.einsum``).
    ``valid_override [B, S]`` and ``rope_pos [B]`` as in
    :func:`gqa_decode`, and ``mesh`` and ``cp`` too (the rank that holds
    position ``pos`` writes ``c`` and ``kr``).  Returns ``(out [C, B, 1,
    D], new cache)``; the cache passed in is not changed."""
    m = cfg.mla
    C, B = x.shape[:2]
    pos = int(pos)
    positions = (rope_pos[:, None] if rope_pos is not None else
                 torch.full((B, 1), pos, device=x.device))
    q_nope, q_rope = _mla_q(p, x, cfg, positions)       # [C, B, 1, H, .]
    c_t, kr_t = _mla_ckv(p, x, cfg, positions)          # [C, B, 1, .]
    cc, krc = cache["c"].clone(), cache["kr"].clone()
    Sl = cc.shape[2]
    lo, S = _cp_block(mesh, cp, Sl)
    if not (cp and mesh is not None) or lo <= pos < lo + Sl:
        cc[:, :, pos - lo] = c_t[:, :, 0]
        krc[:, :, pos - lo] = kr_t[:, :, 0]
    q_c = einsum("cbhe,crhe->cbhr", q_nope[:, :, 0], p["w_uk"])
    q_cat = torch.cat([q_c, q_rope[:, :, 0]], -1)       # [C, B, H, r + rd]
    k_cat = torch.cat([cc, krc], -1)                    # [C, B, Sl, r + rd]
    H, r = q_cat.shape[2], cc.shape[-1]
    valid = (valid_override if valid_override is not None else
             (torch.arange(S, device=x.device) <= pos).expand(B, S))
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    ctx = _attend(q_cat.reshape(C * B, H, -1),
                  k_cat.reshape(C * B, Sl, 1, -1),
                  cc.reshape(C * B, Sl, 1, r),
                  valid[:, lo:lo + Sl].repeat(C, 1), mesh, cp,
                  softmax_scale=scale).reshape(C, B, H, r)
    out = einsum("cbhr,crhe->cbhe", ctx.to(x.dtype), p["w_uv"])
    out = einsum("cbhe,ched->cbd", out, p["wo"])
    return out[:, :, None], {"c": cc, "kr": krc}
