"""Mamba-2 (SSD, state-space duality) mixer, for one model.

Ports ``ssm_params``, ``_causal_conv``, ``_projections``, ``ssd_chunked``,
``ssm_train`` (without its ``ssm_heads`` window), ``xr_raw_tail`` and
``ssm_decode`` of ``repro/models/ssm.py``.  Params carry no client
dimension here and activations are ``[B, S, ...]``; the transformer strips
the C = 1 views of one model before it calls in.

Prefill and one model's loss run the chunked SSD block decomposition
through ``kernels.ssd_chunk.ssd_chunk_scan``: the intra-chunk block in the
SSD chunk kernel (TPU row 12), the inter-chunk recurrence in plain torch.
The reference's own model path runs the jnp form of the same block
(``ssd_chunked``); its tests pin the kernel form equal to it.  Decode is one
step of the elementwise recurrence, plain torch as it is plain jnp there.
The SSD kernel has no backward, so this module cannot train (ROADMAP.md
queue A, SSM training).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
from repro_torch.models.layers import ParamBuilder, rms_norm_plain


def n_heads(cfg) -> int:
    s = cfg.ssm
    return s.n_heads or (s.expand * cfg.d_model) // s.head_dim


def ssm_params(b: ParamBuilder, prefix, cfg):
    s, D = cfg.ssm, cfg.d_model
    nh = n_heads(cfg)
    hd, N, cw = s.head_dim, s.d_state, s.conv_width
    b.dense(f"{prefix}/w_z", (D, nh, hd), ("d_model", "ssm_heads",
                                           "ssm_head_dim"))
    b.dense(f"{prefix}/w_x", (D, nh, hd), ("d_model", "ssm_heads",
                                           "ssm_head_dim"))
    b.dense(f"{prefix}/w_B", (D, N), ("d_model", "ssm_state"))
    b.dense(f"{prefix}/w_C", (D, N), ("d_model", "ssm_state"))
    b.dense(f"{prefix}/w_dt", (D, nh), ("d_model", "ssm_heads"))
    b.const(f"{prefix}/dt_bias", (nh,), ("ssm_heads",), 0.0)
    b.const(f"{prefix}/A_log", (nh,), ("ssm_heads",), 0.0)
    b.const(f"{prefix}/D_skip", (nh,), ("ssm_heads",), 1.0)
    b.dense(f"{prefix}/conv_x", (cw, nh, hd), ("conv_w", "ssm_heads",
                                               "ssm_head_dim"))
    b.dense(f"{prefix}/conv_B", (cw, N), ("conv_w", "ssm_state"))
    b.dense(f"{prefix}/conv_C", (cw, N), ("conv_w", "ssm_state"))
    b.const(f"{prefix}/y_norm", (nh, hd), ("ssm_heads", "ssm_head_dim"), 1.0)
    b.dense(f"{prefix}/w_out", (nh, hd, D), ("ssm_heads", "ssm_head_dim",
                                             "d_model"))


def _causal_conv(x, w):
    """x ``[B, S, ch]``; w ``[cw, ch]``: depthwise causal conv, ``cw - 1``
    zeros on the left.  JAX's conv and ``conv1d`` are both
    cross-correlations, so the weight is transposed, not flipped."""
    cw, ch = w.shape
    out = F.conv1d(F.pad(x.transpose(1, 2), (cw - 1, 0)), w.t()[:, None, :],
                   groups=ch)
    return out.transpose(1, 2).contiguous()


def _heads(x, w):
    """``einsum("bsd,dhe->bshe", x, w)`` as one product."""
    D, nh, hd = w.shape
    return (x @ w.reshape(D, nh * hd)).reshape(*x.shape[:-1], nh, hd)


def _projections(p, x):
    z = _heads(x, p["w_z"])
    xr = _heads(x, p["w_x"])
    Br = x @ p["w_B"]
    Cr = x @ p["w_C"]
    dt_raw = x @ p["w_dt"] + p["dt_bias"]
    return z, xr, Br, Cr, dt_raw


def _out(y, w_out):
    """``einsum("bshe,hed->bsd", y, w_out)`` as one product."""
    nh, hd, D = w_out.shape
    return y.reshape(*y.shape[:-2], nh * hd) @ w_out.reshape(nh * hd, D)


#: the reference's chunked SSD (``ssm.py:92``), with its contract: xr ``[B,
#: S, nh, hd]``, dt ``[B, S, nh]``, A ``[nh]``, Br and Cr ``[B, S, N]`` ->
#: ``(y [B, S, nh, hd], final state [B, nh, hd, N])``; ``ValueError`` where
#: the reference's reshape fails (``S > chunk`` and ``S % chunk != 0``)
ssd_chunked = ssd_chunk_scan


def ssm_train(p, x, cfg, return_state=False, window=None):
    """x ``[B, S, D]`` -> ``[B, S, D]`` (with ``return_state``, also the
    decode cache ``{h, conv_x, conv_B, conv_C}``)."""
    if window is not None:
        raise NotImplementedError(
            "ssm_heads windows are not ported yet (ROADMAP.md queue A, SSM "
            "training)")
    s = cfg.ssm
    z, xr_raw, Br, Cr, dt_raw = _projections(p, x)
    B, S, nh, hd = xr_raw.shape
    cw = s.conv_width
    tail = xr_raw_tail(xr_raw, cw) if return_state else None
    xr = F.silu(_causal_conv(xr_raw.reshape(B, S, nh * hd),
                             p["conv_x"].reshape(cw, nh * hd))
                ).reshape(B, S, nh, hd)
    del xr_raw
    Brc = F.silu(_causal_conv(Br, p["conv_B"]))
    Crc = F.silu(_causal_conv(Cr, p["conv_C"]))
    dt = F.softplus(dt_raw)
    A = -torch.exp(p["A_log"].float())
    y, hT = ssd_chunked(xr, dt, A, Brc, Crc, s.chunk)
    y = y + p["D_skip"][:, None] * xr
    y = rms_norm_plain(y * F.silu(z), p["y_norm"], cfg.norm_eps)
    out = _out(y, p["w_out"])
    if not return_state:
        return out
    cache = {
        "h": hT,                                          # [B, nh, hd, N]
        "conv_x": tail,
        "conv_B": Br[:, -(cw - 1):].clone(),          # not a view of Br
        "conv_C": Cr[:, -(cw - 1):].clone(),
    }
    return out, cache


def xr_raw_tail(xr_raw, cw):
    """The last ``cw - 1`` positions of the x projection ``[B, S, nh, hd]``
    before its conv, flattened to ``[B, cw - 1, nh * hd]``: the decode
    cache's ``conv_x`` (a copy, not a view of the whole projection)."""
    B, _, nh, hd = xr_raw.shape
    return xr_raw[:, -(cw - 1):].reshape(B, cw - 1, nh * hd).clone()


def ssm_decode(p, x, cfg, cache, pos):
    """x ``[B, 1, D]``; cache ``{h, conv_x, conv_B, conv_C}``.  Returns
    ``(out [B, 1, D], new cache)``; the cache passed in is not changed."""
    s = cfg.ssm
    del pos
    z, xr, Br, Cr, dt_raw = _projections(p, x)            # seq dim = 1
    B = x.shape[0]
    nh, hd = xr.shape[2], xr.shape[3]
    cw = s.conv_width

    def conv_step(buf, new, w):
        # buf [B, cw-1, ch]; new [B, 1, ch]; w [cw, ch]
        win = torch.cat([buf, new], dim=1)                # [B, cw, ch]
        out = torch.einsum("bwc,wc->bc", win, w)
        return out, win[:, 1:]

    xr_f, conv_x = conv_step(cache["conv_x"], xr.reshape(B, 1, nh * hd),
                             p["conv_x"].reshape(cw, nh * hd))
    Br_f, conv_B = conv_step(cache["conv_B"], Br, p["conv_B"])
    Cr_f, conv_C = conv_step(cache["conv_C"], Cr, p["conv_C"])
    xr_f = F.silu(xr_f).reshape(B, nh, hd)
    Br_f = F.silu(Br_f)
    Cr_f = F.silu(Cr_f)
    dt = F.softplus(dt_raw[:, 0])                         # [B, nh]
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * A)                             # [B, nh]
    h = cache["h"] * decay[:, :, None, None] + torch.einsum(
        "bhp,bn,bh->bhpn", xr_f.float(), Br_f.float(), dt)
    y = torch.einsum("bhpn,bn->bhp", h, Cr_f.float())
    y = y.to(x.dtype) + p["D_skip"][:, None] * xr_f
    y = rms_norm_plain(y[:, None] * F.silu(z), p["y_norm"], cfg.norm_eps)
    out = _out(y, p["w_out"])
    return out, {"h": h, "conv_x": conv_x, "conv_B": conv_B,
                  "conv_C": conv_C}
