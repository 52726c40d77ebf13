"""Mamba-2 (SSD, state-space duality) mixer.

Ports ``ssm_params``, ``_causal_conv``, ``_projections``,
``_projections_windowed``, ``ssd_chunked``, ``ssm_train`` (with its
``ssm_heads`` window), ``xr_raw_tail`` and ``ssm_decode`` of
``repro/models/ssm.py``.  Params carry the leading client dimension
``[C, ...]`` and activations are ``[C, B, S, ...]`` (one model is C = 1),
except in ``ssm_decode``, which takes one model's ``[B, 1, D]``.

The chunked SSD block decomposition has two routes, and the caller names
one (``ssm_train(kernel=...)``):

- the clients' form (the federated round, which trains) runs
  :func:`ssd_chunked`, a plain-torch transcription of the reference's
  ``ssd_chunked`` that autograd differentiates, as the reference trains
  through its jnp form.  It masks the intra-chunk decay's exponent with
  ``-inf`` above the diagonal *before* the ``exp``: the reference selects
  0 after it, and at a chunk of 256 that ``exp`` overflows, so its
  gradient is NaN (0 * inf) where this one is finite; the forward values
  and every finite gradient are the same;
- one model's prefill and loss run ``kernels.ssd_chunk.ssd_chunk_scan``:
  the intra-chunk block in the SSD chunk kernel (TPU row 12), which has
  no backward, and the inter-chunk recurrence in plain torch.

Decode is one step of the elementwise recurrence, plain torch as it is
plain jnp there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rolling_matmul import rolling_matmul_batched
from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
from repro_torch.models.layers import (ParamBuilder, _rows, bmm, head_proj,
                                       rms_norm_plain)

#: the profiler range around :func:`ssd_chunked`'s forward
SSD_CHUNKED = "ssd_chunked"


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
    """x ``[C, B, S, ch]``; w ``[C, cw, ch]``: each client's depthwise
    causal conv, ``cw - 1`` zeros on the left, as one grouped ``conv1d``
    over the ``C * ch`` channels.  JAX's conv and ``conv1d`` are both
    cross-correlations, so the weight is transposed, not flipped.  At bf16
    the conv sums the widened operands in float32 and rounds once."""
    C, B, S, ch = x.shape
    cw = w.shape[1]
    xi = x.permute(1, 0, 3, 2).reshape(B, C * ch, S)
    wi = w.permute(0, 2, 1).reshape(C * ch, 1, cw)
    out = F.conv1d(F.pad(xi.float(), (cw - 1, 0)), wi.float(),
                   groups=C * ch).to(x.dtype)
    return out.reshape(B, C, ch, S).permute(1, 0, 3, 2).contiguous()


def _per_client(x, w):
    """``x [C, B, S, D] @ w [C, D, n]`` -> ``[C, B, S, n]``."""
    return bmm(_rows(x), w).reshape(*x.shape[:-1], w.shape[-1])


def _projections(p, x, spec=None):
    """z, x ``[C, B, S, nh, hd]``, B, C ``[C, B, S, N]`` and dt (before its
    softplus) ``[C, B, S, nh]``.  With an ``ssm_heads`` window ``spec``
    (the reference's ``_projections_windowed``): z and x through the
    head-flattened windowed product (``head_proj``), dt through the same
    window on the 2-D ``[D, nh]`` layout, so the inactive heads' columns
    are never read and get exact zero gradients; B and C (shared across
    heads) stay full."""
    z = head_proj(x, p["w_z"], spec)
    xr = head_proj(x, p["w_x"], spec)
    Br = _per_client(x, p["w_B"])
    Cr = _per_client(x, p["w_C"])
    if spec is None:
        dt, dt_bias = _per_client(x, p["w_dt"]), p["dt_bias"]
    else:
        (dt,) = rolling_matmul_batched(_rows(x), (p["w_dt"],),
                                       spec.cols(1, x.device), spec.win,
                                       names=spec.names(1))
        dt = dt.reshape(*x.shape[:-1], spec.win)
        dt_bias = spec.take(p["dt_bias"])
    return z, xr, Br, Cr, dt + dt_bias[:, None, None]


def _out(y, w_out):
    """``einsum("cbshe,ched->cbsd", y, w_out)`` as one batched product."""
    C, nh, hd, D = w_out.shape
    return bmm(y.reshape(C, -1, nh * hd),
               w_out.reshape(C, nh * hd, D)).reshape(*y.shape[:-2], D)


def ssd_chunked(xr, dt, A, Br, Cr, chunk):
    """The reference's chunked SSD (``ssm.py:92-140``) in plain torch,
    differentiable: xr ``[B, S, nh, hd]``, dt ``[B, S, nh]``, A ``[nh]`` or
    one row per sequence ``[B, nh]``, Br and Cr ``[B, S, N]`` -> ``(y [B,
    S, nh, hd], final state [B, nh, hd, N])``.  The chunk is ``min(chunk,
    S)``; ``S`` must be a multiple of it (the reference's reshape fails
    otherwise).  The reference's ops in its order, except that the
    intra-chunk decay's exponent is masked to ``-inf`` above the diagonal
    before the ``exp`` (see the module docstring).  At bf16 its casts too:
    ``CB``, ``y_intra``, the states and ``y_inter`` are summed in float32
    on widened operands; ``M``, ``sdecay`` and the entry states are
    rounded to bf16 before their products, as the reference's ``astype``
    calls do; y is rounded once.  At float32 every cast is the tensor
    itself."""
    Bsz, S, nh, hd = xr.shape
    N = Br.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"a sequence of {S} is not a whole number of "
                         f"chunks of {Q}")
    nc = S // Q
    with torch.profiler.record_function(SSD_CHUNKED):
        xs = xr.reshape(Bsz, nc, Q, nh, hd)
        dts = dt.reshape(Bsz, nc, Q, nh)
        Bs = Br.reshape(Bsz, nc, Q, N)
        Cs = Cr.reshape(Bsz, nc, Q, N)
        dA = dts * A.reshape(-1, 1, 1, nh)                # [B, nc, Q, nh]
        L = torch.cumsum(dA, dim=2)                       # inclusive
        xw = xs.float()               # the products' operands, in float32
        # -- intra-chunk (quadratic within the chunk) --
        CB = torch.einsum("bcqn,bctn->bcqt", Cs.float(),
                          Bs.float())                     # [B, nc, Q, Q]
        Lh = L.transpose(2, 3)                            # [B, nc, nh, Q]
        diff = Lh[..., :, None] - Lh[..., None, :]        # [B, nc, nh, Q, Q]
        causal = torch.ones((Q, Q), dtype=torch.bool,
                            device=xr.device).tril()
        decay = torch.exp(diff.masked_fill(~causal, float("-inf")))
        M = CB[:, :, None] * decay * dts.transpose(2, 3)[:, :, :, None, :]
        y_intra = torch.einsum("bchqt,bcthp->bcqhp",
                               M.to(xs.dtype).float(), xw)
        # -- chunk states --
        Llast = Lh[..., -1:]                              # [B, nc, nh, 1]
        sdecay = torch.exp(Llast - Lh) * dts.transpose(2, 3)
        states = torch.einsum("bcthp,bctn,bcht->bchpn", xw, Bs.float(),
                              sdecay.to(xs.dtype).float())
        # -- inter-chunk recurrence: a loop over chunks (the reference's
        # lax.scan), emitting the state at each chunk's entry --
        dtot = torch.exp(dA.sum(2))                       # [B, nc, nh]
        h = torch.zeros((Bsz, nh, hd, N), dtype=torch.float32,
                        device=xr.device)
        entries = []
        for c in range(nc):
            entries.append(h)
            h = h * dtot[:, c, :, None, None] + states[:, c]
        h_entry = torch.stack(entries, dim=1)             # [B, nc, nh, hd, N]
        y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cs.float(),
                               h_entry.to(Cs.dtype).float())
        y_inter = y_inter * torch.exp(L)[..., None]
        y = (y_intra + y_inter).reshape(Bsz, S, nh, hd)
    return y.to(xr.dtype), h


def ssm_train(p, x, cfg, return_state=False, window=None, kernel=False):
    """x ``[C, B, S, D]`` with per-client params ``[C, ...]`` -> ``[C, B, S,
    D]`` (with ``return_state``, also the decode cache ``{h, conv_x,
    conv_B, conv_C}``, each ``[C, B, ...]``).

    ``window`` (a ``WindowMap`` or None) applies an ``ssm_heads`` window
    on the FULL weights (the reference's windowed ``ssm_train``): the
    windowed projections, the per-head conv, ``A_log``, ``D_skip``,
    ``y_norm`` and ``w_out`` narrowed to each client's heads
    (``AxisWindow.take``: a view for a shared window, a gather for
    per-client ones), and the chunked SSD on the ``win`` active heads, the
    ops of the extracted compact model.  ``kernel`` is one model's form
    (C = 1): the chunked SSD through the row-12 kernel, which refuses a
    gradient; otherwise the differentiable :func:`ssd_chunked`."""
    s = cfg.ssm
    spec = window.get("ssm_heads", p["A_log"].shape[-1]) if window else None
    if spec is not None and return_state:
        raise ValueError("ssm_heads windows are a training-path feature; "
                         "prefill and decode use full heads")
    z, xr_raw, Br, Cr, dt_raw = _projections(p, x, spec)
    conv_x, A_log, D_skip, y_norm, w_out = (
        p[k] for k in ("conv_x", "A_log", "D_skip", "y_norm", "w_out"))
    if spec is not None:
        conv_x = spec.take(conv_x.transpose(1, 2)).transpose(1, 2)
        A_log, D_skip, y_norm, w_out = (spec.take(w) for w in
                                        (A_log, D_skip, y_norm, w_out))
    C, B, S, nh, hd = xr_raw.shape
    cw = s.conv_width
    tail = xr_raw_tail(xr_raw, cw) if return_state else None
    xr = F.silu(_causal_conv(xr_raw.reshape(C, B, S, nh * hd),
                             conv_x.reshape(C, cw, nh * hd))
                ).reshape(C, B, S, nh, hd)
    del xr_raw
    Brc = F.silu(_causal_conv(Br, p["conv_B"]))
    Crc = F.silu(_causal_conv(Cr, p["conv_C"]))
    dt = F.softplus(dt_raw)
    A = -torch.exp(A_log.float())                         # [C, nh]
    fold = (lambda t: t.reshape(C * B, *t.shape[2:]))     # noqa: E731
    if kernel:
        if C != 1:
            raise ValueError(f"the SSD chunk kernel runs one model (C = 1); "
                             f"got {C} clients")
        y, hT = ssd_chunk_scan(fold(xr), fold(dt), A[0], fold(Brc),
                               fold(Crc), s.chunk)
    else:
        y, hT = ssd_chunked(fold(xr), fold(dt), A.repeat_interleave(B, 0),
                            fold(Brc), fold(Crc), s.chunk)
    y = y.reshape(C, B, S, nh, hd) + D_skip[:, None, None, :, None] * xr
    y = rms_norm_plain(y * F.silu(z), y_norm[:, None, None], cfg.norm_eps)
    out = _out(y, w_out)
    if not return_state:
        return out
    cache = {
        "h": hT.reshape(C, B, nh, hd, -1),                # [C, B, nh, hd, N]
        "conv_x": tail,
        "conv_B": Br[:, :, -(cw - 1):].clone(),       # not a view of Br
        "conv_C": Cr[:, :, -(cw - 1):].clone(),
    }
    return out, cache


def xr_raw_tail(xr_raw, cw):
    """The last ``cw - 1`` positions of the x projection ``[C, B, S, nh,
    hd]`` before its conv, flattened to ``[C, B, cw - 1, nh * hd]``: the
    decode cache's ``conv_x`` (a copy, not a view of the whole
    projection)."""
    C, B, _, nh, hd = xr_raw.shape
    return xr_raw[:, :, -(cw - 1):].reshape(C, B, cw - 1, nh * hd).clone()


def ssm_decode(p, x, cfg, cache, pos):
    """One model: x ``[B, 1, D]``; params without the client dimension;
    cache ``{h, conv_x, conv_B, conv_C}``.  Returns ``(out [B, 1, D], new
    cache)``; the cache passed in is not changed."""
    s = cfg.ssm
    del pos
    z, xr, Br, Cr, dt_raw = (t[0] for t in _projections(
        {k: v[None] for k, v in p.items()}, x[None]))     # seq dim = 1
    B = x.shape[0]
    nh, hd = xr.shape[2], xr.shape[3]
    cw = s.conv_width

    def conv_step(buf, new, w):
        # buf [B, cw-1, ch]; new [B, 1, ch]; w [cw, ch]
        win = torch.cat([buf, new], dim=1)                # [B, cw, ch]
        out = torch.einsum("bwc,wc->bc", win.float(), w.float())
        return out.to(win.dtype), win[:, 1:]

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
        "bhp,bn,bh->bhpn", xr_f.float(), Br_f.float(), dt.float())
    y = torch.einsum("bhpn,bn->bhp", h, Cr_f.float())
    y = y.to(x.dtype) + p["D_skip"][:, None] * xr_f
    y = rms_norm_plain(y[:, None] * F.silu(z), p["y_norm"], cfg.norm_eps)
    out = _out(y[None], p["w_out"][None])[0]
    return out, {"h": h, "conv_x": conv_x, "conv_B": conv_B,
                  "conv_C": conv_C}
