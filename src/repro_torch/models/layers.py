"""Layer primitives and axis-tagged parameter construction.

Ports ``repro/models/layers.py``: ``AxisWindow``, ``WindowMap``,
``ParamBuilder`` (its fan-in rule covers the SSM's 3-D leaves: the product
of every axis but the last, ``heads``/``kv_heads`` left out), ``rms_norm``
(``rms_norm_plain`` without the client dimension), ``apply_rope``,
``sinusoidal_positions``, ``act_fn`` (``gelu`` is the tanh form, the
default of ``jax.nn.gelu``), ``mlp_apply``, ``mlp_apply_rolling``,
``head_proj`` and ``softmax_xent``; ``bmm`` and ``einsum`` are the
products of the reference's bf16 models that no kernel takes (float32
sums, one rounding; ``wide`` is their operands' widening on the CPU).

Params are a flat ``{path: tensor}`` dict with a parallel ``{path: axis
tags}`` dict; paths are the reference's ``tree_paths`` with the stacked
``layers`` axis split into one leaf per layer (``layers/3/mlp/w_gate``).
Inside the model every leaf carries a leading client dimension ``[C, ...]``
(one model is C = 1): the federated round trains C copies at once, and the
windowed products read each client's own copy.  A window with one scalar
offset (one model, as the reference's ``AxisWindow.offset``) runs the same
products on C = 1, counted under the reference's scalar-offset names.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import check_f32_sums
from repro_torch.kernels.rolling_matmul import (SCALAR_NAMES, Offsets,
                                                make_offsets,
                                                rolling_matmul_batched)


class AxisWindow:
    """Active window of one windowed axis, in axis units: one offset per
    client (host integers) and a static width ``win``.  A scalar offset
    is the window of one model (``scalar``): its products run on C = 1 and
    count their launches under the scalar-offset names."""

    def __init__(self, offsets, win: int):
        self.scalar = np.ndim(offsets) == 0
        self.offsets = ((int(offsets),) if self.scalar
                        else tuple(int(o) for o in offsets))
        self.win = int(win)
        self._cols: Dict[Tuple[int, str], Offsets] = {}
        self._rows: Dict[str, torch.Tensor] = {}
        self._rep: Dict[tuple, "AxisWindow"] = {}

    def cols(self, scale: int, device) -> Offsets:
        """Offsets scaled to columns (a head window covers ``scale =
        head_dim`` columns per head), on ``device``; made once per window."""
        key = (int(scale), str(device))
        if key not in self._cols:
            self._cols[key] = make_offsets([o * scale for o in self.offsets],
                                           device)
        return self._cols[key]

    def names(self, T: int):
        """The (forward, dx) launch-count names of its T-weight product:
        the reference's scalar-offset kernels for one model's window, the
        kernels' own (None) for per-client ones."""
        return SCALAR_NAMES[T] if self.scalar else None

    def repeated(self, n: int, client: int) -> "AxisWindow":
        """``client``'s window over ``n`` stacked units (its experts, in a
        product's leading dimension): its offset repeated ``n`` times;
        made once per window."""
        key = (int(n), int(client))
        if key not in self._rep:
            self._rep[key] = AxisWindow([self.offsets[client]] * n, self.win)
        return self._rep[key]

    def shared_offset(self) -> int:
        """The one offset every client shares (a shared window)."""
        if len(set(self.offsets)) != 1:
            raise ValueError(f"the clients' windows differ ({self.offsets}):"
                             " there is no one shared offset")
        return self.offsets[0]

    def take(self, w, dim=1):
        """``w [C, ...]`` narrowed to each client's window on ``dim`` (the
        reference's ``dynamic_slice``, vmapped over clients for per-client
        windows).  A shared window is a view, not a copy; per-client
        windows are one indexed gather, whose backward writes into one
        full-shaped zero gradient."""
        if len(set(self.offsets)) == 1:
            return w.narrow(dim, self.offsets[0], self.win)
        key = str(w.device)
        if key not in self._rows:
            self._rows[key] = (torch.tensor(self.offsets, device=w.device)
                               [:, None] + torch.arange(self.win,
                                                        device=w.device))
        idx = self._rows[key]                                 # [C, win]
        out = w.movedim(dim, 1)[torch.arange(idx.shape[0],
                                             device=w.device)[:, None], idx]
        return out.movedim(1, dim)


class WindowMap:
    """Per-axis windows for the fused forward, keyed by ``(axis name, full
    size)`` like the reference's ``WindowScheme`` keys."""

    SUPPORTED = ("d_ff", "heads", "kv_heads", "experts", "moe_d_ff",
                 "ssm_heads")

    def __init__(self, windows: Dict[Tuple[str, int], AxisWindow]):
        self.windows = {}
        for (name, size), spec in windows.items():
            if name not in self.SUPPORTED:
                raise ValueError(
                    f"axis {name!r} has no window-aware forward; fused "
                    f"windows support {self.SUPPORTED}")
            self.windows[(name, int(size))] = spec

    def get(self, name: str, size) -> Optional[AxisWindow]:
        return self.windows.get((name, int(size)))


# ---------------------------------------------------------------------------
# Axis-tagged parameter building
# ---------------------------------------------------------------------------


class ParamBuilder:
    """Collects ``{path: tensor}`` params of ``dtype`` (float32 or bfloat16)
    and ``{path: axes}`` tags.  Weights are drawn in float32 from one
    ``torch.Generator`` on ``device`` and rounded once to ``dtype`` (the
    ``meta`` device builds shapes only)."""

    def __init__(self, seed: int, device, dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = None
        if self.device.type != "meta":
            self.gen = torch.Generator(self.device).manual_seed(int(seed))
        self.params: Dict[str, torch.Tensor] = {}
        self.axes: Dict[str, Tuple[str, ...]] = {}

    def _put(self, path, value, axes):
        if value.dim() != len(axes) or path in self.params:
            raise ValueError(f"bad or duplicate param {path}: "
                             f"{tuple(value.shape)} {axes}")
        self.params[path] = value
        self.axes[path] = tuple(axes)

    def dense(self, path, shape, axes, scale=None):
        """Normal(0, scale) weight; the reference's fan-in rule."""
        if scale is None:
            fan = [s for s, ax in zip(shape, axes)
                   if ax not in ("heads", "kv_heads")][:-1]
            scale = 1.0 / math.sqrt(max(math.prod(fan) or shape[0], 1))
        w = torch.empty(shape, dtype=torch.float32, device=self.device)
        if self.gen is not None:
            w.normal_(0.0, scale, generator=self.gen)
        self._put(path, w.to(self.dtype), axes)

    def const(self, path, shape, axes, value=0.0):
        self._put(path, torch.full(shape, value, dtype=self.dtype,
                                   device=self.device), axes)


# ---------------------------------------------------------------------------
# Norms / activations / positions
# ---------------------------------------------------------------------------


def _per_client(w, x):
    """A ``[C, n]`` per-client vector broadcast against ``x [C, ..., n]``."""
    return w.reshape(w.shape[0], *([1] * (x.dim() - 2)), w.shape[-1])


def rms_norm_plain(x, w, eps=1e-5):
    """The reference's ``rms_norm``: over the last axis, ``w`` broadcast
    against ``x`` as it stands (one model's SSM norm ``y_norm [nh, hd]``
    normalises each head over its ``hd``)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def rms_norm(x, w, eps=1e-5):
    """``x [C, ..., n]`` normalised by per-client weights ``w [C, n]``."""
    return rms_norm_plain(x, _per_client(w, x), eps)


def gelu(x):
    """The tanh form of GELU, as ``jax.nn.gelu`` computes it by default
    (``approximate=True``); ``F.gelu``'s default is the exact erf form,
    up to 4e-4 away on ``[-4, 4]``."""
    return F.gelu(x, approximate="tanh")


def act_fn(name):
    return {"silu": F.silu, "gelu": gelu, "relu": F.relu}[name]


def apply_rope(x, positions, theta):
    """x: ``[..., S, H, hd]``; positions: ``[..., S]`` (broadcastable: ``[S]``
    for a sequence, ``[B, 1]`` for one decode step per row)."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    angles = positions[..., None].float() * freqs        # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]                # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions, d_model):
    """``[..., S]`` int -> ``[..., S, D]`` float32: ``sin`` over the first
    half of the width, ``cos`` over the second."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------


def mlp_params(b: ParamBuilder, prefix, d_model, d_ff):
    b.dense(f"{prefix}/w_gate", (d_model, d_ff), ("d_model", "d_ff"))
    b.dense(f"{prefix}/w_up", (d_model, d_ff), ("d_model", "d_ff"))
    b.dense(f"{prefix}/w_down", (d_ff, d_model), ("d_ff", "d_model"))


def _rows(x):
    """``[C, *lead, D]`` -> ``[C, M, D]`` (a view)."""
    return x.reshape(x.shape[0], -1, x.shape[-1])


def wide(t):
    """``t`` as an operand of a float32-accumulated product: a bfloat16
    tensor on the CPU widened to float32, anything else itself."""
    if t.dtype == torch.bfloat16 and t.device.type == "cpu":
        return t.float()
    return t


def bmm(a, b, dtype=None):
    """``torch.bmm(a, b)`` in ``dtype`` (default a's), summed in float32
    and rounded once, as the reference's bf16 products are.  cuBLAS does
    so on the card with ``allow_bf16_reduced_precision_reduction`` off
    (``device.resolve_device`` turns it off; a bf16 product raises while
    it is on); on the CPU bf16 operands are widened first, since torch's
    CPU bf16 GEMM sums in another order than its f32 one and the windowed
    products' plain versions (``kernels.ref``) multiply widened operands:
    the fused and the extract client phases then agree to the bit."""
    check_f32_sums(a)
    return torch.bmm(wide(a), wide(b)).to(dtype or a.dtype)


def einsum(eq, a, b, dtype=None):
    """``torch.einsum(eq, a, b)`` in ``dtype`` (default a's), summed in
    float32 and rounded once, as :func:`bmm`: a bf16 contraction of the
    reference's (``jnp.einsum`` at bf16) that is no windowed product."""
    check_f32_sums(a)
    return torch.einsum(eq, wide(a), wide(b)).to(dtype or a.dtype)


def mlp_apply(p, x, act="silu"):
    # one widened x for the gate/up pair: at bf16 on the CPU its grads sum
    # in float32 and round once, as the pair's dx kernel (the fused
    # phase's) sums them
    x2 = wide(_rows(x))
    g = act_fn(act)(bmm(x2, p["w_gate"], x.dtype))
    out = bmm(g * bmm(x2, p["w_up"], x.dtype), p["w_down"])
    return out.reshape(x.shape)


def mlp_apply_rolling(p, x, spec: AxisWindow, act="silu"):
    """Gated MLP on the FULL weights reading only the active ``d_ff``
    window: the gate/up pair goes through one T = 2 windowed product (the
    ``rolling_mm_fwd<2>`` kernel on the card), and ``w_down``'s row
    window is :meth:`AxisWindow.take` (a view for a shared window)."""
    gy, u = rolling_matmul_batched(
        _rows(x), (p["w_gate"], p["w_up"]), spec.cols(1, x.device),
        spec.win, names=spec.names(2))
    out = bmm(act_fn(act)(gy) * u, spec.take(p["w_down"]))
    return out.reshape(x.shape)


def head_proj(x, w, spec: Optional[AxisWindow]):
    """``x [C, *lead, D] @ w [C, D, H, hd]`` restricted to the head window
    ``spec`` (head units): a windowed product on the head-flattened
    ``[C, D, H*hd]`` layout, so inactive heads' columns are never read."""
    C, D, H, hd = w.shape
    lead = x.shape[1:-1]
    w2 = w.reshape(C, D, H * hd)
    if spec is None:
        return bmm(_rows(x), w2).reshape(C, *lead, H, hd)
    (y,) = rolling_matmul_batched(_rows(x), (w2,), spec.cols(hd, x.device),
                                  spec.win * hd, names=spec.names(1))
    return y.reshape(C, *lead, spec.win, hd)


# ---------------------------------------------------------------------------
# Cross-entropy
# ---------------------------------------------------------------------------


def softmax_xent(logits, labels):
    """Per-client mean token cross-entropy: logits ``[C, ..., V]`` (f32
    upcast), labels int ``[C, ...]``; returns ``[C]``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (lse - picked).reshape(logits.shape[0], -1).mean(dim=1)
