"""Mixture-of-Experts: top-k routing with sort-based capacity dispatch.

Ports ``moe_params``, ``_route``, ``_expert_ffn`` and ``moe_apply`` of
``repro/models/moe.py``, with both of its paths:

- ``dense``: every expert runs every token, and the router's weights mix
  the outputs.  Exact; the test oracle.
- ``dropping``: each token's k choices are sorted by expert into buckets
  of ``capacity`` rows, the experts run as one batched gated MLP
  ``[E, cap, D]``, and choices past an expert's capacity are dropped
  (Switch-style).

Routing styles: ``softmax`` (Mixtral) and ``sigmoid`` (DeepSeek-V3); the
Switch load-balance loss comes back beside the output.

Activations and weights carry the leading client dimension ``[C, ...]``.
Routing is per client, as the reference's client vmap makes it: each
client routes its own ``B * S`` tokens, and the capacity follows from that
client's token count.  Two points differ from the reference on purpose:

- **Dispatch writes only the kept choices.**  The reference writes
  ``xin.at[slot].set(where(keep, xt[st], 0))`` with every dropped choice's
  slot at its expert's rank 0, and XLA keeps the last write: when an
  expert overflows, its first token's row becomes zeros (ROADMAP.md §C).
  Here each slot gathers the one token the sort put there, and a dropped
  choice fills no slot, as the reference's docstring describes.
- **Combine is deterministic.**  Each token's k contributions are
  gathered as ``[T, k, D]`` and summed at the activations' dtype in order
  of ascending expert, the order in which the reference's scatter-add
  (``.at[st].add``) meets them: its updates come sorted by expert, and
  XLA:CPU adds a bf16 scatter's updates one by one in bf16, in their order
  (at top-2 both orders give the same bits; at DeepSeek-V3's top-8 they
  do not).  No slot is read twice, so no gradient accumulates through
  atomics either.

The top k of the router's scores are taken by a stable descending sort,
so that tied scores go to the lower expert index, as ``jax.lax.top_k``
breaks ties (``torch.topk`` does not, on either device).  At bf16 every
product sums in float32 and rounds once (``layers.bmm`` and
``layers.einsum``; the windowed products' kernels and plain versions do
so too), with the reference's roundings: the router's logits rounded to
bf16 before the float32 softmax or sigmoid, the routing weights cast to
the activations' dtype, the ``dense`` path's gate in that dtype.

An ``experts`` window slices the router's columns to each client's
active experts.  With a ``moe_d_ff`` window the experts' products read
the FULL stacks in place: each client's window of experts ``[G, D, F]``
(a view: one stride per expert) goes through the windowed product (TPU
rows 7 and 8, ``kernels.rolling_matmul.rolling_matmul_batched`` with
``experts=``) with its experts in the kernel's leading dimension and its
``moe_d_ff`` offset repeated over them, one launch a client: the kernel
takes one batch stride, and the windows of two clients' full copies lie
at another.  The
down projection reads the same window of ``w_down`` rows through one
``bmm`` a client, and both write their weight gradients straight into
full-shaped zero gradients (no compact-shaped temporary, no expert
copy).  Without a ``moe_d_ff`` window the expert stacks are narrowed (a
view for a shared window, a gather for per-client ones) and run as
batched products.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import check_f32_sums
from repro_torch.kernels.rolling_matmul import rolling_matmul_batched
from repro_torch.models.layers import (ParamBuilder, act_fn, bmm, einsum,
                                       mlp_apply, mlp_apply_rolling, wide)


def moe_params(b: ParamBuilder, prefix, cfg):
    mo, D = cfg.moe, cfg.d_model
    E, Fe = mo.n_experts, mo.d_ff
    b.dense(f"{prefix}/router", (D, E), ("d_model", "experts"))
    for w, sh, ax in (("w_gate", (E, D, Fe), ("experts", "d_model",
                                              "moe_d_ff")),
                      ("w_up", (E, D, Fe), ("experts", "d_model",
                                            "moe_d_ff")),
                      ("w_down", (E, Fe, D), ("experts", "moe_d_ff",
                                              "d_model"))):
        b.dense(f"{prefix}/{w}", sh, ax)
    if mo.n_shared:
        Fs = mo.n_shared * Fe
        b.dense(f"{prefix}/shared/w_gate", (D, Fs), ("d_model", "moe_d_ff"))
        b.dense(f"{prefix}/shared/w_up", (D, Fs), ("d_model", "moe_d_ff"))
        b.dense(f"{prefix}/shared/w_down", (Fs, D), ("moe_d_ff", "d_model"))


def top_k(scores, k):
    """The ``k`` largest ``scores`` along the last axis, largest first, and
    their indices, as ``jax.lax.top_k`` gives them: tied scores go to the
    lower index first (a stable descending sort; ``torch.topk`` breaks
    ties otherwise, and on the card otherwise again)."""
    w, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return w[..., :k], idx[..., :k]


def _route(router, x, cfg):
    """router ``[C, D, E]``, x ``[C, T, D]`` -> (weights ``[C, T, k]``,
    idx ``[C, T, k]``, aux ``[C]``)."""
    mo = cfg.moe
    E = router.shape[-1]               # may be a sub-model window of experts
    k = min(mo.top_k, E)
    # the logits rounded to x's dtype, then widened: the reference's
    # ``(x @ router).astype(float32)``
    logits = bmm(x, router).float()                       # [C, T, E]
    if mo.router == "sigmoid":
        w, idx = top_k(torch.sigmoid(logits), k)
        w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    else:
        w, idx = top_k(logits, k)
        w = torch.softmax(w, dim=-1)
    # Switch load-balance loss: E * sum_e f_e * p_e, per client
    probs = torch.softmax(logits, dim=-1)
    frac = F.one_hot(idx[..., 0], E).float().mean(1)
    aux = E * torch.sum(frac * probs.mean(1), dim=-1)
    return w.to(x.dtype), idx, aux


def _dispatch(idx, E, cap):
    """The sort-based dispatch plan of each client's choices ``idx [C, T,
    k]``: ``src [C, E * cap]``, the token each expert slot holds (``T``, a
    zero row, for an empty slot), and ``pick [C, T, k]``, the slot of each
    choice (``E * cap``, a zero row, for a dropped one).  Choices are
    sorted by expert, stably (token order within an expert); a choice's
    rank within its expert decides whether it fits."""
    C, T, k = idx.shape
    n, dev = T * k, idx.device
    flat_e = idx.reshape(C, n)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)
    lanes = torch.arange(C, device=dev)[:, None] * E
    if dev.type == "meta":     # a plan: bincount has no meta kernel
        counts = torch.zeros((C, E), dtype=torch.long, device=dev)
    else:
        counts = torch.bincount((se + lanes).reshape(-1),
                                minlength=C * E).view(C, E)
    starts = torch.cumsum(counts, 1) - counts
    rank = torch.arange(n, device=dev) - torch.gather(starts, 1, se)
    keep = rank < cap
    slot = se * cap + rank
    # a dropped choice lands in a spare slot of its own past E * cap, so
    # no slot is written twice and none of the kept rows is touched
    spare = E * cap + torch.arange(n, device=dev).expand(C, n)
    src = torch.full((C, E * cap + n), T, dtype=torch.long, device=dev)
    src.scatter_(1, torch.where(keep, slot, spare), order // k)
    picked = torch.where(keep, slot, E * cap)
    pick = torch.empty_like(picked).scatter_(1, order, picked)
    return src[:, :E * cap], pick.view(C, T, k)


def _expert_ffn(wg, wu, wd, x, act):
    """Per-expert gated MLPs: x ``[C, E, cap, D]`` against ``wg``/``wu``
    ``[C, E, D, F]`` and ``wd [C, E, F, D]``, as batched products (one
    widened x for the gate/up pair, as ``layers.mlp_apply``: its gradient
    sums in float32 and rounds once, as the pair's dx kernel sums it)."""
    C, E = x.shape[:2]

    def rows(t):
        return t.reshape(C * E, *t.shape[2:])
    x2 = wide(rows(x))
    g = act_fn(act)(bmm(x2, rows(wg), x.dtype))
    y = bmm(g * bmm(x2, rows(wu), x.dtype), rows(wd))
    return y.view(C, E, *y.shape[1:])


class _ExpertDown(torch.autograd.Function):
    """``y[c] = h[c] @ wd[c, e_c : e_c + G, f_c : f_c + win]``, one ``bmm``
    a client on a view of the full stack ``wd [C, E, F, D]``; the backward
    writes ``dW`` into a full-shaped zero gradient.  ``apply(h [C, G, M,
    win], eoffs, foffs, wd)`` with host offsets ``[C]``.  At bf16 each
    product sums in float32 and rounds once, on the CPU bit for bit as the
    extract client phase's products on its compact copies: ``dW`` into the
    window as ``kernels.rolling_matmul._window_grad`` writes it."""

    @staticmethod
    def forward(ctx, h, eoffs, foffs, wd):
        G, win = h.shape[1], h.shape[-1]
        ctx.save_for_backward(h, wd)
        ctx.eoffs, ctx.foffs = eoffs, foffs
        return torch.stack([bmm(h[c], wd[c, eo:eo + G, fo:fo + win])
                            for c, (eo, fo) in enumerate(zip(eoffs, foffs))])

    @staticmethod
    def backward(ctx, dy):
        h, wd = ctx.saved_tensors
        G, win = h.shape[1], h.shape[-1]
        views = [wd[c, eo:eo + G, fo:fo + win]
                 for c, (eo, fo) in enumerate(zip(ctx.eoffs, ctx.foffs))]
        # the widened view's transpose: autograd of the extract phase's
        # bmm multiplies by its widened compact copy's
        dh = torch.stack([bmm(dy[c], wide(v).mT, dy.dtype) for c, v in
                          enumerate(views)])
        check_f32_sums(h)
        dw = torch.zeros_like(wd)
        for c, (eo, fo) in enumerate(zip(ctx.eoffs, ctx.foffs)):
            win_dw = dw[c, eo:eo + G, fo:fo + win]
            if dw.device.type == "cpu" and dw.dtype != torch.float32:
                win_dw.copy_(torch.bmm(h[c].mT.float(), dy[c].float()))
            else:
                win_dw.baddbmm_(h[c].mT, dy[c])
        return dh, None, None, dw


def _expert_ffn_windowed(wg, wu, wd, x, act, eoffs, fspec):
    """Per-expert gated MLPs on the FULL stacks (``[C, E, ...]``) under a
    ``moe_d_ff`` window ``fspec``: client c's experts ``[eoffs[c], eoffs[c]
    + G)`` on x ``[C, G, cap, D]``; only the windows are read."""
    G, dev = x.shape[1], x.device
    cols = [fspec.repeated(G, c).cols(1, dev) for c in range(x.shape[0])]
    gy, u = rolling_matmul_batched(x, (wg, wu), cols, fspec.win,
                                   experts=eoffs)
    return _ExpertDown.apply(act_fn(act)(gy) * u, eoffs, fspec.offsets, wd)


def moe_apply(p, x, cfg, path="dropping", window=None):
    """x ``[C, B, S, D]`` -> (out ``[C, B, S, D]``, aux ``[C]``), each
    client routing its own tokens.  ``p`` holds the layer's ``router``,
    ``w_gate``, ``w_up``, ``w_down`` (and ``shared/*``) leaves, each
    ``[C, ...]``.

    ``window`` (a ``WindowMap``, or None) applies the fused sub-model
    windows on the FULL weights: an ``experts`` window slices the router
    columns and the expert stacks to the active contiguous expert range
    (routing then runs over that sub-zoo, exactly like the extracted
    compact model), and a ``moe_d_ff`` window routes the per-expert and
    shared MLPs through the windowed product."""
    C, B, S, D = x.shape
    xt = x.reshape(C, B * S, D)
    mo = cfg.moe
    router, wg, wu, wd = p["router"], p["w_gate"], p["w_up"], p["w_down"]
    espec = window.get("experts", router.shape[-1]) if window else None
    eoffs = (0,) * C
    if espec is not None:
        router = espec.take(router, dim=2)
        eoffs = espec.offsets
    fspec = window.get("moe_d_ff", wg.shape[-1]) if window else None
    if espec is not None and (path == "dense" or fspec is None):
        # the stacks narrowed to the experts' windows: a view for a shared
        # window, a gather for per-client ones; a moe_d_ff window on the
        # dropping path reads the full stacks in place instead
        wg, wu, wd = (espec.take(t) for t in (wg, wu, wd))
    w, idx, aux = _route(router, xt, cfg)
    E, k, T = router.shape[-1], idx.shape[-1], xt.shape[1]
    act = act_fn(cfg.act)

    if path == "dense":
        if fspec is not None:     # dense path: slice the window (test oracle)
            wg, wu = fspec.take(wg, dim=3), fspec.take(wu, dim=3)
            wd = fspec.take(wd, dim=2)
        x2 = wide(xt)      # one widened x for the gate/up pair
        g = act(einsum("ctd,cedf->ctef", x2, wg, xt.dtype))
        u = einsum("ctd,cedf->ctef", x2, wu, xt.dtype)
        y_all = einsum("ctef,cefd->cted", g * u, wd)          # [C, T, E, D]
        gate = torch.zeros((C, T, E), dtype=xt.dtype,
                           device=xt.device).scatter(2, idx, w)
        out = einsum("cted,cte->ctd", y_all, gate)
    elif path == "dropping":
        cap = min(max(int(T * k / E * mo.capacity_factor), 1), T)
        src, pick = _dispatch(idx, E, cap)
        lanes = torch.arange(C, device=x.device)[:, None]
        xpad = torch.cat([xt, xt.new_zeros(C, 1, D)], 1)      # row T: zeros
        xin = xpad[lanes, src].view(C, E, cap, D)
        if fspec is not None:
            y = _expert_ffn_windowed(wg, wu, wd, xin, cfg.act, eoffs,
                                     fspec)
        else:
            y = _expert_ffn(wg, wu, wd, xin, cfg.act)
        ypad = torch.cat([y.reshape(C, E * cap, D), y.new_zeros(C, 1, D)], 1)
        # each token's choices in order of ascending expert (the
        # reference's scatter-add order)
        order = torch.argsort(idx, dim=-1)
        pick, w = pick.gather(-1, order), w.gather(-1, order)
        contrib = ypad[lanes[..., None], pick] * w[..., None]  # [C, T, k, D]
        out = contrib[:, :, 0]
        for j in range(1, k):
            out = out + contrib[:, :, j]
    else:
        raise ValueError(f"moe path must be 'dense' or 'dropping'; got "
                         f"{path!r}")

    if mo.n_shared:
        sp = {name: p[f"shared/{name}"] for name in ("w_gate", "w_up",
                                                     "w_down")}
        sspec = (window.get("moe_d_ff", sp["w_gate"].shape[-1])
                 if window else None)
        if sspec is not None:     # shared width n_shared*F windows separately
            out = out + mlp_apply_rolling(sp, xt, sspec, cfg.act)
        else:
            out = out + mlp_apply(sp, xt, cfg.act)
    return (out.reshape(C, B, S, D).to(x.dtype),
            aux * mo.aux_loss_weight)

