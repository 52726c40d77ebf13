"""Model assembly for the dense GQA family (the port's first slice).

Ports ``build_params``, ``block_apply``, ``Model.forward`` and ``Model.loss``
(with ``window=``) and ``build_model`` of ``repro/models/transformer.py``.
The reference scans a stacked ``layers`` axis under ``remat``; here the
layers are separate leaves and a plain Python loop runs them.

:meth:`Model.forward` and :meth:`Model.loss` take two forms, told apart by
the tokens' rank:

- one model, the reference's signature: params without a client
  dimension, tokens ``[B, S]``; ``loss`` returns ``(scalar, metrics)``.
  It runs as C = 1 views, and its ``window=`` (scalar offsets) counts
  its window products as the reference's scalar-offset kernels;
- C clients, the round's form: every leaf carries a leading client
  dimension ``[C, ...]``, tokens are ``[C, B, S]``, and ``loss`` returns
  one loss per client.

:meth:`Model.init` makes one (server) model without the client dimension.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import attn_params, gqa_train
from repro_torch.models.layers import (AxisWindow, ParamBuilder, WindowMap,
                                       mlp_apply, mlp_apply_rolling,
                                       mlp_params, rms_norm, softmax_xent)


def _check_supported(cfg: ModelConfig):
    extras = {"moe": cfg.moe is not None, "ssm": cfg.ssm is not None,
              "mla": cfg.mla is not None, "hybrid": cfg.hybrid,
              "mtp": cfg.mtp, "codebooks": bool(cfg.n_codebooks),
              "vision": cfg.vision_stub, "qk_norm": cfg.qk_norm,
              "tied embeddings": cfg.tie_embeddings,
              f"{cfg.pos_embed} positions": cfg.pos_embed != "rope"}
    missing = [k for k, v in extras.items() if v]
    if cfg.family != "dense" or missing:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense GQA family with rope; "
            f"{missing or cfg.family} is not ported yet (ROADMAP.md queue A)")


def build_params(cfg: ModelConfig, seed=0, device="cuda"
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple]]:
    b = ParamBuilder(seed, device)
    D, V = cfg.d_model, cfg.vocab
    b.dense("embed", (V, D), ("vocab", "d_model"), scale=0.02)
    b.dense("head", (D, V), ("d_model", "vocab"))
    for i in range(cfg.n_layers):
        pre = f"layers/{i}"
        b.const(f"{pre}/ln1", (D,), ("d_model",), 1.0)
        attn_params(b, f"{pre}/attn", cfg)
        b.const(f"{pre}/ln2", (D,), ("d_model",), 1.0)
        mlp_params(b, f"{pre}/mlp", D, cfg.d_ff)
    b.const("final_norm", (D,), ("d_model",), 1.0)
    return b.params, b.axes


def _sub(params, prefix):
    """The leaves under ``prefix/`` as a dict keyed by the rest of the path."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + "/")}


def block_apply(p, h, cfg, positions, window=None):
    """One layer on ``h [C, B, S, D]``; ``window`` (a :class:`WindowMap` or
    None) routes the windowed products through the fused sub-model forward
    on the full weights."""
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    h = h + gqa_train(_sub(p, "attn"), x, cfg, positions, window=window)
    x2 = rms_norm(h, p["ln2"], cfg.norm_eps)
    mlp = _sub(p, "mlp")
    spec = window.get("d_ff", mlp["w_gate"].shape[-1]) if window else None
    if spec is not None:
        out = mlp_apply_rolling(mlp, x2, spec, cfg.act)
    else:
        out = mlp_apply(mlp, x2, cfg.act)
    return h + out


@dataclass
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        _check_supported(self.cfg)

    def init(self, seed=0, device="cuda") -> Dict[str, torch.Tensor]:
        """Random server params, drawn from ``seed`` on ``device``."""
        params, _ = build_params(self.cfg, seed, resolve_device(device))
        return params

    def abstract_params(self) -> Dict[str, torch.Size]:
        params, _ = build_params(self.cfg, 0, "meta")
        return {k: v.shape for k, v in params.items()}

    def axes(self) -> Dict[str, tuple]:
        return build_params(self.cfg, 0, "meta")[1]

    def _one_model(self, params, window):
        """One model's params and window as the C = 1 form takes them:
        ``unsqueeze(0)`` views, and scalar :class:`AxisWindow` s.
        ``window`` is a :class:`WindowMap`, a ``{(axis, size): (offset,
        win) | AxisWindow}`` dict, or an ``(offset, win)`` pair meaning a
        bare ``d_ff`` window (the reference's ``_norm_window`` forms)."""
        if params["embed"].dim() != 2:
            raise ValueError("tokens [B, S] are one model's; its params "
                             "carry no client dimension")
        params = {k: v.unsqueeze(0) for k, v in params.items()}
        if window is None:
            return params, None
        if isinstance(window, WindowMap):
            window = window.windows
        elif not isinstance(window, dict):
            window = {("d_ff", self.cfg.d_ff): window}
        specs = {}
        for key, spec in window.items():
            offset, win = ((spec.offsets, spec.win)
                           if isinstance(spec, AxisWindow) else spec)
            if np.ndim(offset) and len(offset) != 1:
                raise ValueError(f"one model takes one offset for {key}; "
                                 f"got {offset}")
            specs[key] = AxisWindow(int(np.reshape(offset, -1)[0]), win)
        return params, WindowMap(specs)

    def forward(self, params, tokens, window=None):
        """tokens ``[B, S]`` (one model) or ``[C, B, S]`` (C clients) int;
        ``window`` routes every windowed product through the fused
        sub-model forward.  Returns logits ``[(C,) B, S, V]`` and the final
        hidden state."""
        if tokens.dim() == 2:
            params, window = self._one_model(params, window)
            logits, h = self._forward(params, tokens[None], window)
            return logits[0], h[0]
        return self._forward(params, tokens, window)

    def _forward(self, params, tokens, window: Optional[WindowMap]):
        cfg = self.cfg
        C, B, S = tokens.shape
        emb = params["embed"]                                 # [C, V, D]
        V = emb.shape[1]
        rows = tokens + (torch.arange(C, device=tokens.device) * V
                         ).view(C, 1, 1)
        h = F.embedding(rows, emb.reshape(C * V, emb.shape[2]))
        positions = torch.arange(S, device=tokens.device)
        for i in range(cfg.n_layers):
            h = block_apply(_sub(params, f"layers/{i}"), h, cfg, positions,
                            window=window)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        logits = torch.bmm(h.reshape(C, B * S, -1), params["head"])
        return logits.reshape(C, B, S, -1), h

    def loss(self, params, batch, window=None):
        """batch ``{"tokens": [B, S]}`` (one model): returns ``(loss,
        metrics)`` with the mean next-token cross-entropy and the
        reference's ``lm_loss``, ``aux_loss`` (0 for the dense family) and
        ``loss``.  batch ``{"tokens": [C, B, S]}``: returns ``(loss [C],
        {"lm_loss": loss})``, each client's own."""
        tokens = batch["tokens"]
        one = tokens.dim() == 2
        if one:
            params, window = self._one_model(params, window)
            tokens = tokens[None]
        logits, _ = self._forward(params, tokens, window)
        lm = softmax_xent(logits[:, :, :-1], tokens[:, :, 1:])
        if not one:
            return lm, {"lm_loss": lm}
        lm = lm[0]
        return lm, {"lm_loss": lm, "aux_loss": torch.zeros_like(lm),
                    "loss": lm}


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)

