"""Model assembly for the dense GQA family (with ``qk_norm``), the MoE
family, the SSM family and the hybrid block.

Ports ``build_params``, ``block_apply``, ``Model.forward``, ``Model.loss``
(with ``window=``), ``Model.prefill``, ``Model._pad_caches``,
``Model.decode_step``, ``Model.init_cache`` and ``build_model`` of
``repro/models/transformer.py``.  The reference scans each stacked layer
axis (``_layer_kind``: ``layers``, ``moe_layers`` for the MoE family, or
``ssm_layers`` for the SSM family) under ``remat``; here the layers are
separate leaves and a plain Python loop runs them.  An MoE layer's
load-balance loss is summed over the layers into the loss, as the
reference's scan carries it; ``Model.moe_path`` picks the MoE path
(``dropping`` or ``dense``, ``models/moe.py``).  The hybrid block
(``hymba_1_5b``) runs the attention and the SSM branch on the same input
and joins them as ``0.5 * (rms_norm(a, fuse_a) + rms_norm(s, fuse_s))``
before the MLP.

:meth:`Model.forward` and :meth:`Model.loss` take two forms, told apart by
the tokens' rank:

- one model, the reference's signature: params without a client
  dimension, tokens ``[B, S]``; ``loss`` returns ``(scalar, metrics)``.
  It runs as C = 1 views, and its ``window=`` (scalar offsets) counts
  its window products as the reference's scalar-offset kernels.  Its SSM
  mixers run the SSD chunk kernel (TPU row 12), which has no backward:
  one model's SSM loss evaluates, it does not train;
- C clients, the round's form: every leaf carries a leading client
  dimension ``[C, ...]``, tokens are ``[C, B, S]``, and ``loss`` returns
  one loss per client.  Its SSM mixers run the differentiable
  ``models.ssm.ssd_chunked``, so every family trains.

Serving (``prefill``, ``decode_step``, ``init_cache``) is one model's, in
the reference's signatures.  Caches are a flat ``{path: tensor}`` dict with
one leaf per layer (``layers/3/k`` ``[B, Sc, KV, hd]``, ``ssm_layers/3/h``
``[B, nh, hd, N]``; a hybrid layer holds ``k``, ``v``, ``h`` and the conv
tails), which ``repro_torch.convert`` carries to and from the reference's
stacked ``{stack: {name: [L, B, ...]}}``.

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
from repro_torch.models.attention import (attn_params, gqa_decode,
                                          gqa_prefill, gqa_train)
from repro_torch.models.layers import (AxisWindow, ParamBuilder, WindowMap,
                                       mlp_apply, mlp_apply_rolling,
                                       mlp_params, rms_norm, softmax_xent)
from repro_torch.models.moe import moe_apply, moe_params
from repro_torch.models.ssm import n_heads, ssm_decode, ssm_params, ssm_train


def _check_supported(cfg: ModelConfig):
    ssm = cfg.family == "ssm"
    hybrid = cfg.family == "hybrid"
    extras = {"moe": (cfg.moe is not None) != (cfg.family == "moe"),
              "ssm": cfg.ssm is not None and not (ssm or hybrid),
              "no ssm": cfg.ssm is None and (ssm or hybrid),
              "mla": cfg.mla is not None, "hybrid": cfg.hybrid != hybrid,
              "mtp": cfg.mtp, "codebooks": bool(cfg.n_codebooks),
              "vision": cfg.vision_stub,
              "leading dense layers": bool(cfg.moe and cfg.n_dense_layers),
              f"{cfg.pos_embed} positions":
                  cfg.pos_embed != ("none" if ssm else "rope")}
    missing = [k for k, v in extras.items() if v]
    if cfg.family not in ("dense", "moe", "ssm", "hybrid") or missing:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense GQA family with rope "
            f"(and qk_norm), the MoE family, the attention-free SSM family "
            f"and the hybrid block; {missing or cfg.family} is not ported "
            "yet (ROADMAP.md queue A, the rest of the model zoo: MLA and "
            "MTP, audio, VLM)")


def _layer_kind(cfg: ModelConfig) -> Tuple[str, ...]:
    """Stack names in execution order (the MoE family's leading
    ``dense_layers`` come with MLA, and are refused until then)."""
    if cfg.family == "ssm":
        return ("ssm_layers",)
    return ("moe_layers",) if cfg.moe is not None else ("layers",)


def build_params(cfg: ModelConfig, seed=0, device="cuda"
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple]]:
    b = ParamBuilder(seed, device)
    D, V = cfg.d_model, cfg.vocab
    b.dense("embed", (V, D), ("vocab", "d_model"), scale=0.02)
    if not cfg.tie_embeddings:
        b.dense("head", (D, V), ("d_model", "vocab"))
    for stack in _layer_kind(cfg):
        for i in range(cfg.n_layers):
            pre = f"{stack}/{i}"
            b.const(f"{pre}/ln1", (D,), ("d_model",), 1.0)
            if cfg.family == "ssm":
                ssm_params(b, f"{pre}/ssm", cfg)
                continue
            attn_params(b, f"{pre}/attn", cfg)
            if cfg.hybrid:
                ssm_params(b, f"{pre}/ssm", cfg)
                b.const(f"{pre}/fuse_a", (D,), ("d_model",), 1.0)
                b.const(f"{pre}/fuse_s", (D,), ("d_model",), 1.0)
            b.const(f"{pre}/ln2", (D,), ("d_model",), 1.0)
            if stack == "moe_layers":
                moe_params(b, f"{pre}/moe", cfg)
            else:
                mlp_params(b, f"{pre}/mlp", D, cfg.d_ff)
    b.const("final_norm", (D,), ("d_model",), 1.0)
    return b.params, b.axes


def _sub(params, prefix):
    """The leaves under ``prefix/`` as a dict keyed by the rest of the path."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + "/")}


def _by_layer(tree, prefixes):
    """``{prefix: {rest: leaf}}`` for each layer prefix, in one pass."""
    out = {pre: {} for pre in prefixes}
    for k, v in tree.items():
        stack, _, rest = k.partition("/")
        i, _, rest = rest.partition("/")
        sub = out.get(f"{stack}/{i}")
        if sub is not None:
            sub[rest] = v
    return out


#: the SSM mixer's decode cache (a hybrid layer's cache holds k and v too)
SSM_CACHE = ("h", "conv_x", "conv_B", "conv_C")


def _ssm_block(p, x, cfg, mode, cache, pos, window, one):
    """The SSM mixer on ``x [C, B, S, D]``: ``train`` runs the clients'
    differentiable chunked SSD, or with ``one`` (one model's form) the SSD
    chunk kernel; ``prefill`` (one model) the kernel, returning the decode
    cache; ``decode`` (one model) one recurrent step on the C = 1 views."""
    if mode == "train":
        return ssm_train(p, x, cfg, window=window, kernel=one), {}
    if mode == "prefill":
        return ssm_train(p, x, cfg, return_state=True, kernel=True)
    out, c = ssm_decode({k: v[0] for k, v in p.items()}, x[0], cfg,
                        {k: cache[k][0] for k in SSM_CACHE}, pos)
    return out[None], {k: v[None] for k, v in c.items()}


def block_apply(p, h, cfg, positions, window=None, mode="train", cache=None,
                pos=None, valid=None, rope_pos=None, one=False,
                moe_path="dropping"):
    """One layer on ``h [C, B, S, D]``; returns ``(h, aux [C] or None, new
    cache)``: ``aux`` is an MoE layer's load-balance loss per client (None
    for other layers), and the cache is empty in ``train`` mode.
    ``window`` (a :class:`WindowMap` or None) routes the windowed products
    through the fused sub-model forward on the full weights (attention,
    MLP, MoE experts and SSM mixer alike); ``mode`` is ``train``,
    ``prefill`` or ``decode`` (one token against ``cache``, at position
    ``pos``); ``one`` marks one model's form (its SSM mixers run the SSD
    chunk kernel)."""
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    if cfg.family == "ssm":
        out, c = _ssm_block(_sub(p, "ssm"), x, cfg, mode, cache, pos, window,
                            one)
        return h + out, None, c
    attn = _sub(p, "attn")
    if mode == "train":
        a, c = gqa_train(attn, x, cfg, positions, window=window), {}
    elif mode == "prefill":
        S = x.shape[2]
        clen = min(S, cfg.sliding_window) if cfg.sliding_window else S
        a, c = gqa_prefill(attn, x, cfg, positions, clen)
    else:
        a, c = gqa_decode(attn, x, cfg, cache, pos, valid_override=valid,
                          rope_pos=rope_pos)
    if cfg.hybrid:
        s, sc = _ssm_block(_sub(p, "ssm"), x, cfg, mode, cache, pos, window,
                           one)
        c = {**c, **sc}
        a = 0.5 * (rms_norm(a, p["fuse_a"], cfg.norm_eps)
                   + rms_norm(s, p["fuse_s"], cfg.norm_eps))
    h = h + a
    x2 = rms_norm(h, p["ln2"], cfg.norm_eps)
    if "moe/router" in p:
        out, aux = moe_apply(_sub(p, "moe"), x2, cfg, path=moe_path,
                             window=window)
        return h + out, aux, c
    mlp = _sub(p, "mlp")
    spec = window.get("d_ff", mlp["w_gate"].shape[-1]) if window else None
    if spec is not None:
        out = mlp_apply_rolling(mlp, x2, spec, cfg.act)
    else:
        out = mlp_apply(mlp, x2, cfg.act)
    return h + out, None, c


@dataclass
class Model:
    cfg: ModelConfig
    moe_path: str = "dropping"     # MoE layers: "dropping" or "dense"

    def __post_init__(self):
        _check_supported(self.cfg)
        if self.moe_path not in ("dropping", "dense"):
            raise ValueError(f"moe_path must be 'dropping' or 'dense'; got "
                             f"{self.moe_path!r}")

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
            logits, _, h = self._forward(params, tokens[None], window,
                                         one=True)
            return logits[0], h[0]
        logits, _, h = self._forward(params, tokens, window)
        return logits, h

    def _prefixes(self):
        return [f"{stack}/{i}" for stack in _layer_kind(self.cfg)
                for i in range(self.cfg.n_layers)]

    def _embed(self, params, tokens):
        """tokens ``[C, B, S]`` -> ``[C, B, S, D]``, each client's rows."""
        C = tokens.shape[0]
        emb = params["embed"]                                 # [C, V, D]
        V = emb.shape[1]
        rows = tokens + (torch.arange(C, device=tokens.device) * V
                         ).view(C, 1, 1)
        return F.embedding(rows, emb.reshape(C * V, emb.shape[2]))

    def _head(self, params, h):
        """``h [C, B, S, D]`` -> logits ``[C, B, S, V]`` (the tied head
        multiplies by the embedding's transpose)."""
        C, B, S, D = h.shape
        w = (params["embed"].transpose(1, 2) if self.cfg.tie_embeddings
             else params["head"])
        return torch.bmm(h.reshape(C, B * S, D), w).reshape(C, B, S, -1)

    def _run(self, params, h, positions, mode, window=None, caches=None,
             pos=None, valid=None, rope_pos=None, one=False):
        """Every layer in order; returns ``h``, the load-balance loss
        summed over the layers (``[C]``, zeros without MoE layers) and the
        new caches (flat, keyed ``{stack}/{i}/{name}``)."""
        prefixes = self._prefixes()
        layers = _by_layer(params, prefixes)
        layer_caches = (_by_layer(caches, prefixes) if caches is not None
                        else {})
        aux_total = torch.zeros(h.shape[0], device=h.device)
        new = {}
        for pre in prefixes:
            h, aux, c = block_apply(layers[pre], h, self.cfg, positions,
                                    window, mode, layer_caches.get(pre), pos,
                                    valid, rope_pos, one, self.moe_path)
            if aux is not None:
                aux_total = aux_total + aux
            new.update({f"{pre}/{k}": v for k, v in c.items()})
        return h, aux_total, new

    def _forward(self, params, tokens, window: Optional[WindowMap],
                 one=False):
        """Logits, the layers' summed load-balance loss ``[C]`` and the
        final hidden state."""
        S = tokens.shape[2]
        h = self._embed(params, tokens)
        positions = torch.arange(S, device=tokens.device)
        h, aux, _ = self._run(params, h, positions, "train", window, one=one)
        h = rms_norm(h, params["final_norm"], self.cfg.norm_eps)
        return self._head(params, h), aux, h

    def loss(self, params, batch, window=None):
        """batch ``{"tokens": [B, S]}`` (one model): returns ``(loss,
        metrics)``: the mean next-token cross-entropy plus the MoE layers'
        load-balance loss, with the reference's ``lm_loss``, ``aux_loss``
        (0 without MoE layers) and ``loss``.  batch ``{"tokens": [C, B,
        S]}``: returns ``(loss [C], metrics [C])``, each client's own."""
        tokens = batch["tokens"]
        one = tokens.dim() == 2
        if one:
            params, window = self._one_model(params, window)
            tokens = tokens[None]
        logits, aux, _ = self._forward(params, tokens, window, one=one)
        lm = softmax_xent(logits[:, :, :-1], tokens[:, :, 1:])
        total = lm + aux
        metrics = {"lm_loss": lm, "aux_loss": aux, "loss": total}
        if not one:
            return total, metrics
        return total[0], {k: v[0] for k, v in metrics.items()}


    # -- serving (one model) -------------------------------------------------
    def prefill(self, params, tokens, max_len=None, pos_offset=0,
                return_all_logits=False):
        """tokens ``[B, S]`` int: run the prompt and build the caches.
        ``max_len``: total cache capacity for the ``decode_step`` s that
        follow (the KV caches are padded to it); ``pos_offset``: position
        of the first token; ``return_all_logits``: logits ``[B, S, V]``
        rather than the last position's ``[B, V]``.  Returns ``(logits,
        caches)``."""
        p1, _ = self._one_model(params, None)
        S = tokens.shape[1]
        h = self._embed(p1, tokens[None])
        positions = pos_offset + torch.arange(S, device=tokens.device)
        h, _, caches = self._run(p1, h, positions, "prefill")
        h = rms_norm(h, p1["final_norm"], self.cfg.norm_eps)
        logits = self._head(p1, h if return_all_logits else h[:, :, -1:])[0]
        caches = {k: v[0] for k, v in caches.items()}
        if max_len is not None:
            caches = self._pad_caches(caches, max_len)
        return (logits if return_all_logits else logits[:, 0]), caches

    def _pad_caches(self, caches, max_len):
        """Zero-pad each KV cache along its positions to ``max_len`` (a
        sliding window's ring to at most the window)."""
        cfg = self.cfg
        kv_target = (min(max_len, cfg.sliding_window) if cfg.sliding_window
                     else max_len)
        out = {}
        for path, x in caches.items():
            key = path.rsplit("/", 1)[-1]
            if key in ("k", "v") and x.shape[1] < kv_target:
                pad = [0, 0] * (x.dim() - 2) + [0, kv_target - x.shape[1]]
                x = F.pad(x, pad)
            out[path] = x
        return out

    def decode_step(self, params, tokens, caches, pos, valid=None,
                    rope_pos=None):
        """tokens ``[B]`` int; caches from :meth:`prefill` or
        :meth:`init_cache`; ``pos`` the host integer position of the token;
        ``valid [B, Sc]`` an optional per-slot cache mask and ``rope_pos
        [B]`` per-row positions (continuous batching).  Returns ``(logits
        [B, V], new caches)``; the caches passed in are not changed."""
        p1, _ = self._one_model(params, None)
        h = self._embed(p1, tokens[None, :, None])
        c1 = {k: v[None] for k, v in caches.items()}
        h, _, new = self._run(p1, h, None, "decode", caches=c1, pos=pos,
                              valid=valid, rope_pos=rope_pos)
        h = rms_norm(h, p1["final_norm"], self.cfg.norm_eps)
        return self._head(p1, h)[0, :, 0], {k: v[0] for k, v in new.items()}

    def init_cache(self, batch: int, seq_len: int, dtype=torch.bfloat16,
                   device="cuda") -> Dict[str, torch.Tensor]:
        """Empty caches for ``batch`` rows of ``seq_len`` positions (the
        SSM state in float32, the rest in ``dtype``), on ``device``."""
        cfg = self.cfg
        dev = resolve_device(device)
        caches = {}
        for pre in self._prefixes():
            if cfg.family != "ssm":
                Sc = (min(seq_len, cfg.sliding_window) if cfg.sliding_window
                      else seq_len)
                for name in ("k", "v"):
                    caches[f"{pre}/{name}"] = torch.zeros(
                        (batch, Sc, cfg.n_kv_heads, cfg.head_dim),
                        dtype=dtype, device=dev)
            if cfg.ssm is not None:
                s = cfg.ssm
                nh = n_heads(cfg)
                caches[f"{pre}/h"] = torch.zeros(
                    (batch, nh, s.head_dim, s.d_state), device=dev)
                for name, ch in (("conv_x", nh * s.head_dim),
                                 ("conv_B", s.d_state),
                                 ("conv_C", s.d_state)):
                    caches[f"{pre}/{name}"] = torch.zeros(
                        (batch, s.conv_width - 1, ch), dtype=dtype,
                        device=dev)
        return caches


def build_model(cfg: ModelConfig, moe_path: str = "dropping") -> Model:
    return Model(cfg, moe_path=moe_path)

