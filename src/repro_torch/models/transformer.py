"""Model assembly for the whole zoo: the dense GQA family (with
``qk_norm``), MLA with leading dense layers and the MTP block, the MoE
family, the SSM family, the hybrid block, codebook streams with
sinusoidal positions (audio) and the vision stub (VLM).

Ports ``build_params``, ``_attn_any``, ``block_apply``, ``Model._embed``,
``Model._head``, ``Model.forward``, ``Model.loss`` (with ``window=``, and
the MTP term), ``Model.prefill``, ``Model._pad_caches``,
``Model.decode_step`` (with ``_embed_decode``), ``Model.init_cache`` and
``build_model`` of ``repro/models/transformer.py``.  The reference scans
each stacked layer axis (``_layer_kind``: ``layers``, ``dense_layers``
then ``moe_layers`` when an MoE model leads with dense layers,
``moe_layers``, or ``ssm_layers``) under ``remat``; here the layers are
separate leaves and a plain Python loop runs them.  ``Model.remat``
(default True, as the reference's) rematerialises at the reference's
granularity, one layer: in training with grad enabled each layer runs
under non-reentrant ``torch.utils.checkpoint``, which keeps the layer's
input and recomputes the rest of its forward inside the backward.  The
embedding, the final norm, the head and the MTP block lie outside, as
outside the reference's scan; under ``torch.no_grad()`` (evaluation,
prefill, decode) nothing changes.  An MoE layer's
load-balance loss is summed over the layers into the loss, as the
reference's scan carries it; ``Model.moe_path`` picks the MoE path
(``dropping`` or ``dense``, ``models/moe.py``).  The hybrid block
(``hymba_1_5b``) runs the attention and the SSM branch on the same input
and joins them as ``0.5 * (rms_norm(a, fuse_a) + rms_norm(s, fuse_s))``
before the MLP.  The MTP block (``mtp/*``, no layer axis) is one dense
layer on the final hidden state whose head predicts the token after next:
``loss`` adds ``0.3 * mtp_loss``.

:meth:`Model.forward` and :meth:`Model.loss` take two forms, told apart by
the tokens' rank less one for the codebook axis (``tokens.dim() -
bool(cfg.n_codebooks)``: codebook tokens carry a trailing ``[CB]``):

- one model, the reference's signature: params without a client
  dimension, tokens ``[B, S]`` (``[B, S, CB]``); ``loss`` returns
  ``(scalar, metrics)``.  It runs as C = 1 views, and its ``window=``
  (scalar offsets) counts its window products as the reference's
  scalar-offset kernels.  Its SSM mixers run the SSD chunk kernel (TPU
  row 12), which has no backward: one model's SSM loss evaluates, it does
  not train;
- C clients, the round's form: every leaf carries a leading client
  dimension ``[C, ...]``, tokens are ``[C, B, S]`` (``[C, B, S, CB]``),
  patches ``[C, B, P, vision_d]``, and ``loss`` returns one loss per
  client.  Its SSM mixers run the differentiable
  ``models.ssm.ssd_chunked``, so every family trains.

Serving (``prefill``, ``decode_step``, ``init_cache``) is one model's, in
the reference's signatures.  Caches are a flat ``{path: tensor}`` dict with
one leaf per layer (``layers/3/k`` ``[B, Sc, KV, hd]``, an MLA layer's
compressed ``dense_layers/0/c`` ``[B, S, r]`` and ``kr`` ``[B, S, rd]``,
``ssm_layers/3/h`` ``[B, nh, hd, N]``; a hybrid layer holds ``k``, ``v``,
``h`` and the conv tails), which ``repro_torch.convert`` carries to and
from the reference's stacked ``{stack: {name: [L, B, ...]}}``.
``decode_step(..., mesh=, cp=True)`` decodes context-parallel: each rank
of the mesh's ``data`` axis holds its block of every attention cache's
positions (``launch.specs.cache_shard``).

:meth:`Model.init` makes one (server) model without the client dimension.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import (attn_params, gqa_decode,
                                          gqa_prefill, gqa_train, mla_decode,
                                          mla_params, mla_prefill, mla_train)
from repro_torch.models.layers import (AxisWindow, ParamBuilder, WindowMap,
                                       bmm, gelu, mlp_apply,
                                       mlp_apply_rolling, mlp_params,
                                       rms_norm, sinusoidal_positions,
                                       softmax_xent, wide)
from repro_torch.models.moe import moe_apply, moe_params
from repro_torch.models.ssm import n_heads, ssm_decode, ssm_params, ssm_train

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def _check_supported(cfg: ModelConfig):
    """Refuse a config whose family label and family fields disagree (an
    MoE config without ``moe``, an SSM one without ``ssm``, ...), or a
    family the reference does not have."""
    ssm = cfg.family == "ssm"
    hybrid = cfg.family == "hybrid"
    extras = {"moe": (cfg.moe is not None) != (cfg.family == "moe"),
              "ssm": cfg.ssm is not None and not (ssm or hybrid),
              "no ssm": cfg.ssm is None and (ssm or hybrid),
              "hybrid": cfg.hybrid != hybrid}
    bad = [k for k, v in extras.items() if v]
    if cfg.family not in FAMILIES or bad:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with {bad or 'its fields'} "
            f"is not a configuration of the model zoo; the port runs the "
            f"families {FAMILIES} as the reference's configs define them")


def _layer_kind(cfg: ModelConfig) -> Tuple[str, ...]:
    """Stack names in execution order."""
    if cfg.family == "ssm":
        return ("ssm_layers",)
    if cfg.moe is not None and cfg.n_dense_layers:
        return ("dense_layers", "moe_layers")
    if cfg.moe is not None:
        return ("moe_layers",)
    return ("layers",)


def _stack_layers(cfg: ModelConfig, stack: str) -> int:
    """The number of layers in ``stack``: the leading dense layers, then
    the rest as MoE layers."""
    if stack == "dense_layers":
        return cfg.n_dense_layers
    if stack == "moe_layers":
        return cfg.n_layers - cfg.n_dense_layers
    return cfg.n_layers


def _block_params(b: ParamBuilder, pre: str, cfg: ModelConfig, moe: bool):
    D = cfg.d_model
    b.const(f"{pre}/ln1", (D,), ("d_model",), 1.0)
    if cfg.family == "ssm":
        ssm_params(b, f"{pre}/ssm", cfg)
        return
    if cfg.mla is not None:
        mla_params(b, f"{pre}/attn", cfg)
    else:
        attn_params(b, f"{pre}/attn", cfg)
    if cfg.hybrid:
        ssm_params(b, f"{pre}/ssm", cfg)
        b.const(f"{pre}/fuse_a", (D,), ("d_model",), 1.0)
        b.const(f"{pre}/fuse_s", (D,), ("d_model",), 1.0)
    b.const(f"{pre}/ln2", (D,), ("d_model",), 1.0)
    if moe:
        moe_params(b, f"{pre}/moe", cfg)
    else:
        mlp_params(b, f"{pre}/mlp", D, cfg.d_ff)


def build_params(cfg: ModelConfig, seed=0, device="cuda",
                 dtype=torch.float32
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple]]:
    b = ParamBuilder(seed, device, dtype)
    D, V = cfg.d_model, cfg.vocab
    if cfg.n_codebooks:
        CB = cfg.n_codebooks
        b.dense("embed", (CB, V, D), ("codebooks", "vocab", "d_model"),
                scale=0.02)
        b.dense("head", (CB, D, V), ("codebooks", "d_model", "vocab"))
    else:
        b.dense("embed", (V, D), ("vocab", "d_model"), scale=0.02)
        if not cfg.tie_embeddings:
            b.dense("head", (D, V), ("d_model", "vocab"))
    if cfg.vision_stub:
        b.dense("vision_proj/w1", (cfg.vision_d, D), ("vision_d", "d_model"))
        b.dense("vision_proj/w2", (D, D), ("d_model", "d_model"))
    for stack in _layer_kind(cfg):
        for i in range(_stack_layers(cfg, stack)):
            _block_params(b, f"{stack}/{i}", cfg, stack == "moe_layers")
    b.const("final_norm", (D,), ("d_model",), 1.0)
    if cfg.mtp:
        b.const("mtp/ln1", (D,), ("d_model",), 1.0)
        if cfg.mla is None:
            attn_params(b, "mtp/attn", cfg)
        else:
            mla_params(b, "mtp/attn", cfg)
        b.const("mtp/ln2", (D,), ("d_model",), 1.0)
        mlp_params(b, "mtp/mlp", D, cfg.d_ff)
        b.const("mtp/final", (D,), ("d_model",), 1.0)
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


def _attn_any(p, x, cfg, positions, mode, cache, pos, valid, rope_pos,
              window, mesh=None, cp=False):
    """The layer's attention (MLA or GQA) in ``mode``; returns ``(out,
    cache)``, the cache empty in ``train`` mode."""
    if cfg.mla is not None:
        if window is not None and \
                window.get("kv_heads", cfg.n_kv_heads) is not None:
            # every head shares the compressed kv: refuse rather than
            # silently ignore the window
            raise ValueError(
                "MLA attention has no kv_heads axis to window; window the "
                "standalone heads axis instead (windowed per-head "
                "up-projections)")
        if mode == "train":
            return mla_train(p, x, cfg, positions, window=window), {}
        if mode == "prefill":
            return mla_prefill(p, x, cfg, positions)
        return mla_decode(p, x, cfg, cache, pos, mesh, cp,
                          valid_override=valid,
                          rope_pos=rope_pos)
    if mode == "train":
        return gqa_train(p, x, cfg, positions, window=window), {}
    if mode == "prefill":
        S = x.shape[2]
        clen = min(S, cfg.sliding_window) if cfg.sliding_window else S
        return gqa_prefill(p, x, cfg, positions, clen)
    return gqa_decode(p, x, cfg, cache, pos, mesh, cp, valid_override=valid,
                      rope_pos=rope_pos)


def block_apply(p, h, cfg, positions, window=None, mode="train", cache=None,
                pos=None, valid=None, rope_pos=None, one=False,
                moe_path="dropping", mesh=None, cp=False):
    """One layer on ``h [C, B, S, D]``; returns ``(h, aux [C] or None, new
    cache)``: ``aux`` is an MoE layer's load-balance loss per client (None
    for other layers), and the cache is empty in ``train`` mode.
    ``window`` (a :class:`WindowMap` or None) routes the windowed products
    through the fused sub-model forward on the full weights (attention,
    MLP, MoE experts and SSM mixer alike); ``mode`` is ``train``,
    ``prefill`` or ``decode`` (one token against ``cache``, at position
    ``pos``); ``one`` marks one model's form (its SSM mixers run the SSD
    chunk kernel).  A layer with ``moe/*`` leaves runs the MoE, one with
    ``mlp/*`` leaves (a dense layer, the MTP block) the gated MLP.
    ``mesh`` and ``cp``: context-parallel decode of the attention (an SSM
    mixer's state is not split)."""
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    if cfg.family == "ssm":
        out, c = _ssm_block(_sub(p, "ssm"), x, cfg, mode, cache, pos, window,
                            one)
        return h + out, None, c
    a, c = _attn_any(_sub(p, "attn"), x, cfg, positions, mode, cache, pos,
                     valid, rope_pos, window, mesh, cp)
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


#: the attention caches and the positions each pads to: a GQA layer's ring
#: (``k``, ``v``) to at most the sliding window, MLA's compressed ``c`` and
#: ``kr`` to the full length
KV_CACHE = ("k", "v")
MLA_CACHE = ("c", "kr")


#: the parameter dtypes a model takes (every family takes both)
PARAM_DTYPES = (torch.float32, torch.bfloat16)


@dataclass
class Model:
    cfg: ModelConfig
    moe_path: str = "dropping"     # MoE layers: "dropping" or "dense"
    # rematerialise each layer in training (the reference's jax.checkpoint
    # of the scanned layer): its activations are recomputed in the backward
    remat: bool = True
    # float32 or bfloat16: the dtype ``init`` draws the params in.
    # Activations follow the embedding's dtype, as in the reference; the
    # products sum in float32 and round once, the loss is taken in float32
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        _check_supported(self.cfg)
        if self.moe_path not in ("dropping", "dense"):
            raise ValueError(f"moe_path must be 'dropping' or 'dense'; got "
                             f"{self.moe_path!r}")
        if self.param_dtype not in PARAM_DTYPES:
            raise ValueError(f"param_dtype must be one of {PARAM_DTYPES}; "
                             f"got {self.param_dtype!r}")

    def init(self, seed=0, device="cuda") -> Dict[str, torch.Tensor]:
        """Random server params of ``param_dtype``, drawn from ``seed`` on
        ``device``."""
        params, _ = build_params(self.cfg, seed, resolve_device(device),
                                 self.param_dtype)
        return params

    def abstract_params(self) -> Dict[str, torch.Size]:
        """``{path: shape}``; the params' dtype is ``param_dtype``."""
        params, _ = build_params(self.cfg, 0, "meta", self.param_dtype)
        return {k: v.shape for k, v in params.items()}

    def axes(self) -> Dict[str, tuple]:
        return build_params(self.cfg, 0, "meta")[1]

    def _is_one(self, tokens) -> bool:
        """Whether ``tokens`` are one model's (``[B, S]``, or ``[B, S, CB]``
        with codebooks) rather than C clients'."""
        return tokens.dim() - bool(self.cfg.n_codebooks) == 2

    def _one_model(self, params, window):
        """One model's params and window as the C = 1 form takes them:
        ``unsqueeze(0)`` views, and scalar :class:`AxisWindow` s.
        ``window`` is a :class:`WindowMap`, a ``{(axis, size): (offset,
        win) | AxisWindow}`` dict, or an ``(offset, win)`` pair meaning a
        bare ``d_ff`` window (the reference's ``_norm_window`` forms)."""
        if params["embed"].dim() != 2 + bool(self.cfg.n_codebooks):
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

    def _patches(self, extra, one):
        """The vision stub's ``patches`` of ``extra`` (a batch or the
        prefill's inputs) in the clients' form, or None (no stub, or no
        patches given)."""
        if not self.cfg.vision_stub or extra is None or "patches" not in extra:
            return None
        return extra["patches"][None] if one else extra["patches"]

    def forward(self, params, tokens, extra=None, window=None):
        """tokens ``[B, S]`` (one model) or ``[C, B, S]`` (C clients) int,
        with a trailing ``[CB]`` for codebooks; ``extra`` may carry the
        vision stub's ``patches``; ``window`` routes every windowed product
        through the fused sub-model forward.  Returns logits ``[(C,) B, P +
        S, (CB,) V]`` and the final hidden state."""
        if self._is_one(tokens):
            params, window = self._one_model(params, window)
            logits, _, h = self._forward(params, tokens[None],
                                         self._patches(extra, True), window,
                                         one=True)
            return logits[0], h[0]
        logits, _, h = self._forward(params, tokens,
                                     self._patches(extra, False), window)
        return logits, h

    def _prefixes(self):
        return [f"{stack}/{i}" for stack in _layer_kind(self.cfg)
                for i in range(_stack_layers(self.cfg, stack))]

    def _embed(self, params, tokens, patches=None, pos=None):
        """tokens ``[C, B, S]`` (``[C, B, S, CB]``: the codebooks' rows
        summed, in the embedding's dtype) -> ``[C, B, S, D]``, each
        client's rows; sinusoidal positions added at ``0..S-1`` (at ``pos``
        for a decode step), rounded once to that dtype; the projected
        ``patches [C, B, P, vision_d]`` prepended.  The projector follows
        jnp's promotion of the reference's float32 patches: ``w1`` and
        ``w2`` widened, the products and the gelu in float32, one rounding
        to the embedding's dtype."""
        cfg = self.cfg
        C = tokens.shape[0]
        emb = params["embed"]                     # [C, (CB,) V, D]
        V, D = emb.shape[-2], emb.shape[-1]
        table = emb.reshape(-1, D)
        base = torch.arange(C, device=tokens.device).view(C, 1, 1)
        if cfg.n_codebooks:
            CB = cfg.n_codebooks
            h = 0.0
            for cb in range(CB):
                h = h + F.embedding(tokens[..., cb] + (base * CB + cb) * V,
                                    table)
        else:
            h = F.embedding(tokens + base * V, table)
        if cfg.pos_embed == "sinusoidal":
            S = tokens.shape[2]
            at = (torch.arange(S, device=tokens.device) if pos is None else
                  torch.full((S,), int(pos), device=tokens.device))
            h = h + sinusoidal_positions(at, D).to(h.dtype)
        if patches is not None:
            w1, w2 = (params[f"vision_proj/{w}"].float() for w in ("w1",
                                                                   "w2"))
            vp = torch.bmm(gelu(torch.bmm(
                patches.reshape(C, -1, patches.shape[-1]).float(), w1)), w2)
            h = torch.cat([vp.reshape(C, patches.shape[1], -1, D)
                           .to(h.dtype), h], dim=2)
        return h

    def _head(self, params, h):
        """``h [C, B, S, D]`` -> logits ``[C, B, S, V]`` (the tied head
        multiplies by the embedding's transpose; codebooks give ``[C, B,
        S, CB, V]``, a head each: one ``bmm`` over a ``[C * CB]`` batch, on
        one widened h, so that h's gradient sums over the codebooks in
        float32 and rounds once, as the reference's one ``einsum``)."""
        C, B, S, D = h.shape
        if self.cfg.n_codebooks:
            CB = self.cfg.n_codebooks
            hw = wide(h).reshape(C, 1, B * S, D).expand(C, CB, B * S, D)
            head = params["head"]
            logits = bmm(hw.reshape(C * CB, B * S, D),
                         head.reshape(C * CB, D, head.shape[-1]), h.dtype)
            return logits.view(C, CB, B, S, -1).permute(0, 2, 3, 1, 4)
        w = (params["embed"].transpose(1, 2) if self.cfg.tie_embeddings
             else params["head"])
        return bmm(h.reshape(C, B * S, D), w).reshape(C, B, S, -1)

    def _run(self, params, h, positions, mode, window=None, caches=None,
             pos=None, valid=None, rope_pos=None, one=False, mesh=None,
             cp=False):
        """Every layer in order; returns ``h``, the load-balance loss
        summed over the layers (``[C]``, zeros without MoE layers) and the
        new caches (flat, keyed ``{stack}/{i}/{name}``).  In training with
        grad enabled and ``remat``, each layer runs under non-reentrant
        checkpointing (the rounds take their gradients with
        ``torch.autograd.grad``, which the reentrant form refuses); the
        layers draw no random numbers, so no RNG state is kept for the
        recompute."""
        remat = self.remat and mode == "train" and torch.is_grad_enabled()
        prefixes = self._prefixes()
        layers = _by_layer(params, prefixes)
        layer_caches = (_by_layer(caches, prefixes) if caches is not None
                        else {})
        aux_total = torch.zeros(h.shape[0], device=h.device)
        new = {}
        for pre in prefixes:
            args = (layers[pre], h, self.cfg, positions, window, mode,
                    layer_caches.get(pre), pos, valid, rope_pos, one,
                    self.moe_path, mesh, cp)
            if remat:
                h, aux, c = checkpoint(block_apply, *args,
                                       use_reentrant=False,
                                       preserve_rng_state=False)
            else:
                h, aux, c = block_apply(*args)
            if aux is not None:
                aux_total = aux_total + aux
            new.update({f"{pre}/{k}": v for k, v in c.items()})
        return h, aux_total, new

    def _forward(self, params, tokens, patches, window: Optional[WindowMap],
                 one=False):
        """Logits, the layers' summed load-balance loss ``[C]`` and the
        final hidden state."""
        h = self._embed(params, tokens, patches)
        positions = torch.arange(h.shape[2], device=tokens.device)
        h, aux, _ = self._run(params, h, positions, "train", window, one=one)
        h = rms_norm(h, params["final_norm"], self.cfg.norm_eps)
        return self._head(params, h), aux, h

    def loss(self, params, batch, window=None):
        """batch ``{"tokens": [B, S]}`` (one model; ``[B, S, CB]`` with
        codebooks, and the vision stub's optional ``patches [B, P,
        vision_d]``): returns ``(loss, metrics)``: the mean next-token
        cross-entropy (over every codebook) plus the MoE layers'
        load-balance loss and ``0.3 *`` the MTP block's loss on the token
        after next, with the reference's ``lm_loss``, ``aux_loss`` (0
        without MoE layers), ``mtp_loss`` (MTP models) and ``loss``; the
        patches' logits are dropped.  batch ``{"tokens": [C, B, S]}``:
        returns ``(loss [C], metrics [C])``, each client's own.  ``window``
        is threaded into the MTP block too."""
        cfg = self.cfg
        tokens = batch["tokens"]
        one = self._is_one(tokens)
        patches = self._patches(batch, one)
        if one:
            params, window = self._one_model(params, window)
            tokens = tokens[None]
        logits, aux, h = self._forward(params, tokens, patches, window,
                                       one=one)
        P = cfg.vision_patches if patches is not None else 0
        logits = logits[:, :, P:]
        lm = softmax_xent(logits[:, :, :-1], tokens[:, :, 1:])
        total = lm + aux
        metrics = {"lm_loss": lm, "aux_loss": aux}
        if cfg.mtp and not cfg.n_codebooks:
            hp = h[:, :, P:]
            positions = torch.arange(hp.shape[2], device=hp.device)
            hm, _, _ = block_apply(_sub(params, "mtp"), hp, cfg, positions,
                                   window, one=one, moe_path=self.moe_path)
            hm = rms_norm(hm, params["mtp/final"], cfg.norm_eps)
            mtp = softmax_xent(self._head(params, hm)[:, :, :-2],
                               tokens[:, :, 2:])
            total = total + 0.3 * mtp
            metrics["mtp_loss"] = mtp
        metrics["loss"] = total
        if not one:
            return total, metrics
        return total[0], {k: v[0] for k, v in metrics.items()}

    # -- serving (one model) -------------------------------------------------
    def prefill(self, params, tokens, extra=None, max_len=None, pos_offset=0,
                return_all_logits=False):
        """tokens ``[B, S]`` (``[B, S, CB]``) int: run the prompt, after
        the vision stub's ``extra["patches"] [B, P, vision_d]`` if given,
        and build the caches.  ``max_len``: total cache capacity for the
        ``decode_step`` s that follow (the caches are padded to it);
        ``pos_offset``: position of the first token (of the rotary
        positions; sinusoidal ones start at 0, as in the reference);
        ``return_all_logits``: logits at every position rather than the
        last one's.  Returns ``(logits, caches)``."""
        p1, _ = self._one_model(params, None)
        h = self._embed(p1, tokens[None], self._patches(extra, True))
        positions = pos_offset + torch.arange(h.shape[2],
                                              device=tokens.device)
        h, _, caches = self._run(p1, h, positions, "prefill")
        h = rms_norm(h, p1["final_norm"], self.cfg.norm_eps)
        logits = self._head(p1, h if return_all_logits else h[:, :, -1:])[0]
        caches = {k: v[0] for k, v in caches.items()}
        if max_len is not None:
            caches = self._pad_caches(caches, max_len)
        return (logits if return_all_logits else logits[:, 0]), caches

    def _pad_caches(self, caches, max_len):
        """Zero-pad each attention cache along its positions to ``max_len``
        (a sliding window's ring to at most the window)."""
        cfg = self.cfg
        kv_target = (min(max_len, cfg.sliding_window) if cfg.sliding_window
                     else max_len)
        out = {}
        for path, x in caches.items():
            key = path.rsplit("/", 1)[-1]
            target = (kv_target if key in KV_CACHE else
                      max_len if key in MLA_CACHE else 0)
            if x.shape[1] < target:
                pad = [0, 0] * (x.dim() - 2) + [0, target - x.shape[1]]
                x = F.pad(x, pad)
            out[path] = x
        return out

    def decode_step(self, params, tokens, caches, pos, mesh=None, cp=False,
                    valid=None, rope_pos=None):
        """tokens ``[B]`` (``[B, CB]``) int; caches from :meth:`prefill` or
        :meth:`init_cache`; ``pos`` the host integer position of the token
        (a sinusoidal model's position too); ``valid [B, Sc]`` an optional
        per-slot cache mask and ``rope_pos [B]`` per-row positions
        (continuous batching).  With ``cp`` and a ``mesh`` the attention
        caches are this rank's block of positions on the mesh's ``data``
        axis (``launch.specs.cache_shard``) and attention is
        context-parallel; ``valid`` still covers every position.  Returns
        ``(logits [B, (CB,) V], new caches)``; the caches passed in are not
        changed."""
        p1, _ = self._one_model(params, None)
        h = self._embed(p1, tokens[None, :, None], pos=pos)
        c1 = {k: v[None] for k, v in caches.items()}
        h, _, new = self._run(p1, h, None, "decode", caches=c1, pos=pos,
                              valid=valid, rope_pos=rope_pos, mesh=mesh,
                              cp=cp)
        h = rms_norm(h, p1["final_norm"], self.cfg.norm_eps)
        return self._head(p1, h)[0, :, 0], {k: v[0] for k, v in new.items()}

    def init_cache(self, batch: int, seq_len: int, dtype=torch.bfloat16,
                   device="cuda") -> Dict[str, torch.Tensor]:
        """Empty caches for ``batch`` rows of ``seq_len`` positions (the
        SSM state in float32, the rest in ``dtype``), on ``device``."""
        cfg = self.cfg
        dev = resolve_device(device)
        caches = {}

        def zeros(path, *shape, dt=dtype):
            caches[path] = torch.zeros((batch, *shape), dtype=dt, device=dev)
        for pre in self._prefixes():
            if cfg.mla is not None:
                m = cfg.mla
                zeros(f"{pre}/c", seq_len, m.kv_lora_rank)
                zeros(f"{pre}/kr", seq_len, m.rope_head_dim)
            elif cfg.family != "ssm":
                Sc = (min(seq_len, cfg.sliding_window) if cfg.sliding_window
                      else seq_len)
                for name in KV_CACHE:
                    zeros(f"{pre}/{name}", Sc, cfg.n_kv_heads, cfg.head_dim)
            if cfg.ssm is not None:
                s = cfg.ssm
                nh = n_heads(cfg)
                zeros(f"{pre}/h", nh, s.head_dim, s.d_state,
                      dt=torch.float32)
                for name, ch in (("conv_x", nh * s.head_dim),
                                 ("conv_B", s.d_state),
                                 ("conv_C", s.d_state)):
                    zeros(f"{pre}/{name}", s.conv_width - 1, ch)
        return caches


def build_model(cfg: ModelConfig, moe_path: str = "dropping",
                param_dtype: torch.dtype = torch.float32,
                remat: bool = True) -> Model:
    return Model(cfg, moe_path=moe_path, remat=remat,
                 param_dtype=param_dtype)
