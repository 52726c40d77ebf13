"""Pre-activated ResNet (paper §5.1): width-scalable, static BN + scaler.

Ports ``build_resnet_params``, ``_static_bn``, ``_conv``,
``resnet_forward`` and ``resnet_loss`` of ``repro/models/resnet.py``.
Batch norm is *static* (batch statistics every forward, no running
buffers: the HeteroFL trick that makes heterogeneous-width aggregation
sound), and every convolution is followed by a scalar module that
rescales its output by ``1/capacity`` so that a sub-model's activations
match the full model's magnitude.

The leaves keep the reference's layout and axis tags: convolutions HWIO
``(kh, kw, cin, cout)`` tagged ``("conv_kh", "conv_kw", "channels",
"channels")``, so masks, ``repro_torch.convert`` and the ``channels``
window machinery carry over unchanged; the convolution permutes to
torch's layout itself.  The forward and the loss take two forms, told
apart by the images' rank, as ``Model.loss`` does:

- one model: params without a client dimension, images ``[B, H, W, 3]``;
  the loss returns ``(scalar, {"loss", "acc"})``;
- C clients (the round's form): every leaf ``[C, ...]``, images ``[C, B,
  H, W, 3]`` and ``scaler`` ``[C]``; the loss returns ``([C] losses,
  {"loss", "acc"})``, each client's own.

The C clients run as one grouped convolution (``groups=C``) on ``[B, C *
channels, H, W]`` activations.  XLA's ``"SAME"`` padding is asymmetric
on a stride-2 convolution (0 before and 1 after on an even input), so the
padding is explicit.  The convolutions are the library's (``F.conv2d``),
as the reference's are XLA's (``jax.lax.conv_general_dilated``, outside
any Pallas kernel); on the card they follow
``torch.backends.cudnn.allow_tf32``, which a full-f32 run turns off.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.layers import ParamBuilder, softmax_xent


def _conv_p(b, path, kh, kw, cin, cout):
    b.dense(path, (kh, kw, cin, cout),
            ("conv_kh", "conv_kw", "channels", "channels"),
            scale=(2.0 / (kh * kw * cin)) ** 0.5)


def _bn_p(b, path, c):
    b.const(f"{path}/scale", (c,), ("channels",), 1.0)
    b.const(f"{path}/bias", (c,), ("channels",), 0.0)


def build_resnet_params(cfg, seed=0, device="cuda"):
    """``(params, axes)``: flat ``{path: tensor}`` (the reference's tree
    paths, ``stage1/block0/conv1``) drawn from ``seed`` on ``device``
    (``meta`` builds shapes only), and ``{path: axis tags}``."""
    if str(device) != "meta":
        device = resolve_device(device)
    b = ParamBuilder(seed, device)
    w = cfg.width
    _conv_p(b, "stem", 3, 3, cfg.in_channels, w)
    cin = w
    for si, nblocks in enumerate(cfg.stages):
        cout = w * (2 ** si)
        for bi in range(nblocks):
            pre = f"stage{si}/block{bi}"
            _bn_p(b, f"{pre}/bn1", cin)
            _conv_p(b, f"{pre}/conv1", 3, 3, cin, cout)
            _bn_p(b, f"{pre}/bn2", cout)
            _conv_p(b, f"{pre}/conv2", 3, 3, cout, cout)
            if cin != cout or bi == 0 and si > 0:
                _conv_p(b, f"{pre}/proj", 1, 1, cin, cout)
            cin = cout
    _bn_p(b, "final_bn", cin)
    b.dense("fc/w", (cin, cfg.n_classes), ("channels", "classes"))
    b.const("fc/b", (cfg.n_classes,), ("classes",), 0.0)
    return b.params, b.axes


def _clients(x, C):
    """``[B, C * ch, H, W]`` as ``[B, C, ch, H, W]`` (a view)."""
    B, CC, H, W = x.shape
    return x.view(B, C, CC // C, H, W)


def _per_client(v):
    """A ``[C, ch]`` leaf broadcast against ``[B, C, ch, H, W]``."""
    return v.view(1, v.shape[0], v.shape[1], 1, 1)


def _static_bn(x, p, C, eps=1e-5):
    """Each client's channels normalised over its own (B, H, W), with the
    population variance (``jnp.var``, ddof 0)."""
    x5 = _clients(x, C)
    mean = x5.mean(dim=(0, 3, 4), keepdim=True)
    var = x5.var(dim=(0, 3, 4), correction=0, keepdim=True)
    out = ((x5 - mean) * torch.rsqrt(var + eps) * _per_client(p["scale"])
           + _per_client(p["bias"]))
    return out.view(x.shape)


def _same_pad(n, k, s):
    """XLA's ``"SAME"`` padding (before, after) of one spatial dim."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, C, stride=1, scaler=None):
    """``x [B, C * cin, H, W]`` through each client's HWIO kernel ``w [C,
    kh, kw, cin, cout]`` (one grouped convolution), times each client's
    ``scaler [C]`` (None: 1)."""
    _, kh, kw, cin, cout = w.shape
    wt = w.permute(0, 4, 3, 1, 2).reshape(C * cout, cin, kh, kw)
    (t, b_), (l_, r) = (_same_pad(x.shape[2], kh, stride),
                        _same_pad(x.shape[3], kw, stride))
    if t or b_ or l_ or r:
        x = F.pad(x, (l_, r, t, b_))
    out = F.conv2d(x, wt, stride=stride, groups=C)
    if scaler is None:
        return out
    return (_clients(out, C) * scaler.view(1, C, 1, 1, 1)).view(out.shape)


def _forward(params, cfg, images, scaler):
    """C clients: images ``[C, B, H, W, ch]`` -> logits ``[C, B,
    classes]``."""
    C, B, H, W, ch = images.shape
    x = images.permute(1, 0, 4, 2, 3).reshape(B, C * ch, H, W)
    h = _conv(x, params["stem"], C, 1, scaler)
    for si, nblocks in enumerate(cfg.stages):
        for bi in range(nblocks):
            pre = f"stage{si}/block{bi}"
            stride = 2 if (bi == 0 and si > 0) else 1
            z = F.relu(_static_bn(h, _bn(params, f"{pre}/bn1"), C))
            out = _conv(z, params[f"{pre}/conv1"], C, stride, scaler)
            out = F.relu(_static_bn(out, _bn(params, f"{pre}/bn2"), C))
            out = _conv(out, params[f"{pre}/conv2"], C, 1, scaler)
            proj = params.get(f"{pre}/proj")
            skip = h if proj is None else _conv(z, proj, C, stride, scaler)
            h = skip + out
    h = F.relu(_static_bn(h, _bn(params, "final_bn"), C))
    h = _clients(h, C).mean(dim=(3, 4)).transpose(0, 1)      # [C, B, ch]
    return torch.bmm(h, params["fc/w"]) + params["fc/b"][:, None]


def _bn(params, prefix):
    return {"scale": params[f"{prefix}/scale"],
            "bias": params[f"{prefix}/bias"]}


def _scaler(scaler, C, like):
    """``scaler`` as a ``[C]`` tensor, or None for 1."""
    if scaler is None:
        return None
    return torch.as_tensor(scaler, dtype=like.dtype,
                           device=like.device).reshape(-1).expand(C)


def resnet_forward(params, cfg, images, scaler=None):
    """images ``[B, H, W, C]`` (one model) or ``[C, B, H, W, 3]`` (C
    clients) -> logits ``[B, classes]`` or ``[C, B, classes]``.  ``scaler``
    = 1/capacity when running a width-scaled sub-model (the paper's
    scalar-module compensation): a number, or one per client ``[C]``."""
    if images.dim() == 4:
        params = {k: v[None] for k, v in params.items()}
        return resnet_forward(params, cfg, images[None], scaler)[0]
    C = images.shape[0]
    return _forward(params, cfg, images, _scaler(scaler, C, images))


def resnet_loss(params, cfg, batch, scaler=None):
    """Mean cross-entropy and accuracy; ``scaler`` explicit, or per client
    via ``batch["scaler"]`` (1/capacity).  One model: ``(loss, {"loss",
    "acc"})`` scalars; C clients: ``[C]`` each."""
    if scaler is None:
        scaler = batch.get("scaler")
    images, labels = batch["images"], batch["labels"]
    one = images.dim() == 4
    if one:
        params = {k: v[None] for k, v in params.items()}
        images, labels = images[None], labels[None]
    logits = _forward(params, cfg, images,
                      _scaler(scaler, images.shape[0], images))
    loss = softmax_xent(logits, labels)
    acc = (logits.argmax(-1) == labels).float().mean(-1)
    if one:
        loss, acc = loss[0], acc[0]
    return loss, {"loss": loss, "acc": acc}
