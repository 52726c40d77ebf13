"""Weights and caches carried between the JAX package's layout and the
port's.

The reference keeps params as a nested dict whose layer stacks (the
subtrees its ``_layer_kind`` names: ``layers``, ``ssm_layers``,
``dense_layers``, ``moe_layers``) stack every layer on a leading axis; the
port keeps a flat ``{path: tensor}`` dict with one leaf per layer
(``layers/3/mlp/w_gate``, ``ssm_layers/3/ssm/w_x``), so that indexing a
layer never makes autograd build a full-stack zero gradient.  The serving
caches are stacked the same way in the reference (``{stack: {"k": [L, B,
...]}}``, ``Model.init_cache``) and flat per layer in the port
(``layers/3/k``, MLA's ``dense_layers/0/c``), so the same functions carry
them.  Leaves outside the stacks (the embedding, the heads, the MTP
block's ``mtp/*``, the vision stub's ``vision_proj/*``) carry no layer
axis and pass through as they are.  Both directions copy values
exactly.  Per-client trees (masks, client params) carry a leading
client axis before the stacked axis (the reference's ``layers/attn/wk``
mask is ``[C, L, D, KV, hd]``); ``lead=1`` splits and re-stacks axis 1
for them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device

#: the reference's layer stacks (``transformer.py`` ``_layer_kind``)
STACKS = ("layers", "ssm_layers", "dense_layers", "moe_layers")


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flatten(v, p)
        else:
            yield p, v


def from_reference(params_np, device="cuda", lead=0
                   ) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (reference layout) -> the port's flat
    dict on ``device``, splitting each stack's layer axis (axis ``lead``,
    after ``lead`` leading client axes)."""
    dev = resolve_device(device)
    out = {}
    for path, v in _flatten(params_np):
        v = np.asarray(v)
        head, _, rest = path.partition("/")
        if head in STACKS:
            for i in range(v.shape[lead]):
                out[f"{head}/{i}/{rest}"] = torch.tensor(
                    np.take(v, i, axis=lead), device=dev)
        else:
            out[path] = torch.tensor(v, device=dev)
    return out


def to_reference(params, lead=0) -> dict:
    """The port's flat dict -> nested dict of numpy arrays with each
    stack's layers re-stacked on axis ``lead`` (the inverse of
    :func:`from_reference`)."""
    stacks: Dict[tuple, Dict[int, np.ndarray]] = {}
    tree: dict = {}
    for path, v in params.items():
        arr = v.detach().cpu().numpy()
        parts = path.split("/")
        if parts[0] in STACKS:
            stacks.setdefault((parts[0], *parts[2:]), {})[int(parts[1])] = arr
            continue
        _insert(tree, parts, arr)
    for parts, layers in stacks.items():
        _insert(tree, list(parts),
                np.stack([layers[i] for i in range(len(layers))],
                         axis=lead))
    return tree


def _insert(tree, parts, value):
    for q in parts[:-1]:
        tree = tree.setdefault(q, {})
    tree[parts[-1]] = value
