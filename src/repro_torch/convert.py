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
exactly.  bfloat16 crosses without ``ml_dtypes``: a reference bf16 array
(``ml_dtypes.bfloat16``) goes through an int16 view of its bits into a
``torch.bfloat16`` tensor, and :func:`to_reference` widens a bf16 tensor
to float32 (exact; ``jnp.bfloat16`` rounds it back to the same bits).  Per-client trees (masks, client params) carry a leading
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


def as_torch(v) -> torch.Tensor:
    """A leaf as a CPU tensor (a torch tensor as it is): a numpy bfloat16
    array through an int16 view of its bits."""
    if isinstance(v, torch.Tensor):
        return v
    v = np.asarray(v)
    if not (v.flags.c_contiguous and v.flags.writeable):
        v = v.copy()            # torch wraps writable contiguous memory
    if v.dtype.name == "bfloat16":
        return torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(v)


def _stack_at(parts):
    """The index of a path's stack name (the first of :data:`STACKS` among
    its parts: a params tree may sit under other keys), or None."""
    return next((j for j, q in enumerate(parts) if q in STACKS), None)


def from_reference(params_np, device="cuda", lead=0
                   ) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (reference layout; or CPU tensors) ->
    the port's flat dict of copies on ``device``, splitting each stack's
    layer axis (axis ``lead``, after ``lead`` leading client axes)."""
    dev = resolve_device(device)
    out = {}
    for path, v in _flatten(params_np):
        v = as_torch(v)
        parts = path.split("/")
        j = _stack_at(parts)
        if j is None:
            out[path] = v.to(dev, copy=True)
            continue
        head, rest = "/".join(parts[:j + 1]), "/".join(parts[j + 1:])
        for i in range(v.shape[lead]):
            out[f"{head}/{i}/{rest}"] = v.select(lead, i).to(
                dev, copy=True).contiguous()
    return out


def _numpy(v: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy, bf16 widened to float32 (exact)."""
    return (v.float() if v.dtype == torch.bfloat16 else v).numpy()


def to_reference(params, lead=0, leaf=_numpy) -> dict:
    """The port's flat dict -> nested dict of numpy arrays with each
    stack's layers re-stacked on axis ``lead`` (the inverse of
    :func:`from_reference`).  ``leaf`` makes each host tensor's array
    (default: bf16 widened to float32)."""
    stacks: Dict[tuple, Dict[int, torch.Tensor]] = {}
    tree: dict = {}
    for path, v in params.items():
        t = v.detach().cpu()
        parts = path.split("/")
        j = _stack_at(parts)
        if j is not None:
            stacks.setdefault((*parts[:j + 1], *parts[j + 2:]), {})[
                int(parts[j + 1])] = t
            continue
        _insert(tree, parts, leaf(t))
    for parts, layers in stacks.items():
        _insert(tree, list(parts),
                leaf(torch.stack([layers[i] for i in range(len(layers))],
                                 dim=lead)))
    return tree


def _insert(tree, parts, value):
    for q in parts[:-1]:
        tree = tree.setdefault(q, {})
    tree[parts[-1]] = value
