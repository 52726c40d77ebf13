"""Window extraction and scatter on axis-tagged parameter dicts.

Ports ``_windowed_dims``, ``extract``, ``scatter_delta``, ``window_mask``
and ``sub_abstract`` of ``repro/core/extract.py``.  A window here is a
view (``narrow``), never a copy: the shared-window aggregation reads and
updates params through it, and ``scatter_delta`` writes a compact delta
into a full-shaped zero tensor through one.  Offsets are host integers
(``{axis: int}``, one window); sizes are static.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.masking import AxisKey


def _windowed_dims(shape, axes, sizes: Dict[AxisKey, int]):
    out = []
    for d, name in enumerate(axes):
        key = (name, int(shape[d]))
        if key in sizes and sizes[key] < shape[d]:
            out.append((d, key))
    return out


def extract(params, axes, offsets, sizes, lead=0):
    """Every leaf narrowed to its window: ``offsets`` ``{axis: int}`` (one
    window shared by every leading row); ``lead`` leading dims (clients)
    come before the tagged ones."""
    out = {}
    for path, leaf in params.items():
        for d, key in _windowed_dims(leaf.shape[lead:], axes[path], sizes):
            leaf = leaf.narrow(lead + d, offsets[key], sizes[key])
        out[path] = leaf
    return out


def scatter_delta(delta, full_abstract, axes, offsets, sizes):
    """Each compact leaf of ``delta`` placed at its window in a full-shaped
    float32 zero tensor (``full_abstract``: ``{path: shape}``).  A leaf with
    no windowed axis is its own scatter: it comes back as float32 without a
    copy."""
    out = {}
    for path, sub in delta.items():
        shape = full_abstract[path]
        dims = _windowed_dims(shape, axes[path], sizes)
        if not dims:
            out[path] = sub.float()
            continue
        full = torch.zeros(tuple(shape), dtype=torch.float32,
                           device=sub.device)
        view = full
        for d, key in dims:
            view = view.narrow(d, offsets[key], sizes[key])
        view.copy_(sub)
        out[path] = full
    return out


def window_mask(full_abstract, axes, offsets, sizes, dtype=torch.float32,
                device="cpu"):
    """Dense 0/1 masks of the window, one per leaf (the mask-mode form of
    the same sub-model)."""
    out = {}
    for path, shape in full_abstract.items():
        m = torch.ones(tuple(shape), dtype=dtype, device=device)
        for d, key in _windowed_dims(shape, axes[path], sizes):
            idx = torch.arange(shape[d], device=device)
            sel = (idx >= offsets[key]) & (idx < offsets[key] + sizes[key])
            view = [1] * len(shape)
            view[d] = shape[d]
            m = m * sel.view(view).to(dtype)
        out[path] = m
    return out


def sub_abstract(full_abstract, axes, sizes):
    """The compact sub-model's shapes ``{path: torch.Size}``."""
    out = {}
    for path, shape in full_abstract.items():
        shape = list(shape)
        for d, key in _windowed_dims(shape, axes[path], sizes):
            shape[d] = sizes[key]
        out[path] = torch.Size(shape)
    return out
