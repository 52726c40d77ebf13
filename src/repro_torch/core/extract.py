"""Window extraction on axis-tagged parameter dicts.

Ports ``_windowed_dims`` and ``extract`` of ``repro/core/extract.py``.  A
window here is a view (``narrow``), never a copy; the shared-window
aggregation reads and updates params through it.
"""
from __future__ import annotations

from typing import Dict

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
