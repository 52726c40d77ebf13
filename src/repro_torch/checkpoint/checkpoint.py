"""Params checkpoints: npz payload + json metadata, atomic writes.

Ports ``save`` and ``load`` of ``repro/checkpoint/checkpoint.py`` and writes
its file layout: the params as the reference nests them (``layers``
stacked on a leading axis, ``repro_torch.convert.to_reference``), flattened
to ``/``-joined npz keys, and ``<path>.json`` holding the caller's metadata
plus ``dtypes`` per key.  A file written by either package loads in the
other.  Only params are stored (the reference also stores tuples of
optimizer state, which the port does not have yet).  The port runs
float32; bfloat16 entries are refused.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import convert


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _refuse_bf16(names):
    if names:
        raise ValueError(f"the port runs float32; {sorted(names)[:3]} are "
                         "bfloat16")


def save(path: str, params, metadata: dict | None = None):
    """Write the port's flat ``{path: tensor}`` params to ``path`` (npz)
    and ``path + ".json"`` in the reference's layout, atomically."""
    _refuse_bf16([k for k, v in params.items()
                  if v.dtype == torch.bfloat16])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(convert.to_reference(params))
    dtypes = {k: str(v.dtype) for k, v in flat.items()}
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    meta = dict(metadata or {})
    meta["dtypes"] = dtypes
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=1)


def load(path: str, device="cuda") -> Tuple[Dict[str, Any], dict]:
    """Read a checkpoint written by either package; returns ``(params,
    metadata)``, the params as the port's flat dict on ``device``."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    _refuse_bf16([k for k, dt in meta.get("dtypes", {}).items()
                  if "bfloat16" in dt])
    return convert.from_reference(_unflatten(flat), device=device), meta
