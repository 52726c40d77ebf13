"""Checkpoints: npz payload + json metadata, atomic writes.

Ports ``save`` and ``load`` of ``repro/checkpoint/checkpoint.py`` and writes
its file layout, so a file written by either package loads in the other.
A tree is nested dicts, tuples or lists, and leaves (tensors, numpy arrays
or numbers), as the reference's pytrees: the server params beside the
optimizer state and the round counter, say.  A flat ``{path: tensor}``
dict of the port's params is written as the reference nests them (``layers``
stacked on a leading axis, ``repro_torch.convert.to_reference``).  Keys are
``/``-joined, a sequence's items ``#i``; ``<path>.json`` holds the caller's
metadata plus ``dtypes`` per key.  bfloat16 entries are stored as their
``uint16`` bits, which npz can hold, and read back through the same bits
(no ``ml_dtypes`` needed).  Under an initialised ``torch.distributed``
world (a mesh round's ranks, which hold the same params) rank 0 alone
writes, and every rank waits at a barrier until the files are there.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.device import resolve_device


def _nested(tree):
    """The tree with host tensors for leaves, every dict of the port's flat
    params re-nested in the reference's layout, sequences as tuples."""
    if isinstance(tree, (tuple, list)):
        return tuple(_nested(v) for v in tree)
    if not isinstance(tree, dict):
        return convert.as_torch(tree).detach().cpu()
    subtrees = {k: v for k, v in tree.items()
                if isinstance(v, (dict, tuple, list))}
    out = convert.to_reference(
        {k: convert.as_torch(v) for k, v in tree.items()
         if k not in subtrees}, leaf=lambda t: t)
    for k, v in subtrees.items():
        node = out
        *parents, last = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = _nested(v)
    return out


def _array(t: torch.Tensor) -> np.ndarray:
    """A host tensor as the array npz stores: bfloat16 as its uint16
    bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/#{i}" if prefix else f"#{i}"))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(n):
        if isinstance(n, dict):
            if n and all("#" in k for k in n):
                items = sorted(n.items(), key=lambda kv: int(
                    kv[0].split("#")[-1]))
                return tuple(fix(v) for _, v in items)
            return {k: fix(v) for k, v in n.items()}
        return n

    return fix(root)


def _port(tree, device):
    """A loaded tree in the port's form: every dict flat (``{path:
    tensor}`` on ``device``, each stack split into its layers), sequences
    as tuples."""
    if isinstance(tree, tuple):
        return tuple(_port(v, device) for v in tree)
    if not isinstance(tree, dict):
        return convert.as_torch(tree).to(device, copy=True)
    seqs, leaves = {}, {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, tuple):
                seqs[path] = _port(v, device)
            elif isinstance(v, dict):
                walk(v, path)
            else:
                leaves[path] = v

    walk(tree, "")
    out = convert.from_reference(leaves, device=device)
    out.update(seqs)
    return out


def is_writer() -> bool:
    """Whether this process writes files and log lines: rank 0 of an
    initialised ``torch.distributed`` world, or a process outside one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save(path: str, tree, metadata: dict | None = None):
    """Write ``tree`` (the port's flat params, or any tree holding them) to
    ``path`` (npz) and ``path + ".json"`` in the reference's layout,
    atomically.  In a ``torch.distributed`` world every rank calls it:
    rank 0 writes, then all meet at a barrier."""
    try:
        if is_writer():
            _write(path, tree, metadata)
    finally:
        if dist.is_initialized():
            dist.barrier()


def _write(path: str, tree, metadata: dict | None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(_nested(tree))
    dtypes = {k: str(t.dtype).removeprefix("torch.") for k, t in flat.items()}
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **{k: _array(t) for k, t in flat.items()})
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    meta = dict(metadata or {})
    meta["dtypes"] = dtypes
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=1)


def load(path: str, device="cuda") -> Tuple[Any, dict]:
    """Read a checkpoint written by either package; returns ``(tree,
    metadata)``: dicts as the port's flat ``{path: tensor}`` on ``device``
    (a params checkpoint loads as the port's params), sequences as
    tuples."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    for k, dt in meta.get("dtypes", {}).items():
        if k in flat and "bfloat16" in dt:
            flat[k] = torch.from_numpy(flat[k].view(np.int16)).view(
                torch.bfloat16)
    return _port(_unflatten(flat), resolve_device(device)), meta
