"""Mesh-axis utilities and the client axis's collectives.

Ports ``axis_size`` and ``resolve_client_axis`` of
``repro/sharding/spmd.py``.  The reference's ``shard_map`` has no
counterpart: the port runs one process a rank (``torch.distributed``), each
with its own block of the round's clients, and crosses ranks through the
two collectives here, :func:`all_gather` (a ``[n, ...]`` tensor into
``[n * S, ...]`` in rank order along the axis) and :func:`all_reduce_sum`,
both on the axis's process groups.

Each collective reports the bytes one rank moves by the ring model
(``accounting.ring_bytes``) to the active counters
(``repro_torch.accounting``).
On ``meta`` tensors (a dry-run plan, no process group) it returns the
collective's output shape and reports the same bytes; the mesh is then any
object with ``axis_names`` and ``shape`` (``launch.dryrun``'s plan mesh).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (named axes,
``launch/mesh.py`` makes them), or for the pure functions any object with
``axis_names`` and a ``shape`` mapping each name to its size, as a JAX
mesh has.  An axis is a name or a tuple of names; a tuple is the axes
flattened in order, the first one major, as ``PartitionSpec`` reads it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch import accounting


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names, in order."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}``."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(axis_names(mesh), shape))


def _flat(name) -> Tuple[str, ...]:
    return name if isinstance(name, tuple) else (name,)


def axis_size(mesh, name) -> int:
    """Total size of mesh axis ``name`` (None = 1, tuples multiply)."""
    if name is None:
        return 1
    shape = mesh_shape(mesh)
    n = 1
    for a in _flat(name):
        n *= shape[a]
    return n


def resolve_client_axis(mesh, spmd_axis=None):
    """The mesh axis carrying the per-client dim of a fed round.

    ``None`` derives it (``clients`` if the mesh has one, else ``data``,
    else the leading axis).  An explicit name (or tuple of names) must
    exist on the mesh, or ``ValueError`` says which do not.
    """
    names = axis_names(mesh)
    if spmd_axis is None:
        for cand in ("clients", "data"):
            if cand in names:
                return cand
        return names[0]
    flat = _flat(spmd_axis)
    missing = [a for a in flat if a not in names]
    if missing:
        raise ValueError(
            f"spmd_axis {spmd_axis!r} names mesh axes {missing} that the "
            f"mesh does not have (mesh axes: {names}); pass one of the "
            f"mesh's axis names or spmd_axis=None to derive it")
    return spmd_axis


def axis_index(mesh, name) -> int:
    """This rank's coordinate along axis ``name`` (a tuple: the flattened
    coordinate, its first axis major): the block of a dim split over the
    axis that the rank holds."""
    shape = mesh_shape(mesh)
    idx = 0
    for a in _flat(name):
        idx = idx * shape[a] + mesh.get_local_rank(a)
    return idx


def _report(kind, t, out_numel, group):
    if accounting.ACTIVE:
        nb = t.element_size()
        accounting.collective(kind, accounting.ring_bytes(
            kind, t.numel() * nb, out_numel * nb, group))


def all_gather(mesh, name, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (``[n, ...]``, the same shape on each) along axis
    ``name``, concatenated on dim 0 in the order of the ranks' coordinates
    (``[n * S, ...]``): pure data movement.  A tuple axis gathers over its
    last axis first, so the result is ordered first axis major."""
    shape = mesh_shape(mesh)
    for a in reversed(_flat(name)):
        n = shape[a]
        out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        _report("all-gather", t, out.numel(), n)
        if t.device.type != "meta":
            dist.all_gather(list(out.chunk(n)), t.contiguous(),
                            group=mesh.get_group(a))
        t = out
    return t


def all_reduce_sum(mesh, name, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over axis ``name``, in place; returns ``t``."""
    return _all_reduce(mesh, name, t, dist.ReduceOp.SUM)


def _all_reduce(mesh, name, t, op):
    shape = mesh_shape(mesh)
    for a in reversed(_flat(name)):
        _report("all-reduce", t, t.numel(), shape[a])
        if t.device.type != "meta":
            dist.all_reduce(t, op=op, group=mesh.get_group(a))
    return t


def all_reduce_max(mesh, name, t: torch.Tensor) -> torch.Tensor:
    """``t``'s elementwise maximum over axis ``name``, in place."""
    return _all_reduce(mesh, name, t, dist.ReduceOp.MAX)
