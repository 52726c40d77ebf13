"""Projection and norm helpers of the round.

Ports ``project_l2`` and ``global_norm`` of ``repro/core/submodel.py``.
"""
from __future__ import annotations

import torch


def global_norm(params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in params.values()))


def project_l2(params, radius):
    """P_W: projection onto the l2 ball of ``radius`` (0 = off), in place
    (scaling every leaf where it lies saves a copy of the model)."""
    if not radius:
        return params
    norm = global_norm(params)
    scale = torch.clamp(radius / torch.clamp_min(norm, 1e-12), max=1.0)
    for x in params.values():
        x.mul_(scale.to(x.dtype))
    return params
