"""The client SGD step, ``w <- w - lr * g`` in place.

Ports ``sgd_2d`` of ``repro/kernels/masked_update.py`` (reached through
``dispatch.sgd_step``).  On a CUDA tensor :func:`sgd_` launches the
``csrc/sgd.cu`` kernel or raises; on a CPU tensor it runs the plain version
in ``kernels.ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def sgd_(w: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """Update ``w`` in place (one read of w and g, one write of w: no new
    copy of the leaf); returns ``w``."""
    if w.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError("the SGD step takes float32 params and grads")
    if w.shape != g.shape or w.device != g.device:
        raise ValueError(f"param {tuple(w.shape)} on {w.device} and grad "
                         f"{tuple(g.shape)} on {g.device} disagree")
    if not (w.is_contiguous() and g.is_contiguous()):
        raise ValueError("the SGD step takes contiguous tensors")
    if w.device.type == "cpu":
        return ref.sgd_ref(w, g, lr)
    err = _build.library().sgd_inplace(
        w.data_ptr(), g.data_ptr(), float(lr), w.numel(),
        torch.cuda.current_stream(w.device).cuda_stream)
    _build.check_launch("sgd_inplace", err)
    return w
