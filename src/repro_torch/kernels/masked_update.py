"""The in-place update kernels of the round: the client SGD step, the
masked client SGD step and the server's fill-in average.

Ports ``sgd_2d``, ``masked_sgd_2d`` and ``fillin_agg_2d`` of
``repro/kernels/masked_update.py`` (reached through ``dispatch.sgd_step``,
``dispatch.masked_sgd`` and ``dispatch.fillin_agg``).  On CUDA tensors
:func:`sgd_`, :func:`masked_sgd_` and :func:`fillin_agg_` launch the
``csrc/sgd.cu`` and ``csrc/masked_update.cu`` kernels or raise; on CPU
tensors they run the plain versions in ``kernels.ref``.

Each takes float32 or bfloat16 operands, all of one dtype.  The bf16 arms
are the Pallas bodies on bf16 params: every operand in w's dtype (the
reference casts the mask, grad, client leaves and masks to it,
``kernels/ops.py:54-55, 69-70`` and ``dispatch.py:206``), the arithmetic
in float32 and one rounding to bf16 at the store.  A bf16 launch counts
under the kernel's name with ``/bf16`` appended.

On ``meta`` tensors (the planning path) each wrapper checks its operands
as on the card, returns its first argument and reports its launch's
:func:`cost` to the active counters (``repro_torch.accounting``); on the
card it reports the same cost beside the launch, while a counter is
active.
"""
from __future__ import annotations

import torch

from repro_torch import accounting
from repro_torch.kernels import _build, ref

#: the update kernels' names, by the ``kind`` of :func:`cost`
KERNELS = {"sgd": "sgd_inplace", "masked_sgd": "masked_sgd_inplace",
           "fillin": "fillin_agg_inplace"}


def cost(kind, n, dtype=torch.float32, clients=1):
    """``(flops, hbm_bytes, "float32")`` of one launch over ``n`` elements
    of the leaf: ``sgd`` reads p and g and writes p (2 FLOPs an element);
    ``masked_sgd`` also reads the mask (3); ``fillin`` reads the
    ``clients`` changes and masks and reads and writes the server param
    (3 C + 2).  The arithmetic is float32 in both arms; the bytes are the
    operands' dtype."""
    esize = dtype.itemsize
    flops, moved = {"sgd": (2, 3), "masked_sgd": (3, 4),
                    "fillin": (3 * clients + 2, 2 * clients + 2)}[kind]
    return flops * n, esize * moved * n, "float32"


def _declare(kind, w, clients=1):
    if accounting.ACTIVE:
        accounting.declare(
            KERNELS[kind] + ("/bf16" if w.dtype == torch.bfloat16 else ""),
            *cost(kind, w.numel(), w.dtype, clients), dot=False)


def _check_contiguous(what, *ts):
    if (str(ts[0].dtype) not in _build.ARMS
            or any(t.dtype != ts[0].dtype for t in ts)):
        raise TypeError(f"{what} takes float32 or bfloat16 tensors, all of "
                        f"one dtype; got {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} takes contiguous tensors")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{what}: operands on {[str(t.device) for t in ts]}")


def _overlaps(a, b):
    if a.device.type == "meta":        # no addresses: offsets in a storage
        if a.untyped_storage()._cdata != b.untyped_storage()._cdata:
            return False
        lo_a = a.storage_offset() * a.element_size()
        lo_b = b.storage_offset() * b.element_size()
    else:
        lo_a, lo_b = a.data_ptr(), b.data_ptr()
    return (lo_a < lo_b + b.numel() * b.element_size()
            and lo_b < lo_a + a.numel() * a.element_size())


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def sgd_(w: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """Update ``w`` in place (one read of w and g, one write of w: no new
    copy of the leaf); returns ``w``."""
    _check_contiguous("the SGD step", w, g)
    if w.shape != g.shape:
        raise ValueError(f"param {tuple(w.shape)} and grad {tuple(g.shape)} "
                         "disagree")
    if _overlaps(w, g):
        raise ValueError("the SGD step updates w in place; it must not share "
                         "memory with the grad")
    if w.device.type == "cpu":
        return ref.sgd_ref(w, g, lr)
    _declare("sgd", w)
    if w.device.type == "meta":
        return w
    _build.launch("sgd_inplace", "sgd_inplace", w.dtype, w.data_ptr(),
                  g.data_ptr(), float(lr), w.numel(), _stream(w))
    return w


def masked_sgd_(w: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
                lr: float) -> torch.Tensor:
    """``w <- w - (lr * m) * g`` in place (reads w, m and g once, writes w
    once); returns ``w``."""
    _check_contiguous("the masked SGD step", w, m, g)
    if not w.shape == m.shape == g.shape:
        raise ValueError(f"param {tuple(w.shape)}, mask {tuple(m.shape)} and "
                         f"grad {tuple(g.shape)} disagree")
    if _overlaps(w, m) or _overlaps(w, g):
        raise ValueError("the masked SGD step updates w in place; it must "
                         "not share memory with the mask or the grad")
    if w.device.type == "cpu":
        return ref.masked_sgd_ref(w, m, g, lr)
    _declare("masked_sgd", w)
    if w.device.type == "meta":
        return w
    _build.launch("masked_sgd_inplace", "masked_sgd_inplace", w.dtype,
                  w.data_ptr(), m.data_ptr(), g.data_ptr(), float(lr),
                  w.numel(), _stream(w))
    return w


def fillin_agg_(w: torch.Tensor, w_clients: torch.Tensor,
                m_clients: torch.Tensor, server_lr: float = 1.0
                ) -> torch.Tensor:
    """The server fill-in average in delta form, in place:
    ``w <- w + (server_lr / C) * sum_c m_c * (w_c - w)`` over the ``[C,
    *w.shape]`` client leaves and masks (reads each once, writes w once);
    returns ``w``.  ``server_lr / C`` is taken in double and rounded once
    to float32, as the reference's ``scale=float(scale)``."""
    _check_contiguous("the fill-in average", w, w_clients, m_clients)
    C = w_clients.shape[0] if w_clients.dim() else 0
    if C < 1 or w_clients.shape != (C, *w.shape) or \
            m_clients.shape != w_clients.shape:
        raise ValueError(f"server leaf {tuple(w.shape)}, client leaves "
                         f"{tuple(w_clients.shape)} and masks "
                         f"{tuple(m_clients.shape)}: expected [C, "
                         f"{', '.join(map(str, w.shape))}] for both")
    if _overlaps(w, w_clients) or _overlaps(w, m_clients):
        raise ValueError("the fill-in average updates the server leaf in "
                         "place; it must not share memory with the clients")
    scale = float(server_lr) / C
    if w.device.type == "cpu":
        return ref.fillin_agg_ref(w, w_clients, m_clients, scale)
    _declare("fillin", w, C)
    if w.device.type == "meta":
        return w
    _build.launch("fillin_agg_inplace", "fillin_agg_inplace", w.dtype,
                  w.data_ptr(), w_clients.data_ptr(),
                  m_clients.data_ptr(), scale, w.numel(), C, w.numel(),
                  _stream(w))
    return w
