"""Where the port runs: on the card unless the caller asks for the CPU.

:func:`resolve_device` is the one place that sets up the card, and the
one place that owns the port's rule for bf16 products there: they sum in
float32 and round once, as the reference's (``preferred_element_type=
float32``).  PyTorch's default lets cuBLAS add a bf16 GEMM's split-K
partial sums in bf16 (``allow_bf16_reduced_precision_reduction``), so
picking the card turns that off; :func:`check_f32_sums` refuses a bf16
product on the card while it is on again."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is present (the port never carries on on the CPU by itself).
    ``"meta"`` is taken when the caller names it: shapes and dtypes only,
    the planning path's device (``launch/dryrun.py``), where each kernel
    wrapper takes its ``meta`` arm and declares its cost."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card by "
                "default -- pass device='cpu' to run the plain PyTorch "
                "versions of its kernels on the CPU")
        if dev.index is None:    # tensors report "cuda:N", never "cuda"
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"device must be 'cuda', 'cpu' or 'meta'; got "
                         f"{device!r}")
    return dev


def check_f32_sums(t: torch.Tensor):
    """Raise if a cuBLAS product of the bf16 CUDA tensor ``t`` may add its
    partial sums in bf16 (the flag set back on after
    :func:`resolve_device`)."""
    if (t.dtype == torch.bfloat16 and t.is_cuda and
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction):
        raise RuntimeError(
            "bf16 products on the card sum in float32 and round once: set "
            "torch.backends.cuda.matmul."
            "allow_bf16_reduced_precision_reduction = False (picking the "
            "card through the port's entry points does)")
