"""Three-term roofline for one H100, and the model's useful FLOPs.

Ports ``Roofline``, ``active_params`` and ``model_flops`` of
``repro/analysis/roofline.py`` at the rates of one NVIDIA H100 80GB HBM3
(SXM, 700 W), from NVIDIA's data sheet, instead of a TPU v5e's:

  PEAK_FLOPS["bfloat16"]  989 TFLOP/s   dense bf16 tensor cores
  PEAK_FLOPS["tf32x3"]    495/3 TFLOP/s the port's 3xTF32 kernels: three
                                        TF32 passes for each f32 product
  PEAK_FLOPS["float32"]   67 TFLOP/s    f32 outside the tensor cores
                                        (cuBLAS SIMT: TF32 stays off)
  HBM_BW                  3.35 TB/s
  ICI_BW                  450 GB/s      NVLink, one direction

The peak is a table keyed by rate class, so a :class:`Roofline` takes its
FLOPs per class (``{"float32": ..., "tf32x3": ...}``, as
``analysis.cost.Counter`` counts them) and ``t_compute`` is their sum, each
over its own rate.  The rest keeps the reference's names and ``row()``
keys.  ``model_flops`` is 6 * N_active * tokens for training and 2 *
N_active * tokens for serving; ``useful_ratio`` = model FLOPs / (FLOPs per
device x devices) shows what the round does beyond the model's own work.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

PEAK_FLOPS = {"bfloat16": 989e12, "tf32x3": 495e12 / 3, "float32": 67e12}
HBM_BW = 3.35e12            # B/s
ICI_BW = 450e9              # B/s, one direction of NVLink


def bound_ms(flops, nbytes, klass):
    """``(ms, "operations" | "bytes")``: the least time one card takes for
    ``flops`` at ``klass``'s rate and ``nbytes`` at HBM's, the larger of
    the two (the kernel table's bound)."""
    t_ops, t_bytes = flops / PEAK_FLOPS[klass], nbytes / HBM_BW
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


@dataclass
class Roofline:
    flops_by_class: Dict[str, float]
    bytes_per_dev: float
    coll_bytes_per_dev: float
    chips: int
    model_flops: float       # global useful flops

    @property
    def flops_per_dev(self):
        return float(sum(self.flops_by_class.values()))

    @property
    def t_compute(self):
        return sum(f / PEAK_FLOPS[k] for k, f in self.flops_by_class.items())

    @property
    def t_memory(self):
        return self.bytes_per_dev / HBM_BW

    @property
    def t_collective(self):
        return self.coll_bytes_per_dev / ICI_BW

    @property
    def bottleneck(self):
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self):
        return self.model_flops / max(self.flops_per_dev * self.chips, 1.0)

    @property
    def step_time_lower_bound(self):
        """With perfect overlap the max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def row(self):
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_lb_s": self.step_time_lower_bound,
            "model_flops": self.model_flops,
            "flops_per_dev": self.flops_per_dev,
            "flops_by_class": dict(self.flops_by_class),
            "bytes_per_dev": self.bytes_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "useful_ratio": self.useful_ratio,
        }


def active_params(cfg, abstract):
    """Active-per-token params over the port's flat ``{path: shape}``
    (``layers/3/moe/w_gate``): of a MoE layer's routed experts only
    ``top_k`` of ``n_experts`` count; shared experts count whole."""
    total = 0
    for path, shape in abstract.items():
        parts = path.split("/")
        n = math.prod(shape)
        if cfg.moe is not None and "moe" in parts and parts[-1] in (
                "w_gate", "w_up", "w_down") and "shared" not in parts:
            n = n * cfg.moe.top_k // cfg.moe.n_experts
        total += n
    return total


def model_flops(cfg, abstract, tokens, kind="train"):
    n = active_params(cfg, abstract)
    per_tok = 6 * n if kind == "train" else 2 * n
    return per_tok * tokens
