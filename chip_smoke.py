#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check what comes out.

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:

1. Build the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
   print nvcc's ``-Xptxas -v`` report and the card.
2. Hold every kernel of the paths against its plain PyTorch version on
   the card, at the shapes the full-width TinyLlama-1.1B rounds and
   evaluation and the Mamba2-130M prefill give it (plus unaligned offsets,
   ragged lengths, sliding windows, other head groupings, short and
   ragged chunks and head windows): the product kernels' forward values
   and autograd gradients, the flash kernel's output, the SSD chunk
   kernel's outputs and chunk states (also against the sequential
   recurrence), and the three update kernels bit for bit; time each beside
   its plain version, one library call for the same function (where one
   exists) and its bound on an H100 (f32 FMAs; for the product kernels,
   rows 1-8, three TF32 tensor-core passes), with the block tile each
   timed product launch took, and two launches of each bit-equal.
3. Run two rounds of the reduced model on the card and on the CPU (the
   plain versions) from the same params, tokens and windows or masks
   (masks drawn on the CPU and copied), and hold the two against each
   other: the window round (checkpointed through ``checkpoint_callback``
   and loaded back bit for bit), a Bernoulli mask round and a structured
   rolling mask round at per-client capacities; one model's eval
   through the flash kernel against the same eval on the CPU; and reduced
   Mamba2 serving (prefill 2 x 64, 4 greedy steps) and its loss.
4. The window path: the shared-window federated round on full-width
   TinyLlama-1.1B (22 layers, f32, 4 clients x 2 local steps x 2 x 256
   tokens), through ``api.fed_round`` and ``api.Trainer``, 3 rounds, with
   every kernel's launch count read before and after.
4a. The eval path, on the server params those rounds leave: the held-out
   loss of one model (``Model.loss``, 4 x 2048 tokens) with
   ``REPRO_USE_FLASH`` set and without, the windowed sub-model's loss
   with the switch (the scalar-offset products and the flash kernel), and
   one backward pass of the windowed sub-model's loss at 2 x 256 tokens
   without it; launches counted per part, seconds and peak memory, the
   server's and the sub-model's flash evals and the backward pass under
   ``torch.profiler``.  Then one more window round under
   ``torch.profiler`` for the device time by kernel group, and two rounds
   of ``api.Trainer`` with ``eval_fn``, ``eval_every=1`` and
   ``log_every=1``.  The trainer and params are freed before the next
   phase.
4b. The mask path: the same configuration with ``scheme="bernoulli"``
   (Algorithm 1, mask mode chosen by ``api.fed_round`` itself) through
   ``api.Trainer(rng=0)``, 3 rounds, counted, checked and profiled the
   same way; then the peak memory of one client phase run with the model
   on ``w_c`` (what the round runs) and on the literal ``m * w_c``.
4c. Serving, after the mask path is freed: full-width Mamba2-130M (24
   layers, f32, random weights from seed 0) prefills 8 BigramLM prompts of
   32768 tokens and decodes 64 greedy tokens through ``serve.generate``
   (launches counted, peak from a reset, prefill and ms per token timed);
   teacher-forced decode of the last 256 tokens against one prefill of all
   of them, on the logits and every layer's state; its loss on 4 x 2048
   held-out tokens; one prefill under ``torch.profiler``.  Then
   full-width TinyLlama-1.1B prefills 4 x 1536 tokens and decodes 512
   greedy tokens, checked by teacher-forced decode against one prefill of
   all 2048.

The last lines are the ``{"kernels": [...]}`` record, the card's name and
power limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.  With no
card, or without the repository beside it, the script fails and prints no
result.
"""
import contextlib
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CKPT_DIR = ROOT / "build" / "chip_smoke"     # git-ignored; removed after use

# One H100 SXM (NVIDIA's data sheet): f32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# The product kernels (rows 1-8) keep f32 accuracy with the 3xTF32 split:
# three TF32 tensor-core passes (495 TFLOP/s dense, the same data sheet) for
# each f32 product, so 2*M*N*K runs at 495 / 3 TFLOP/s at best.
PEAK_TF32_FLOPS = 495e12
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
# kernel vs plain version: f32 both, different summation order; bounded
# relative to the output's largest magnitude
MM_RTOL = 1e-4
ROUND_TOL = 1e-4          # reduced round, card vs CPU (losses and params)
EVAL_RTOL = 1e-5          # full-width eval loss, flash vs blockwise
# full-width Mamba2, teacher-forced decode vs prefill: each layer's state h
# past layer 0.  One-token decode and 32k-token prefill round their
# products differently (other GEMM shapes); the differences grow through the
# residual stream with depth (8e-6 at layer 0 to 1.1e-4 at layer 21 of 24 on
# an H100 at 700 W), while layer 0's mixer on one input agrees within 1e-5
# (``layer_states_vs_recurrence``, held to MM_RTOL)
DEPTH_RTOL = 1e-3
HETERO = [1.0, 0.5, 0.25, 0.125]

C, M, D = 4, 512, 2048    # clients, tokens per client (2 x 256), d_model
EB, ES = 4, 2048          # eval batch: 4 sequences of TinyLlama's context
SRC = "src/repro_torch/kernels/csrc/"
TPU = "src/repro/kernels/"


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


@contextlib.contextmanager
def flash_switch(on):
    """``REPRO_USE_FLASH`` set (or unset) for the duration."""
    old = os.environ.pop("REPRO_USE_FLASH", None)
    if on:
        os.environ["REPRO_USE_FLASH"] = "1"
    try:
        yield
    finally:
        os.environ.pop("REPRO_USE_FLASH", None)
        if old is not None:
            os.environ["REPRO_USE_FLASH"] = old


def eval_loss(model, params, tokens, window=None, flash=False):
    """One model's held-out loss (``Model.loss`` under no_grad), a float."""
    with flash_switch(flash), torch.no_grad():
        return float(model.loss(params, {"tokens": tokens}, window=window)[0])


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, peak=PEAK_F32_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def err(a, b):
    d = (a - b).abs().max().item()
    return d, d / max(b.abs().max().item(), 1e-30)


def bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def scfg_for(scheme):
    """The main path's sub-model configuration, under ``scheme``."""
    from repro_torch.configs.base import SubmodelConfig
    return SubmodelConfig(scheme=scheme, capacity=0.5, local_steps=2,
                          clients_per_round=4, client_lr=0.1,
                          axes=("d_ff", "heads", "kv_heads"))


# -- phase 1 ------------------------------------------------------------------


def phase_build(_build):
    t0 = time.time()
    path, log = _build.build()
    _build.library()
    print(f"[build] {path.name} in {time.time() - t0:.1f} s")
    for line in log.splitlines():
        if ("ptxas info" in line or line.startswith("==")
                or "spill" in line):
            print(f"[build] {line.strip()}")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- phase 2 ------------------------------------------------------------------


# (kernel, TPU row, TPU function, T, N, win, offset, direction) at the main
# path's shapes: the q projection (heads window 16 of 32 at offset 16, i.e.
# 1024 of 2048 columns) and the gate/up pair (d_ff window 2816 of 5632);
# rows 5 and 6 also at the k/v projections' shape (kv_heads window 2 of 4,
# 128 of 256 columns), which takes 88 of a round's 132 launches of each
ROLLING = [
    ("rolling_mm_fwd<1>", 5, "rolling_matmul_batched.py:60", 1, 2048, 1024,
     1024, "fwd"),
    ("rolling_mm_dx<1>", 6, "rolling_matmul_batched.py:110", 1, 2048, 1024,
     1024, "dx"),
    ("rolling_mm_fwd<2>", 7, "rolling_matmul_batched.py:164", 2, 5632, 2816,
     2816, "fwd"),
    ("rolling_mm_dx<2>", 8, "rolling_matmul_batched.py:219", 2, 5632, 2816,
     2816, "dx"),
]
# further correctness cases (C, M, K, N, win, per-client offsets): the k/v
# projections, unaligned and per-client offsets, ragged shapes
EXTRA = [
    (C, M, D, 256, 128, [128] * C),
    (C, M, D, 256, 128, [0, 37, 128, 5]),
    (3, 300, 1000, 777, 333, [0, 17, 444]),
    (C, M, D, 5632, 2816, [1, 2815, 2816, 100]),
]


def phase_kernels(dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels.masked_update import sgd_
    from repro_torch.kernels.rolling_matmul import (make_offsets,
                                                    rolling_matmul_batched,
                                                    rolling_mm_dx,
                                                    rolling_mm_fwd)
    g = torch.Generator(dev).manual_seed(0)
    rows = []

    for (c, m, k, n, win, offs) in EXTRA:
        for T in (1, 2):
            x = torch.randn((c, m, k), device=dev, generator=g)
            ws = [torch.randn((c, k, n), device=dev, generator=g)
                  for _ in range(T)]
            dys = [torch.randn((c, m, win), device=dev, generator=g)
                   for _ in range(T)]
            o = make_offsets(offs, dev)
            for y, yr in zip(rolling_mm_fwd(x, ws, o, win),
                             ref.rolling_matmul_batched_ref(x, ws, offs,
                                                            win)):
                check(err(y, yr)[1] <= MM_RTOL,
                      f"fwd<{T}> {tuple(x.shape)} win {win} off {offs}: "
                      f"{err(y, yr)}")
            e = err(rolling_mm_dx(dys, ws, o, win),
                    ref.rolling_matmul_batched_dx_ref(dys, ws, offs, win))
            check(e[1] <= MM_RTOL, f"dx<{T}> {tuple(x.shape)} win {win} "
                  f"off {offs}: {e}")
    print(f"[kernels] {len(EXTRA) * 2 * 2} extra shape/offset checks "
          f"within {MM_RTOL} of max|plain|")

    for name, row, tpu_fn, T, N, win, off, kind in ROLLING:
        r = product_timing(dev, g, kind, T, C, M, N, win, off)
        rows.append(dict(name=name, route="cuda",
                         source=SRC + "rolling_mm.cu",
                         replaces=TPU + tpu_fn, tpu_row=row, **r))
        if row in (5, 6):      # the k/v projections: window 128 of 256
            rows[-1]["sub_rows"] = [product_timing(dev, g, kind, T, C, M,
                                                   256, 128, 128)]

    # autograd through the Function at the gate/up shape against plain
    # autograd on the window views
    T, N, win, off = 2, 5632, 2816, 2816
    x = torch.randn((C, M, D), device=dev, generator=g, requires_grad=True)
    ws = [torch.randn((C, D, N), device=dev, generator=g,
                      requires_grad=True) for _ in range(T)]
    dys = [torch.randn((C, M, win), device=dev, generator=g)
           for _ in range(T)]
    ys = rolling_matmul_batched(x, ws, make_offsets([off] * C, dev), win)
    got = torch.autograd.grad(ys, [x, *ws], dys)
    ys_ref = ref.rolling_matmul_batched_ref(x, ws, [off] * C, win)
    want = torch.autograd.grad(ys_ref, [x, *ws], dys)
    for name, a, b in zip(("dx", "dW_gate", "dW_up"), got, want):
        e = err(a, b)
        check(e[1] <= MM_RTOL, f"autograd {name}: {e}")
        print(f"[kernels] autograd {name} max abs err {e[0]:.3g} "
              f"(rel {e[1]:.3g})")
    del x, ws, dys, ys, got, ys_ref, want

    # the SGD step on the largest leaf, and on a ragged misaligned one
    n = C * D * 5632
    w = torch.randn(n, device=dev, generator=g)
    gr = torch.randn(n, device=dev, generator=g)
    for lo, size in ((0, n), (1, 1_000_003)):
        a = sgd_(w[lo:lo + size].clone(), gr[lo:lo + size], 0.1)
        b = ref.sgd_ref(w[lo:lo + size].clone(), gr[lo:lo + size], 0.1)
        check(torch.equal(a, b), f"sgd_inplace not bit-exact at {lo}+{size}")
    b_ms, b_by = bound(2 * n, 12 * n)
    k_ms = cuda_ms(lambda: sgd_(w, gr, 1e-6))
    rows.append(dict(
        name="sgd_inplace", route="cuda", source=SRC + "sgd.cu",
        replaces=TPU + "masked_update.py:53", tpu_row=10,
        shape={"w": [C, D, 5632]}, max_abs_err=0.0, max_rel_err=0.0,
        tolerance=0.0, ms=k_ms, kernel_ms=k_ms,
        plain_ms=cuda_ms(lambda: ref.sgd_ref(w, gr, 1e-6)),
        library_ms=cuda_ms(lambda: w.add_(gr, alpha=-1e-6)),
        library_calls=1, bound_ms=b_ms, bound_by=b_by))
    del w, gr
    rows += mask_kernels(dev, g)
    rows += scalar_kernels(dev, g)
    rows += flash_kernels(dev, g)
    rows += ssd_kernels(dev, g)
    for r in rows:
        for sub in [r, *r.get("sub_rows", [])]:
            lib = ("none" if sub["library_ms"] is None
                   else f"{sub['library_ms']:.4f} ms")
            tile = ("" if "block_tile" not in sub else
                    " tile {}x{}".format(*sub["block_tile"]))
            print(f"[kernels] {r['name']:23s} {json.dumps(sub['shape'])} "
                  f"err {sub['max_abs_err']:.3g} kernel {sub['ms']:.4f} ms"
                  f"  plain {sub['plain_ms']:.4f} ms  library {lib}  bound "
                  f"{sub['bound_ms']:.4f} ms ({sub['bound_by']}){tile}")
    return rows


def product_timing(dev, g, kind, T, c, m, N, win, off, scalar_name=None):
    """One product kernel ("fwd" or "dx", T weights) at one shape: ``c``
    clients of ``m`` tokens, x [c, m, D], W [c, D, N], window ``win`` at
    ``off``.  Held against its plain version within MM_RTOL, then timed
    beside it, beside the library (``bmm``/``baddbmm`` on the window views;
    ``mm``/``addmm`` for one model, ``scalar_name`` given, which also names
    the launches) and beside its bound at the 3xTF32 rate; a second launch
    must equal the first bit for bit.  Returns the kernel table's numbers
    and the block tile the launch took."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rolling_matmul import (block_tile, make_offsets,
                                                    rolling_mm_dx,
                                                    rolling_mm_fwd)
    x = torch.randn((c, m, D), device=dev, generator=g)
    ws = [torch.randn((c, D, N), device=dev, generator=g) for _ in range(T)]
    dys = [torch.randn((c, m, win), device=dev, generator=g)
           for _ in range(T)]
    offs = [off] * c
    o = make_offsets(offs, dev)     # the device copy a model keeps
    views = [w[:, :, off:off + win] for w in ws]
    flops = 2 * c * T * m * D * win
    lead = [] if scalar_name else [c]
    if kind == "fwd":
        kern = lambda: rolling_mm_fwd(x, ws, o, win, name=scalar_name)  # noqa
        plain = lambda: ref.rolling_matmul_batched_ref(x, ws, offs,  # noqa
                                                       win)
        if scalar_name:
            lib = lambda: [torch.mm(x[0], v[0]) for v in views]  # noqa
        else:
            lib = lambda: [torch.bmm(x, v) for v in views]       # noqa
        out = kern()
        e = max((err(a, b) for a, b in zip(out, plain())),
                key=lambda t: t[1])
        nbytes = 4 * (c * m * D + T * c * D * win + T * c * m * win)
        shape = {"x": lead + [m, D], "W": [T] + lead + [D, N], "win": win}
    else:
        kern = lambda: rolling_mm_dx(dys, ws, o, win, name=scalar_name)  # noqa
        plain = lambda: ref.rolling_matmul_batched_dx_ref(  # noqa
            dys, ws, offs, win)

        def lib():
            if scalar_name:
                acc = torch.mm(dys[0][0], views[0][0].mT)
                for d, v in zip(dys[1:], views[1:]):
                    acc = torch.addmm(acc, d[0], v[0].mT)
                return acc
            acc = torch.bmm(dys[0], views[0].mT)
            for d, v in zip(dys[1:], views[1:]):
                acc = torch.baddbmm(acc, d, v.mT)
            return acc
        out = [kern()]
        e = err(out[0], plain())
        nbytes = 4 * (T * c * m * win + T * c * D * win + c * m * D)
        shape = {"dy": [T] + lead + [m, win], "W": [T] + lead + [D, N],
                 "win": win}
    check(e[1] <= MM_RTOL, f"{kind}<{T}> at {shape}: {e}")
    again = kern()
    check(all(bits_equal(a, b) for a, b in zip(
        out, again if kind == "fwd" else [again])),
          f"{kind}<{T}> at {shape}: two launches differ")
    b_ms, b_by = bound(flops, nbytes, PEAK_3XTF32_FLOPS)
    k_ms = cuda_ms(kern)
    return dict(
        shape=shape, block_tile=list(block_tile(kind, T, c, m, D, win)),
        max_abs_err=e[0], max_rel_err=e[1], tolerance=MM_RTOL, ms=k_ms,
        kernel_ms=k_ms, plain_ms=cuda_ms(plain), library_ms=cuda_ms(lib),
        library_calls=T, bound_ms=b_ms, bound_by=b_by,
        bound_rate="3xTF32: 2*M*N*K at 495/3 TFLOP/s")


def mask_kernels(dev, g):
    """The mask path's update kernels, bit for bit against their plain
    versions: the masked step on the ``w_gate`` client leaf [4, 2048, 5632]
    and on a ragged misaligned slice; the fill-in on the ``w_gate`` server
    leaf [2048, 5632] for C in {3, 4} and server_lr in {1, 0.5}, and on a
    ragged misaligned leaf."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.masked_update import fillin_agg_, masked_sgd_
    rows = []
    n = C * D * 5632
    w = torch.randn(n, device=dev, generator=g)
    m = (torch.rand(n, device=dev, generator=g) < 0.5).float()
    gr = torch.randn(n, device=dev, generator=g)
    for lo, size in ((0, n), (1, 1_000_003)):
        sl = slice(lo, lo + size)
        a = masked_sgd_(w[sl].clone(), m[sl], gr[sl], 0.1)
        b = ref.masked_sgd_ref(w[sl].clone(), m[sl], gr[sl], 0.1)
        check(bits_equal(a, b),
              f"masked_sgd_inplace not bit-exact at {lo}+{size}")
    b_ms, b_by = bound(3 * n, 16 * n)
    k_ms = cuda_ms(lambda: masked_sgd_(w, m, gr, 1e-6))
    rows.append(dict(
        name="masked_sgd_inplace", route="cuda",
        source=SRC + "masked_update.cu", replaces=TPU + "masked_update.py:33",
        tpu_row=9, shape={"w": [C, D, 5632]}, max_abs_err=0.0,
        max_rel_err=0.0, tolerance=0.0, ms=k_ms, kernel_ms=k_ms,
        plain_ms=cuda_ms(lambda: ref.masked_sgd_ref(w, m, gr, 1e-6)),
        library_ms=cuda_ms(lambda: w.addcmul_(m, gr, value=-1e-6)),
        library_calls=1, bound_ms=b_ms, bound_by=b_by))
    del w, m, gr

    ns = D * 5632
    w = torch.randn(ns, device=dev, generator=g)
    for c in (3, 4):
        wc = torch.randn((c, ns), device=dev, generator=g)
        mc = (torch.rand((c, ns), device=dev, generator=g) < 0.5).float()
        for slr in (1.0, 0.5):
            for lo, size in ((0, ns), (1, 1_000_003)):
                sl = slice(lo, lo + size)
                cw = wc[:, :size].contiguous()
                cm = mc[:, :size].contiguous()
                a = fillin_agg_(w[sl].clone(), cw, cm, slr)
                b = ref.fillin_agg_ref(w[sl].clone(), cw, cm, slr / c)
                check(bits_equal(a, b), f"fillin_agg_inplace not bit-exact "
                      f"at C={c} server_lr={slr} {lo}+{size}")
    print("[kernels] update kernels bit-exact to their plain versions "
          "(aligned, ragged and misaligned; fill-in C in {3, 4}, server_lr "
          "in {1, 0.5})")
    b_ms, b_by = bound((3 * C + 2) * ns, (8 + 8 * C) * ns)
    k_ms = cuda_ms(lambda: fillin_agg_(w, wc, mc, 1.0))
    rows.append(dict(
        name="fillin_agg_inplace", route="cuda",
        source=SRC + "masked_update.cu", replaces=TPU + "masked_update.py:79",
        tpu_row=11, shape={"w": [D, 5632], "w_c": [C, D, 5632]},
        max_abs_err=0.0, max_rel_err=0.0, tolerance=0.0, ms=k_ms,
        kernel_ms=k_ms,
        plain_ms=cuda_ms(lambda: ref.fillin_agg_ref(w, wc, mc, 1.0 / C)),
        library_ms=None, library_calls=0, bound_ms=b_ms, bound_by=b_by))
    return rows


# the scalar-offset (one model) products at the eval path's shapes: rows 1-2
# on the windowed sub-model's eval (4 x 2048 tokens), rows 3-4 on its
# gradient (2 x 256 tokens); the q projection (window 1024 of 2048 columns)
# and the gate/up pair (window 2816 of 5632)
# (kernel, TPU row, TPU function, T, M, N, win, offset, direction)
SCALAR = [
    ("rolling_matmul", 1, "rolling_matmul.py:44", 1, EB * ES, 2048, 1024,
     1024, "fwd"),
    ("rolling_matmul_multi", 2, "rolling_matmul.py:95", 2, EB * ES, 5632,
     2816, 2816, "fwd"),
    ("rolling_matmul_dx", 3, "rolling_matmul_bwd.py:50", 1, M, 2048, 1024,
     1024, "dx"),
    ("rolling_matmul_dx_multi", 4, "rolling_matmul_bwd.py:104", 2, M, 5632,
     2816, 2816, "dx"),
]


def scalar_kernels(dev, g):
    """TPU rows 1-4: C = 1 launches of the product kernels, counted under
    the scalar-offset names as one model's window counts them, against
    their plain versions (a product on the window view), at ragged shapes
    and misaligned offsets, then timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rolling_matmul import (SCALAR_NAMES,
                                                    make_offsets,
                                                    rolling_mm_dx,
                                                    rolling_mm_fwd)

    def rolling_matmul_fwd(x, ws, o, win):
        return [y[0] for y in rolling_mm_fwd(
            x[None], [w[None] for w in ws], o, win,
            name=SCALAR_NAMES[len(ws)][0])]

    def rolling_matmul_dx(dys, ws, o, win):
        return rolling_mm_dx([d[None] for d in dys], [w[None] for w in ws],
                             o, win, name=SCALAR_NAMES[len(ws)][1])[0]

    def plain_fwd(x, ws, off, win):
        return ref.rolling_matmul_batched_ref(x[None], [w[None] for w in ws],
                                              [off], win)

    def plain_dx(dys, ws, off, win):
        return ref.rolling_matmul_batched_dx_ref(
            [d[None] for d in dys], [w[None] for w in ws], [off], win)

    for (m, k, n, win, off) in ((300, 1000, 777, 333, 17),
                                (M, D, 5632, 2816, 1)):
        for T in (1, 2):
            x = torch.randn((m, k), device=dev, generator=g)
            ws = [torch.randn((k, n), device=dev, generator=g)
                  for _ in range(T)]
            dys = [torch.randn((m, win), device=dev, generator=g)
                   for _ in range(T)]
            o = make_offsets([off], dev)
            for y, yr in zip(rolling_matmul_fwd(x, ws, o, win),
                             plain_fwd(x, ws, off, win)):
                check(err(y, yr[0])[1] <= MM_RTOL,
                      f"scalar fwd<{T}> {(m, k, n, win, off)}: "
                      f"{err(y, yr[0])}")
            e = err(rolling_matmul_dx(dys, ws, o, win),
                    plain_dx(dys, ws, off, win)[0])
            check(e[1] <= MM_RTOL, f"scalar dx<{T}> {(m, k, n, win, off)}: "
                  f"{e}")
    print("[kernels] scalar-offset products: 8 ragged / misaligned checks "
          f"within {MM_RTOL} of max|plain|")

    rows = []
    for name, row, tpu_fn, T, m, N, win, off, kind in SCALAR:
        r = product_timing(dev, g, kind, T, 1, m, N, win, off,
                           scalar_name=name)
        rows.append(dict(name=name, route="cuda",
                         source=SRC + "rolling_mm.cu",
                         replaces=TPU + tpu_fn, tpu_row=row, **r))
    return rows


# flash attention cases (tag, B, S, H, KV, window); the first is the eval
# shape, timed
FLASH = [
    ("eval shape", EB, ES, 32, 4, 0),
    ("sliding window 512", EB, ES, 32, 4, 512),
    ("ragged S 1000", 2, 1000, 32, 4, 0),
    ("G = 1", 2, ES, 8, 8, 0),
    ("windowed sub-model 16/2 heads", EB, ES, 16, 2, 0),
]


def visible_pairs(S, window):
    """(query, key) pairs a causal (sliding-window) attention visits."""
    n = np.arange(1, S + 1)
    return int((np.minimum(n, window) if window else n).sum())


def flash_kernels(dev, g):
    """TPU row 13: the flash kernel against its plain version (the Pallas
    body transcribed) at each case, timed at the eval shape beside one
    f32 ``scaled_dot_product_attention`` (timed only; the port never calls
    it)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    hd, row = 64, None
    for tag, B, S, H, KV, win in FLASH:
        q = torch.randn((B, S, H, hd), device=dev, generator=g)
        k = torch.randn((B, S, KV, hd), device=dev, generator=g)
        v = torch.randn((B, S, KV, hd), device=dev, generator=g)
        kern = lambda: flash_attention(q, k, v, window=win)              # noqa
        plain = lambda: ref.flash_attention_ref(q, k, v, window=win)     # noqa
        e = err(kern(), plain())
        check(e[1] <= MM_RTOL, f"flash {tag} {(B, S, H, KV, win)}: {e}")
        print(f"[kernels] flash {tag:30s} q {[B, S, H, hd]} kv heads {KV} "
              f"window {win}: max abs err {e[0]:.3g} (rel {e[1]:.3g})")
        if row is not None:
            continue
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
            qt, kt, vt, is_causal=True, enable_gqa=True)
        flops = 4 * B * H * hd * visible_pairs(S, win)
        nbytes = 4 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
        b_ms, b_by = bound(flops, nbytes)
        k_ms = cuda_ms(kern)
        row = dict(
            name="flash_attention", route="cuda",
            source=SRC + "flash_attn.cu",
            replaces=TPU + "flash_attention.py:88", tpu_row=13,
            shape={"q": [B, S, H, hd], "kv": [B, S, KV, hd], "causal": True,
                   "window": win},
            max_abs_err=e[0], max_rel_err=e[1], tolerance=MM_RTOL,
            ms=k_ms, kernel_ms=k_ms, plain_ms=cuda_ms(plain, iters=5),
            library_ms=cuda_ms(lib), library_calls=1,
            bound_ms=b_ms, bound_by=b_by)
    return [row]


# the SSD chunk block's cases (tag, Bt, nc, Q, nh, hd, N, head_offset,
# head_win); the first is one layer of the Mamba2-130M prefill (8 x 32768
# tokens, chunk 256), timed
SSD = [
    ("Mamba2 prefill layer", 8, 128, 256, 24, 64, 128, None, 0),
    ("hymba's shape", 2, 4, 128, 50, 64, 16, None, 0),
    ("reduced shape", 2, 4, 32, 16, 32, 16, None, 0),
    ("Q = 15", 2, 2, 15, 16, 32, 16, None, 0),
    ("Q = 100", 2, 2, 100, 24, 64, 128, None, 0),
    ("head window (5, 7)", 2, 4, 256, 24, 64, 128, 5, 7),
    ("head window (0, 24)", 2, 4, 256, 24, 64, 128, 0, 24),
    ("head window (16, 8)", 2, 4, 256, 24, 64, 128, 16, 8),
]


def ssd_inputs(dev, g, Bt, nc, Q, nh, hd, N):
    """x, dt, A, B, C as the model makes them: dt a softplus, A negative."""
    F = torch.nn.functional
    return (0.5 * torch.randn((Bt, nc, Q, nh, hd), device=dev, generator=g),
            F.softplus(torch.randn((Bt, nc, Q, nh), device=dev, generator=g)),
            -torch.exp(0.3 * torch.randn((nh,), device=dev, generator=g)),
            0.5 * torch.randn((Bt, nc, Q, N), device=dev, generator=g),
            0.5 * torch.randn((Bt, nc, Q, N), device=dev, generator=g))


def ssd_flops_bytes(Bt, nc, Q, nh, hd, N):
    """What one call's data needs: C B^T once per chunk over the causal
    pairs (ngroups = 1: it does not depend on the head), M x per head over
    the same pairs, and the state per head, at 2 flops a multiply-add; each
    input read once and each output written once."""
    pairs = Q * (Q + 1) // 2
    flops = Bt * nc * (2 * pairs * N + nh * (2 * pairs * hd + 2 * Q * hd * N))
    nbytes = 4 * (2 * Bt * nc * Q * nh * hd + Bt * nc * Q * nh + nh
                  + 2 * Bt * nc * Q * N + Bt * nc * nh * hd * N)
    return flops, nbytes


def ssd_kernels(dev, g):
    """TPU row 12: the SSD chunk kernel against its plain version (the
    Pallas body transcribed) at each case, y and states within MM_RTOL of
    their largest magnitude, and against the sequential oracle on a few
    chunks; timed at one Mamba2 prefill layer (no single PyTorch call
    computes the block, so there is no library time)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk_intra
    row = None
    for tag, Bt, nc, Q, nh, hd, N, off, win in SSD:
        args = ssd_inputs(dev, g, Bt, nc, Q, nh, hd, N)
        x, dt, A, B, C = args
        hs = slice(off or 0, (off or 0) + (win or nh))
        kern = lambda: ssd_chunk_intra(*args, head_offset=off,   # noqa: E731
                                       head_win=win)
        plain = lambda: ref.ssd_chunk_intra_ref(  # noqa: E731
            x[..., hs, :], dt[..., hs], A[hs], B, C)
        (y, s), (yr, sr) = kern(), plain()
        e = max(err(y, yr), err(s, sr), key=lambda t: t[1])
        check(y.shape == yr.shape and s.shape == sr.shape and e[1] <= MM_RTOL,
              f"ssd_chunk_intra {tag}: shapes {tuple(y.shape)} "
              f"{tuple(s.shape)}, error {e}")
        print(f"[kernels] ssd {tag:22s} x {[Bt, nc, Q, nh, hd]} N {N} heads "
              f"[{hs.start}, {hs.stop}): max abs err {e[0]:.3g} (rel "
              f"{e[1]:.3g})")
        if row is None:
            flops, nbytes = ssd_flops_bytes(Bt, nc, Q, nh, hd, N)
            b_ms, b_by = bound(flops, nbytes)
            del y, s, yr, sr
            k_ms = cuda_ms(kern)
            row = dict(
                name="ssd_chunk_intra", route="cuda",
                source=SRC + "ssd_chunk.cu",
                replaces=TPU + "ssd_chunk.py:58", tpu_row=12,
                shape={"x": [Bt, nc, Q, nh, hd], "B": [Bt, nc, Q, N]},
                max_abs_err=e[0], max_rel_err=e[1], tolerance=MM_RTOL,
                ms=k_ms, kernel_ms=k_ms, plain_ms=cuda_ms(plain, iters=3,
                                                          warmup=1),
                library_ms=None, library_calls=0, bound_ms=b_ms,
                bound_by=b_by)
        del args, x, dt, A, B, C
    # chunk by chunk against the recurrence from a zero state
    x, dt, A, B, C = ssd_inputs(dev, g, 1, 3, 64, 4, 32, 16)
    y, s = ssd_chunk_intra(x, dt, A, B, C)
    for c in range(3):
        yo, so = ref.ssd_chunk_ref(x[0, c], dt[0, c], A, B[0, c], C[0, c])
        e = max(err(y[0, c], yo), err(s[0, c], so), key=lambda t: t[1])
        check(e[1] <= MM_RTOL, f"ssd_chunk_intra vs the recurrence: {e}")
    print(f"[kernels] ssd against the sequential oracle on 3 chunks of 64: "
          f"within {MM_RTOL} of max|oracle|")
    return [row]


# -- phase 3 ------------------------------------------------------------------


def phase_small_agreement(dev):
    """Two reduced window rounds on the card against the same rounds on
    the CPU."""
    from repro_torch import api
    from repro_torch.checkpoint.checkpoint import load
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    cfg = get_reduced_config("tinyllama_1_1b")
    model = build_model(cfg)
    scfg = scfg_for("rolling")
    p_cpu = model.init(0, device="cpu")
    p_gpu = {k: v.to(dev, copy=True) for k, v in p_cpu.items()}
    batches = lm_batches(cfg.vocab, (2, 4, 2), 64, seed=0)
    batch = next(batches)
    ckpt = CKPT_DIR / "reduced.npz"
    outs = {}
    for where, params in (("cpu", p_cpu), ("card", p_gpu)):
        fed = api.fed_round(model, scfg, device=params["embed"].device)
        cbs = [api.checkpoint_callback(str(ckpt))] if where == "card" else []
        trainer = api.Trainer(fed, params, callbacks=cbs)
        trainer.run(iter([batch, batch]), 2)
        outs[where] = (trainer.history, trainer.params)
    (h_c, p_c), (h_g, p_g) = outs["cpu"], outs["card"]
    dl = max((a["client_loss"].cpu() - b["client_loss"]).abs().max().item()
             for a, b in zip(h_g, h_c))
    dp = max((p_g[k].cpu() - p_c[k]).abs().max().item() for k in p_c)
    check(dl <= ROUND_TOL and dp <= ROUND_TOL,
          f"reduced round on the card disagrees with the CPU: loss {dl}, "
          f"params {dp}")
    print(f"[agree] reduced 2-round card vs CPU: max |d loss| {dl:.3g}, "
          f"max |d param| {dp:.3g} (tolerance {ROUND_TOL})")

    loaded, meta = load(str(ckpt), device=dev)
    same = set(loaded) == set(p_g) and all(
        bits_equal(loaded[k], p_g[k]) for k in p_g)
    check(same and meta["round"] == 2 and len(meta["history"]) == 2,
          f"checkpoint round trip: bit-exact {same}, metadata {meta}")
    print(f"[agree] checkpoint_callback -> load: {len(p_g)} leaves bit-exact "
          f"on the card, metadata round {meta['round']}")

    # one model's eval through the flash kernel, card vs CPU (plain)
    tokens = torch.as_tensor(next(lm_batches(cfg.vocab, (4,), 128, seed=999))
                             ["tokens"], dtype=torch.long)
    window = {("d_ff", cfg.d_ff): (37, cfg.d_ff // 2),
              ("kv_heads", cfg.n_kv_heads): (1, cfg.n_kv_heads // 2),
              ("heads", cfg.n_heads): (2, cfg.n_heads // 2)}
    for tag, win in (("server", None), ("window", window)):
        got, want = (eval_loss(model, p, tokens.to(p["embed"].device), win,
                               flash=True)
                     for p in (p_g, p_c))
        d = abs(got - want)
        check(d <= ROUND_TOL, f"reduced flash eval ({tag}) card {got} vs "
              f"CPU {want}")
        print(f"[agree] reduced flash eval ({tag}) card {got:.6f} vs CPU "
              f"{want:.6f}: |d| {d:.3g} (tolerance {ROUND_TOL})")


def phase_small_agreement_mask(dev):
    """Two reduced mask rounds on the card against the same rounds on the
    CPU, with the masks drawn on the CPU and copied: Bernoulli masks, and
    structured rolling masks at per-client capacities."""
    from repro_torch import api
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.core.fedavg import dense_client_masks
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    cfg = get_reduced_config("tinyllama_1_1b")
    model = build_model(cfg)
    cpu = torch.device("cpu")
    batch = next(lm_batches(cfg.vocab, (2, 4, 2), 64, seed=0))
    for scheme, caps in (("bernoulli", [0.5] * 4), ("rolling", HETERO)):
        scfg = scfg_for(scheme)
        masks = [dense_client_masks(torch.Generator().manual_seed(r),
                                    model.abstract_params(), model.axes(),
                                    scfg, caps, r, cpu) for r in range(2)]
        p_cpu = model.init(0, device="cpu")
        p_gpu = {k: v.to(dev, copy=True) for k, v in p_cpu.items()}
        outs = {}
        for where, params in (("cpu", p_cpu), ("card", p_gpu)):
            fed = api.fed_round(model, scfg, mode="mask", capacities=caps,
                                device=params["embed"].device)
            trainer = api.Trainer(fed, params)
            trainer.run(((batch, {"masks": m}) for m in masks), 2)
            outs[where] = (trainer.history, trainer.params)
        (h_c, p_c), (h_g, p_g) = outs["cpu"], outs["card"]
        dl = max((a["client_loss"].cpu() - b["client_loss"]).abs().max()
                 .item() for a, b in zip(h_g, h_c))
        dp = max((p_g[k].cpu() - p_c[k]).abs().max().item() for k in p_c)
        check(dl <= ROUND_TOL and dp <= ROUND_TOL,
              f"reduced {scheme} mask round on the card disagrees with the "
              f"CPU: loss {dl}, params {dp}")
        print(f"[agree] reduced 2-round {scheme} mask round (capacities "
              f"{caps}) card vs CPU: max |d loss| {dl:.3g}, max |d param| "
              f"{dp:.3g} (tolerance {ROUND_TOL})")


def phase_small_agreement_ssm(dev):
    """Reduced Mamba2 serving on the card against the CPU from the same
    params: prefill 2 x 64 tokens and 4 greedy decode steps
    (``serve.generate``), logits within ROUND_TOL of their largest
    magnitude at every step and the same tokens; and one model's loss."""
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.specs import sample_prompts
    from repro_torch.models import build_model
    cfg = get_reduced_config("mamba2_130m")
    model = build_model(cfg)
    p_cpu = model.init(0, device="cpu")
    p_gpu = {k: v.to(dev, copy=True) for k, v in p_cpu.items()}
    prompts = torch.as_tensor(sample_prompts(cfg, 2, 64, seed=0)[0],
                              dtype=torch.long)
    got = generate(model, p_gpu, prompts.to(dev), 4, return_logits=True)
    want = generate(model, p_cpu, prompts, 4, return_logits=True)
    e = max((err(a.cpu(), b) for a, b in zip(got["logits"], want["logits"])),
            key=lambda t: t[1])
    same = torch.equal(got["tokens"].cpu(), want["tokens"])
    check(e[1] <= ROUND_TOL and same, f"reduced Mamba2 serving card vs CPU: "
          f"logits {e}, tokens equal {same}")
    print(f"[agree] reduced Mamba2 prefill 2x64 + 4 greedy steps card vs "
          f"CPU: logits max abs diff {e[0]:.3g} (rel {e[1]:.3g}, tolerance "
          f"{ROUND_TOL}), tokens equal")
    toks = prompts[:, :64]
    losses = [eval_loss(model, p, toks.to(p["embed"].device))
              for p in (p_gpu, p_cpu)]
    d = abs(losses[0] - losses[1])
    check(d <= ROUND_TOL, f"reduced Mamba2 loss card {losses[0]} vs CPU "
          f"{losses[1]}")
    print(f"[agree] reduced Mamba2 loss card {losses[0]:.6f} vs CPU "
          f"{losses[1]:.6f}: |d| {d:.3g} (tolerance {ROUND_TOL})")


# -- phase 4 ------------------------------------------------------------------


def run_rounds(tag, trainer, data, _build):
    """``len(data)`` rounds, each timed to a synchronize, with the kernel
    launches counted from 0 and the peak memory from a reset; checks what
    comes out and returns ``(launches, seconds per round after the
    first)``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    secs = []
    for item in data:
        t0 = time.perf_counter()
        trainer.run(iter([item]), 1)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses = trainer.losses
    client = [h["client_loss"].cpu().tolist() for h in trainer.history]
    print(f"[{tag}] round losses {losses}")
    print(f"[{tag}] client losses [K, C] per round {client}")
    print(f"[{tag}] seconds per round {secs}; after the first "
          f"{float(np.mean(secs[1:])):.3f} s")
    print(f"[{tag}] peak memory allocated {peak / 2**30:.2f} GiB")
    print(f"[{tag}] kernel launches {launches}")
    check(all(math.isfinite(v) for v in losses), f"{tag} losses {losses}")
    check(all(h["client_loss"].shape == (2, 4) for h in trainer.history),
          f"{tag} client_loss is not [K=2, C=4]")
    bad = [k for k, v in trainer.params.items()
           if not torch.isfinite(v).all()]
    check(not bad, f"{tag} non-finite params {bad[:5]}")
    return launches, float(np.mean(secs[1:]))


def full_width(dev):
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    cfg = get_config("tinyllama_1_1b")
    batches = lm_batches(cfg.vocab, (2, 4, 2), seq=256)
    return cfg, build_model(cfg), [next(batches) for _ in range(3)]


def phase_main_path(dev, _build):
    from repro_torch import api
    cfg, model, data = full_width(dev)
    params = model.init(seed=0, device=dev)
    fed = api.fed_round(model, scfg_for("rolling"), device=dev)
    trainer = api.Trainer(fed, params)
    n_params = sum(v.numel() for v in params.values())
    windows = {f"{k[0]}/{k[1]}": w for k, w in fed.scheme.sizes.items()}
    print(f"[main] {cfg.name}: {cfg.n_layers} layers, {n_params:,} params, "
          f"f32; windows {windows}")
    launches, round_s = run_rounds("main", trainer, data, _build)
    return launches, trainer, data[0], round_s


def phase_eval(dev, trainer, _build):
    """The eval path on the server params the window path's rounds left:
    four parts, each driven once with the launch counts set to 0 just
    before and read just after (the first run is also the warm-up), then
    timed 3 times to a synchronize, with the peak memory from a reset.
    Returns the launches of the whole path, summed over its parts."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    cfg = get_config("tinyllama_1_1b")
    model = build_model(cfg)
    params, fed = trainer.params, trainer.fed
    tokens = torch.as_tensor(next(lm_batches(cfg.vocab, (EB,), ES, seed=999))
                             ["tokens"], dtype=torch.long).to(dev)
    # the window of the last round trained: a sub-model a client trained
    offs = fed.scheme.offsets(trainer.round_idx - 1,
                              fed.scfg.clients_per_round)
    window = {k: (offs[k][0], w) for k, w in fed.scheme.sizes.items()
              if w < k[1]}
    small = tokens[:2, :256]
    print(f"[eval] {cfg.name} server params after {trainer.round_idx} "
          f"window rounds; held-out batch {list(tokens.shape)} (seed 999); "
          f"sub-model window {window}")

    def grad_pass():
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        with flash_switch(False):
            loss, _ = model.loss(p, {"tokens": small}, window=window)
            grads = torch.autograd.grad(loss, list(p.values()))
        g = dict(zip(p, grads))["layers/0/mlp/w_gate"]
        o, w = window[("d_ff", cfg.d_ff)]
        outside = (torch.count_nonzero(g[:, :o])
                   + torch.count_nonzero(g[:, o + w:])).item()
        finite = all(bool(torch.isfinite(t).all()) for t in grads)
        return float(loss.detach()), outside, finite

    parts = [
        ("server, flash", lambda: eval_loss(model, params, tokens,
                                            flash=True)),
        ("server, blockwise", lambda: eval_loss(model, params, tokens)),
        ("sub-model, flash", lambda: eval_loss(model, params, tokens,
                                               window, flash=True)),
        ("sub-model, blockwise", lambda: eval_loss(model, params, tokens,
                                                   window)),
        ("sub-model grad 2x256", grad_pass),
    ]
    total, losses = {}, {}
    for tag, fn in parts:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        loss = out[0] if isinstance(out, tuple) else out
        losses[tag] = loss
        check(math.isfinite(loss), f"eval {tag}: loss {loss}")
        print(f"[eval] {tag:22s} loss {loss:.6f}  {float(np.mean(secs)):.4f} "
              f"s (mean of 3 after a warm-up: {[round(t, 4) for t in secs]})"
              f"  peak {peak / 2**30:.2f} GiB  launches {launches}")
        if isinstance(out, tuple):
            check(out[1] == 0 and out[2], f"eval {tag}: {out[1]} nonzero "
                  f"w_gate grads outside the window, finite {out[2]}")
            print(f"[eval] {tag}: grads finite, w_gate grad exactly 0 "
                  "outside the d_ff window")
    for a, b in (("server, flash", "server, blockwise"),
                 ("sub-model, flash", "sub-model, blockwise")):
        rel = abs(losses[a] - losses[b]) / abs(losses[b])
        check(rel <= EVAL_RTOL, f"eval {a} {losses[a]} vs {b} {losses[b]}: "
              f"relative {rel:.3g}")
        print(f"[eval] {a} vs {b}: relative difference {rel:.3g} "
              f"(tolerance {EVAL_RTOL})")
    # the logits themselves, a finer check than the mean loss
    with torch.no_grad():
        with flash_switch(True):
            got = model.forward(params, tokens)[0]
        want = model.forward(params, tokens)[0]
    e = err(got, want)
    del got, want
    check(e[1] <= MM_RTOL, f"eval logits flash vs blockwise: {e}")
    print(f"[eval] server logits flash vs blockwise: max abs diff {e[0]:.3g} "
          f"(rel {e[1]:.3g}, tolerance {MM_RTOL})")
    print(f"[eval] kernel launches on the eval path {total}")
    for tag, fn in (parts[0], parts[2], parts[-1]):
        phase_profile_eval(tag, fn)
    return total


def phase_profile_eval(tag, fn):
    """One more run of an eval part under torch.profiler: device time by
    kernel group (the flash kernel's share) and the profiled wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    kern, groups = device_kernels(prof)
    if not kern:
        print(f"[profile eval] {tag}: the trace holds no device time: not "
              "measured")
        return
    total = sum(t for _, t, _ in kern)
    print(f"[profile eval] {tag}: device kernels {total:.1f} ms in "
          f"{sum(n for _, _, n in kern)} launches; profiled wall "
          f"{wall_ms:.1f} ms")
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile eval] {tag}: {g:26s} {t:9.2f} ms "
              f"{100 * t / total:5.1f}%")


def phase_trainer_eval(trainer, data):
    """Two more window rounds through ``api.Trainer`` with ``eval_fn``
    (the held-out loss, blockwise attention), ``eval_every=1`` and
    ``log_every=1``, resuming at the trainer's round."""
    from repro_torch import api
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    cfg = get_config("tinyllama_1_1b")
    model = build_model(cfg)
    dev = trainer.fed.device
    batch = {"tokens": torch.as_tensor(
        next(lm_batches(cfg.vocab, (EB,), ES, seed=999))["tokens"],
        dtype=torch.long).to(dev)}
    lines = []
    t = api.Trainer(trainer.fed, trainer.params,
                    eval_fn=lambda p: {"eval": model.loss(p, batch)[0]},
                    eval_every=1, log_every=1, log_fn=lines.append,
                    start_round=trainer.round_idx)
    with flash_switch(False):
        t.run(iter(data[:2]), 2)
    for line in lines:
        print(f"[trainer] {line}")
    evals = [h.get("eval") for h in t.history]
    check(len(lines) == 2 and all(ln.startswith("round ") and " eval "
                                  in ln for ln in lines),
          f"trainer log lines {lines}")
    check(all(isinstance(e, float) and math.isfinite(e) for e in evals),
          f"trainer eval values {evals}")
    print(f"[trainer] history keys {sorted(t.history[-1])}; eval {evals}")


def phase_mask_path(dev, _build):
    """The mask round (Algorithm 1) at full width: ``api.fed_round`` picks
    mask mode for ``bernoulli`` by itself; every leaf's masked step runs
    twice per round (K = 2) and its fill-in once."""
    from repro_torch import api
    cfg, model, data = full_width(dev)
    params = model.init(seed=0, device=dev)
    fed = api.fed_round(model, scfg_for("bernoulli"), device=dev)
    check(isinstance(fed, api.MaskFedAvg),
          f"bernoulli resolved to {type(fed).__name__}, not MaskFedAvg")
    trainer = api.Trainer(fed, params, rng=0)
    print(f"[mask] {cfg.name}: {len(params)} leaves, bernoulli masks at "
          f"capacities {fed.capacities.tolist()}, Trainer(rng=0)")
    launches, round_s = run_rounds("mask", trainer, data, _build)
    leaves = len(params)
    want = {"masked_sgd_inplace": 2 * leaves * len(data),
            "fillin_agg_inplace": leaves * len(data)}
    got = {k: launches.get(k, 0) for k in want}
    check(got == want, f"mask path launches {got}, expected {want}")
    return launches, trainer, data[0], round_s


def phase_client_phase_peaks(trainer, batch):
    """Peak memory and time of one client phase (K = 2 steps) of the mask
    round, as the round runs it (the model on ``w_c``) and in the literal
    form (the model on ``m * w_c``), from the same params and masks."""
    from repro_torch.core.fedavg import dense_client_masks
    fed = trainer.fed
    dev = fed.device
    batch = {k: torch.as_tensor(v).to(dev, dtype=torch.long)
             for k, v in batch.items()}
    masks = dense_client_masks(torch.Generator(dev).manual_seed(1),
                               fed.abstract, fed.axes, fed.scfg,
                               fed.capacities, 0, dev)
    for literal in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        w_c, losses = fed.client_phase(trainer.params, batch, masks,
                                       literal=literal)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(bool(torch.isfinite(losses).all()), "client phase losses")
        del w_c, losses
        form = "literal m * w_c" if literal else "on w_c, as the round runs"
        print(f"[mask] client phase ({form}): peak {peak / 2**30:.2f} GiB, "
              f"{secs:.3f} s")


SB, SS, SG = 8, 32768, 64    # Mamba2 serving: batch, prompt, greedy steps
DB, DS, DG = 4, 1536, 512    # TinyLlama serving: 2048 positions in all


def timed(fn, n):
    """``n`` calls of ``fn``, each timed to a synchronize; returns the
    seconds and the last result."""
    secs, out = [], None
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs, out


def teacher_forced(model, params, seq, split):
    """Prefill ``seq[:, :split]``, then feed ``seq[:, split:]`` through
    ``decode_step`` one token at a time; returns the last logits and the
    caches."""
    S = seq.shape[1]
    with torch.no_grad():
        logits, cache = model.prefill(params, seq[:, :split], max_len=S)
        for pos in range(split, S):
            logits, cache = model.decode_step(params, seq[:, pos], cache, pos)
    return logits, cache


def phase_serve_ssm(dev, _build):
    """Full-width Mamba2-130M serving (random weights, seed 0, f32): 8
    BigramLM prompts of 32768 tokens, prefill and 64 greedy decode steps
    through ``serve.generate``.  The first run is counted (launches from 0,
    peak from a reset) and is the warm-up; two more are timed.  Then the
    kernel's chunk states against the recurrence: prefill 32512 tokens and
    decode the last 256, teacher-forced, against one prefill of all 32768.
    Returns the model, params and prompts for the eval and the profile, and
    the launches of the counted run."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.specs import sample_prompts
    from repro_torch.models import build_model
    cfg = get_config("mamba2_130m")
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    t0 = time.perf_counter()
    prompts = torch.as_tensor(sample_prompts(cfg, SB, SS, seed=0)[0],
                              dtype=torch.long).to(dev)
    print(f"[serve ssm] {cfg.name}: {cfg.n_layers} layers, "
          f"{sum(v.numel() for v in params.values()):,} params, f32; prompts "
          f"{list(prompts.shape)} (BigramLM, seed 0, drawn in "
          f"{time.perf_counter() - t0:.1f} s)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    first = generate(model, params, prompts, SG)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    runs = [generate(model, params, prompts, SG) for _ in range(2)]
    pre = [r["prefill_s"] for r in runs]
    dec = [1e3 * r["decode_s"] / SG for r in runs]
    print(f"[serve ssm] prefill {SB}x{SS}: {float(np.mean(pre)):.4f} s (mean "
          f"of 2 after a warm-up: {[round(t, 4) for t in pre]}; warm-up "
          f"{first['prefill_s']:.4f} s)")
    print(f"[serve ssm] decode: {float(np.mean(dec)):.3f} ms/token ({SG} "
          f"greedy steps, batch {SB}; runs {[round(t, 3) for t in dec]})")
    print(f"[serve ssm] peak memory allocated {peak / 2**30:.2f} GiB; "
          f"kernel launches {launches}")
    toks = first["tokens"]
    check(launches.get("ssd_chunk_intra") == cfg.n_layers,
          f"ssd_chunk_intra launched {launches.get('ssd_chunk_intra')} times "
          f"in one prefill of {cfg.n_layers} layers")
    check(toks.shape == (SB, SG) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab, f"generated tokens {toks.shape}")
    same = all(torch.equal(r["tokens"], toks) for r in runs)
    print(f"[serve ssm] generations equal across the 3 runs: {same}; first "
          f"row {toks[0, :12].tolist()}")

    with torch.no_grad():
        want, full = model.prefill(params, prompts)
    split = SS - cfg.ssm.chunk
    got, cache = teacher_forced(model, params, prompts, split)
    e = err(got, want)
    eh = [err(cache[f"ssm_layers/{i}/h"], full[f"ssm_layers/{i}/h"])
          for i in range(cfg.n_layers)]
    worst = max(eh, key=lambda t: t[1])
    check(bool(torch.isfinite(want).all()), "prefill logits not finite")
    check(e[1] <= MM_RTOL and eh[0][1] <= MM_RTOL
          and worst[1] <= DEPTH_RTOL,
          f"prefill {split} + {SS - split} decode steps vs prefill {SS}: "
          f"logits {e}, state h per layer {eh}")
    print(f"[serve ssm] prefill {split} + {SS - split} teacher-forced decode "
          f"steps vs prefill {SS}: logits max abs diff {e[0]:.3g} (rel "
          f"{e[1]:.3g}, tolerance {MM_RTOL}); state h rel by layer "
          f"{[float(f'{r:.3g}') for _, r in eh]} (layer 0 within {MM_RTOL}, "
          f"all within {DEPTH_RTOL})")
    e0 = layer_states_vs_recurrence(model, params, prompts, split)
    check(e0[1] <= MM_RTOL, f"layer 0's chunk states vs the recurrence on "
          f"the same input: {e0}")
    print(f"[serve ssm] layer 0 on the prefill's own input: chunked SSD over "
          f"{SS} vs chunked {split} + {SS - split} recurrent steps: state h "
          f"max abs diff {e0[0]:.3g} (rel {e0[1]:.3g}, tolerance {MM_RTOL})")
    return model, params, prompts, launches, float(np.mean(pre))


def layer_states_vs_recurrence(model, params, prompts, split):
    """Layer 0's mixer on one input, the embedded and normed prompts: the
    state of one chunked pass over all of them (the kernel's chunk states
    and the inter-chunk loop) against a chunked pass over ``split`` tokens
    followed by one recurrent step per token.  Returns ``err``."""
    from repro_torch.models import ssm
    from repro_torch.models.layers import rms_norm_plain
    cfg = model.cfg
    pre = "ssm_layers/0/ssm/"
    p = {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}
    with torch.no_grad():
        u = rms_norm_plain(torch.nn.functional.embedding(prompts,
                                                         params["embed"]),
                           params["ssm_layers/0/ln1"], cfg.norm_eps)
        _, whole = ssm.ssm_train(p, u, cfg, return_state=True)
        _, cache = ssm.ssm_train(p, u[:, :split], cfg, return_state=True)
        for t in range(split, u.shape[1]):
            _, cache = ssm.ssm_decode(p, u[:, t:t + 1], cfg, cache, t)
    return err(cache["h"], whole["h"])


def phase_eval_ssm(dev, model, params, _build):
    """Mamba2-130M's loss (``Model.loss`` under no_grad) on 4 x 2048
    held-out tokens: counted once (the warm-up), then timed 3 times."""
    from repro_torch.data.synthetic import lm_batches
    tokens = torch.as_tensor(next(lm_batches(model.cfg.vocab, (EB,), ES,
                                             seed=999))["tokens"],
                             dtype=torch.long).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    loss = eval_loss(model, params, tokens)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    secs, again = timed(lambda: eval_loss(model, params, tokens), 3)
    peak = torch.cuda.max_memory_allocated()
    check(math.isfinite(loss) and math.isfinite(again),
          f"eval ssm loss {loss}, {again}")
    check(launches.get("ssd_chunk_intra") == model.cfg.n_layers,
          f"eval ssm launches {launches}")
    print(f"[eval ssm] {model.cfg.name} loss on {EB}x{ES} held-out tokens "
          f"(seed 999) {loss:.6f} (timed runs: {again:.6f})  "
          f"{float(np.mean(secs)):.4f} s (mean of 3 "
          f"after a warm-up: {[round(t, 4) for t in secs]})  peak "
          f"{peak / 2**30:.2f} GiB  launches {launches}")


def phase_profile_serve_ssm(model, params, prompts, prefill_s):
    """One Mamba2 prefill under torch.profiler: device time by kernel group,
    the inter-chunk loop's device and host time (its profiler range), and
    the device time's share of an unprofiled prefill."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ssd_chunk import RECURRENCE
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            torch.no_grad():
        model.prefill(params, prompts)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    # the range shows up on the device too, as an annotation: not a kernel
    kern, groups = device_kernels(prof, skip=(RECURRENCE,))
    if not kern:
        print("[profile serve ssm] the trace holds no device time: not "
              "measured")
        return
    total = sum(t for _, t, _ in kern)
    print(f"[profile serve ssm] one prefill {SB}x{SS}: device kernels "
          f"{total:.1f} ms in {sum(n for _, _, n in kern)} launches = "
          f"{100 * total / (1e3 * prefill_s):.1f}% of an unprofiled prefill "
          f"({1e3 * prefill_s:.1f} ms); profiled wall {wall_ms:.1f} ms")
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile serve ssm] {g:26s} {t:9.2f} ms "
              f"{100 * t / total:5.1f}%")
    for e in prof.key_averages():
        if e.key == RECURRENCE and e.device_type == DeviceType.CPU:
            dev_ms = e.device_time_total / 1e3
            print(f"[profile serve ssm] inter-chunk loop ({RECURRENCE}, "
                  f"{e.count} ranges): its kernels {dev_ms:.2f} ms on the "
                  f"device = {100 * dev_ms / total:.1f}%; "
                  f"{e.cpu_time_total / 1e3:.2f} ms on the host, waits on "
                  "the full launch queue included")
    for name, t, n in sorted(kern, key=lambda r: -r[1])[:10]:
        print(f"[profile serve ssm]   {t:9.2f} ms x{n:<5d} {name[:100]}")
    with torch.no_grad():
        logits, cache = model.prefill(params, prompts[:, :256], max_len=257)
    tok = torch.argmax(logits, -1)
    profile_decode_step("serve ssm", lambda: model.decode_step(
        params, tok, cache, 256))


def profile_decode_step(tag, fn):
    """One decode step: its unprofiled wall time (mean of 3 after a
    warm-up) against the device time and launches of one more step under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    secs, _ = timed(fn, 3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern, groups = device_kernels(prof)
    if not kern:
        print(f"[profile {tag}] decode step: the trace holds no device "
              "time: not measured")
        return
    total = sum(t for _, t, _ in kern)
    wall = 1e3 * float(np.mean(secs))
    print(f"[profile {tag}] one decode step: device kernels {total:.3f} ms "
          f"in {sum(n for _, _, n in kern)} launches = "
          f"{100 * total / wall:.1f}% of an unprofiled step ({wall:.3f} ms); "
          + ", ".join(f"{g} {t:.3f} ms" for g, t in
                      sorted(groups.items(), key=lambda kv: -kv[1])))


def phase_serve_dense(dev, _build):
    """Full-width TinyLlama-1.1B serving: 4 prompts of 1536 tokens, 512
    greedy steps (2048 positions, its context).  A short warm-up, two
    timed prefills, then the full generation timed with the peak from a
    reset; then prefill 1536 + the 512 generated tokens teacher-forced
    against one prefill of all 2048."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.specs import sample_prompts
    from repro_torch.models import build_model
    cfg = get_config("tinyllama_1_1b")
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    prompts = torch.as_tensor(sample_prompts(cfg, DB, DS, seed=0)[0],
                              dtype=torch.long).to(dev)
    generate(model, params, prompts, 8)
    with torch.no_grad():
        pre, (logits, cache) = timed(lambda: model.prefill(
            params, prompts, max_len=DS + DG), 2)
    tok = torch.argmax(logits, -1)
    profile_decode_step("serve dense", lambda: model.decode_step(
        params, tok, cache, DS))
    del logits, cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    out = generate(model, params, prompts, DG)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve dense] {cfg.name}: prefill {DB}x{DS}: "
          f"{float(np.mean(pre)):.4f} s (mean of 2 after a warm-up: "
          f"{[round(t, 4) for t in pre]}; in the generation "
          f"{out['prefill_s']:.4f} s)")
    print(f"[serve dense] decode: {1e3 * out['decode_s'] / DG:.3f} ms/token "
          f"({DG} greedy steps, batch {DB}); peak memory allocated "
          f"{peak / 2**30:.2f} GiB; kernel launches {launches}")
    seq = torch.cat([prompts, out["tokens"]], dim=1)
    with torch.no_grad():
        want, _ = model.prefill(params, seq)
    got, _ = teacher_forced(model, params, seq, DS)
    e = err(got, want)
    check(bool(torch.isfinite(want).all()) and e[1] <= MM_RTOL,
          f"dense prefill {DS} + {DG} decode steps vs prefill {DS + DG}: {e}")
    print(f"[serve dense] prefill {DS} + {DG} teacher-forced decode steps vs "
          f"prefill {DS + DG}: logits max abs diff {e[0]:.3g} (rel "
          f"{e[1]:.3g}, tolerance {MM_RTOL})")


def device_kernels(prof, skip=()):
    """``(name, device ms, count)`` of every kernel in a profile, leaving
    out the names in ``skip``, and their device ms summed by group."""
    from torch.autograd import DeviceType
    kern = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in skip
            and e.self_device_time_total > 0]
    groups = {}
    for name, t, _ in kern:
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + t
    return kern, groups


def _kernel_group(name):
    for key, group in (("flash_attn", "flash_attention (port)"),
                       ("ssd_chunk", "ssd_chunk_intra (port)"),
                       ("rolling_mm_fwd", "rolling_mm_fwd (port)"),
                       ("rolling_mm_dx", "rolling_mm_dx (port)"),
                       ("masked_sgd", "masked_sgd_inplace (port)"),
                       ("fillin_agg", "fillin_agg_inplace (port)"),
                       ("sgd_inplace", "sgd_inplace (port)"),
                       ("distribution", "random draws (masks)"),
                       ("gemm", "cuBLAS gemm (bmm, addmm)"),
                       ("elementwise", "elementwise"),
                       ("reduce", "reductions"),
                       ("Memcpy", "copies"), ("Memset", "fills")):
        if key in name:
            return group
    return "other"


def phase_profile(tag, trainer, batch, round_s):
    """One more round (after the counted ones) under torch.profiler:
    device time by kernel group, and its share of an unprofiled round's
    wall time ``round_s`` (the profiled round's own wall time carries the
    profiler's host cost, so it is printed but not divided by)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.run(iter([batch]), 1)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    kern, groups = device_kernels(prof)
    if not kern:
        print(f"[profile {tag}] the trace holds no device time: not "
              "measured")
        return
    total = sum(t for _, t, _ in kern)
    print(f"[profile {tag}] one round: device kernels {total:.1f} ms = "
          f"{100 * total / (1e3 * round_s):.1f}% of an unprofiled round "
          f"({1e3 * round_s:.1f} ms); profiled wall {wall_ms:.1f} ms")
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile {tag}] {g:26s} {t:9.2f} ms {100 * t / total:5.1f}%")
    for name, t, n in sorted(kern, key=lambda r: -r[1])[:12]:
        print(f"[profile {tag}]   {t:9.2f} ms x{n:<5d} {name[:100]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's check needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 everywhere
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[card] {kind}; {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")

    phase_build(_build)
    rows = phase_kernels(dev)
    try:
        phase_small_agreement(dev)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    phase_small_agreement_mask(dev)
    phase_small_agreement_ssm(dev)
    launches, trainer, batch, round_s = phase_main_path(dev, _build)
    e_launches = phase_eval(dev, trainer, _build)
    phase_profile("window", trainer, batch, round_s)
    phase_trainer_eval(trainer, full_width(dev)[2])
    del trainer            # the two full-width paths do not fit together
    gc.collect()
    torch.cuda.empty_cache()
    m_launches, trainer, batch, round_s = phase_mask_path(dev, _build)
    phase_profile("mask", trainer, batch, round_s)
    phase_client_phase_peaks(trainer, batch)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    model, params, prompts, s_launches, prefill_s = phase_serve_ssm(dev,
                                                                    _build)
    phase_eval_ssm(dev, model, params, _build)
    phase_profile_serve_ssm(model, params, prompts, prefill_s)
    del model, params, prompts
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve_dense(dev, _build)
    path = {"masked_sgd_inplace": m_launches, "fillin_agg_inplace": m_launches,
            "ssd_chunk_intra": s_launches}
    path.update({name: e_launches for name in (
        "flash_attention", "rolling_matmul", "rolling_matmul_multi",
        "rolling_matmul_dx", "rolling_matmul_dx_multi")})
    for r in rows:
        r["launches"] = path.get(r["name"], launches).get(r["name"], 0)
    missing = [r["name"] for r in rows if r["launches"] == 0]
    check(not missing, f"kernels never launched on their path: {missing}")

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
