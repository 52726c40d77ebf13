#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check what comes out.

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:

1. Build the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
   print nvcc's ``-Xptxas -v`` report and the card.
2. Hold every kernel of the three paths against its plain PyTorch version
   on the card, at the shapes the full-width TinyLlama-1.1B rounds and
   evaluation give it (plus unaligned offsets, ragged lengths, sliding
   windows and other head groupings): the product kernels' forward values
   and autograd gradients, the flash kernel's output, and the three update
   kernels bit for bit; time each beside its plain version, one library
   call for the same function (where one exists) and its f32 bound on an
   H100.
3. Run two rounds of the reduced model on the card and on the CPU (the
   plain versions) from the same params, tokens and windows or masks
   (masks drawn on the CPU and copied), and hold the two against each
   other: the window round (checkpointed through ``checkpoint_callback``
   and loaded back bit for bit), a Bernoulli mask round and a structured
   rolling mask round at per-client capacities; and one model's eval
   through the flash kernel against the same eval on the CPU.
4. The window path: the shared-window federated round on full-width
   TinyLlama-1.1B (22 layers, f32, 4 clients x 2 local steps x 2 x 256
   tokens), through ``api.fed_round`` and ``api.Trainer``, 3 rounds, with
   every kernel's launch count read before and after.
4a. The eval path, on the server params those rounds leave: the held-out
   loss of one model (``Model.loss``, 4 x 2048 tokens) with
   ``REPRO_USE_FLASH`` set and without, the windowed sub-model's loss
   with the switch (the scalar-offset products and the flash kernel), and
   one backward pass of the windowed sub-model's loss at 2 x 256 tokens
   without it; launches counted per part, seconds and peak memory, one
   flash eval and one backward pass under ``torch.profiler``.  Then one more window round under
   ``torch.profiler`` for the device time by kernel group, and two rounds
   of ``api.Trainer`` with ``eval_fn``, ``eval_every=1`` and
   ``log_every=1``.  The trainer and params are freed before the next
   phase.
4b. The mask path: the same configuration with ``scheme="bernoulli"``
   (Algorithm 1, mask mode chosen by ``api.fed_round`` itself) through
   ``api.Trainer(rng=0)``, 3 rounds, counted, checked and profiled the
   same way; then the peak memory of one client phase run with the model
   on ``w_c`` (what the round runs) and on the literal ``m * w_c``.

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
# kernel vs plain version: f32 both, different summation order; bounded
# relative to the output's largest magnitude
MM_RTOL = 1e-4
ROUND_TOL = 1e-4          # reduced round, card vs CPU (losses and params)
EVAL_RTOL = 1e-5          # full-width eval loss, flash vs blockwise
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


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
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
        if "ptxas info" in line or line.startswith("=="):
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
# 1024 of 2048 columns) and the gate/up pair (d_ff window 2816 of 5632)
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
        x = torch.randn((C, M, D), device=dev, generator=g)
        ws = [torch.randn((C, D, N), device=dev, generator=g)
              for _ in range(T)]
        dys = [torch.randn((C, M, win), device=dev, generator=g)
               for _ in range(T)]
        offs = [off] * C
        o = make_offsets(offs, dev)
        views = [w[:, :, off:off + win] for w in ws]
        flops = 2 * C * T * M * D * win
        if kind == "fwd":
            kern = lambda: rolling_mm_fwd(x, ws, o, win)            # noqa
            plain = lambda: ref.rolling_matmul_batched_ref(x, ws, offs,  # noqa
                                                           win)
            lib = lambda: [torch.bmm(x, v) for v in views]         # noqa
            out, want = kern(), plain()
            e = max((err(a, b) for a, b in zip(out, want)),
                    key=lambda t: t[1])
            nbytes = 4 * (C * M * D + T * C * D * win + T * C * M * win)
            shape = {"x": [C, M, D], "W": [T, C, D, N], "win": win}
        else:
            kern = lambda: rolling_mm_dx(dys, ws, o, win)          # noqa
            plain = lambda: ref.rolling_matmul_batched_dx_ref(  # noqa
                dys, ws, offs, win)

            def lib():
                acc = torch.bmm(dys[0], views[0].mT)
                for d, v in zip(dys[1:], views[1:]):
                    acc = torch.baddbmm(acc, d, v.mT)
                return acc
            e = err(kern(), plain())
            nbytes = 4 * (T * C * M * win + T * C * D * win + C * M * D)
            shape = {"dy": [T, C, M, win], "W": [T, C, D, N], "win": win}
        check(e[1] <= MM_RTOL, f"{name} at {shape}: {e}")
        b_ms, b_by = bound(flops, nbytes)
        k_ms = cuda_ms(kern)
        rows.append(dict(
            name=name, route="cuda", source=SRC + "rolling_mm.cu",
            replaces=TPU + tpu_fn, tpu_row=row, shape=shape,
            max_abs_err=e[0], max_rel_err=e[1], tolerance=MM_RTOL,
            ms=k_ms, kernel_ms=k_ms, plain_ms=cuda_ms(plain),
            library_ms=cuda_ms(lib), library_calls=T,
            bound_ms=b_ms, bound_by=b_by))

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
    for r in rows:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"[kernels] {r['name']:18s} err {r['max_abs_err']:.3g} "
              f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"library {lib}  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    return rows


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
        x = torch.randn((m, D), device=dev, generator=g)
        ws = [torch.randn((D, N), device=dev, generator=g) for _ in range(T)]
        dys = [torch.randn((m, win), device=dev, generator=g)
               for _ in range(T)]
        o = make_offsets([off], dev)     # the device copy a model keeps
        views = [w[:, off:off + win] for w in ws]
        flops = 2 * T * m * D * win
        if kind == "fwd":
            kern = lambda: rolling_matmul_fwd(x, ws, o, win)      # noqa
            plain = lambda: plain_fwd(x, ws, off, win)            # noqa
            lib = lambda: [torch.mm(x, v) for v in views]         # noqa
            e = max((err(a, b[0]) for a, b in zip(kern(), plain())),
                    key=lambda t: t[1])
            nbytes = 4 * (m * D + T * D * win + T * m * win)
            shape = {"x": [m, D], "W": [T, D, N], "win": win}
        else:
            kern = lambda: rolling_matmul_dx(dys, ws, o, win)     # noqa
            plain = lambda: plain_dx(dys, ws, off, win)           # noqa

            def lib():
                acc = torch.mm(dys[0], views[0].mT)
                for d, v in zip(dys[1:], views[1:]):
                    acc = torch.addmm(acc, d, v.mT)
                return acc
            e = err(kern(), plain()[0])
            nbytes = 4 * (T * m * win + T * D * win + m * D)
            shape = {"dy": [T, m, win], "W": [T, D, N], "win": win}
        check(e[1] <= MM_RTOL, f"{name} at {shape}: {e}")
        b_ms, b_by = bound(flops, nbytes)
        k_ms = cuda_ms(kern)
        rows.append(dict(
            name=name, route="cuda", source=SRC + "rolling_mm.cu",
            replaces=TPU + tpu_fn, tpu_row=row, shape=shape,
            max_abs_err=e[0], max_rel_err=e[1], tolerance=MM_RTOL,
            ms=k_ms, kernel_ms=k_ms, plain_ms=cuda_ms(plain),
            library_ms=cuda_ms(lib), library_calls=T,
            bound_ms=b_ms, bound_by=b_by))
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
    for tag, fn in (parts[0], parts[-1]):
        phase_profile_eval(tag, fn)
    return total


def phase_profile_eval(tag, fn):
    """One more run of an eval part under torch.profiler: device time by
    kernel group (the flash kernel's share) and the profiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    kern = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not kern:
        print(f"[profile eval] {tag}: the trace holds no device time: not "
              "measured")
        return
    total = sum(t for _, t, _ in kern)
    groups = {}
    for name, t, _ in kern:
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + t
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


def _kernel_group(name):
    for key, group in (("flash_attn", "flash_attention (port)"),
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.run(iter([batch]), 1)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    kern = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not kern:
        print(f"[profile {tag}] the trace holds no device time: not "
              "measured")
        return
    total = sum(t for _, t, _ in kern)
    groups = {}
    for name, t, _ in kern:
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + t
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
    path = {"masked_sgd_inplace": m_launches, "fillin_agg_inplace": m_launches}
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
