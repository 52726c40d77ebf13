#!/usr/bin/env python3
"""Time the bf16 arms of the windowed products (TPU rows 1-8), of the SSD
chunk block (row 12) and of flash attention (row 13) on one card, in one or
more source trees, interleaved.

    python3 tools/bf16_kernel_bench.py [--trees DIR ...] [--reps N]
        [--only products|ssd|flash|f32] [--out FILE]

Each tree (default: this checkout) runs in a process of its own, with its
``src`` first on the path and its kernels built into its own
``build/kernels``.  The trees run in the order given, then reversed, N
times (two trees, N = 1: parent, change, change, parent), so that two
versions are compared within one call on one card.  Every run prints one
JSON line: for each shape the kernel's mean device time over 20 launches
after a 25 ms warm-up (CUDA events, as ``chip_smoke.cuda_ms``) and the
device time of its kernels alone (``torch.profiler``), the body
each product launch ran (where the tree's kernels report one), and the
largest excess of its error over the bf16 arms' tolerance against the
plain version on the same inputs (one bf16 ulp plus 1e-6 of the largest
output, 1e-4 for flash; <= 0 passes).  The shapes are those
``chip_smoke.py`` times: rows 5-8 at TinyLlama's window round (q and the
gate/up pair, the k/v projections), the SSM and hybrid rounds' narrow
windows, rows 1-4 at its sub-model eval and backward; row 13 at its eval,
head_dim 128 and Hymba's window; row 12 at a Mamba2-130M prefill layer
(x [8, 128, 256, 24, 64], d_state 128) and at Hymba-1.5B's (x [4, 16,
128, 50, 64], d_state 16), its y held to one bf16 ulp plus 1e-4 of the
largest output and its f32 states to 1e-4 (the excess is the larger);
each product also with the host's microseconds a call.  ``--only f32``
runs the f32 arms of rows 1-8, 12 and 13 at the timed shapes instead and
prints a digest of their outputs, so that two trees' f32 kernels can be
held to the same bits and times.  The card's name and power limit lead the
output.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WARM_MS = 25.0

# (tag, kind, T, C, M, K, N, win, offset)
PRODUCTS = [
    ("row 5 q", "fwd", 1, 4, 512, 2048, 2048, 1024, 1024),
    ("row 6 q", "dx", 1, 4, 512, 2048, 2048, 1024, 1024),
    ("row 7", "fwd", 2, 4, 512, 2048, 5632, 2816, 2816),
    ("row 8", "dx", 2, 4, 512, 2048, 5632, 2816, 2816),
    ("row 5 k/v", "fwd", 1, 4, 512, 2048, 256, 128, 128),
    ("row 6 k/v", "dx", 1, 4, 512, 2048, 256, 128, 128),
    ("row 5 mamba2 dt", "fwd", 1, 4, 2048, 768, 24, 12, 12),
    ("row 6 mamba2 dt", "dx", 1, 4, 2048, 768, 24, 12, 12),
    ("row 5 hymba dt", "fwd", 1, 4, 512, 1600, 50, 25, 25),
    ("row 6 hymba dt", "dx", 1, 4, 512, 1600, 50, 25, 25),
    ("row 5 hymba q", "fwd", 1, 4, 512, 1600, 1600, 640, 960),
    ("row 6 hymba q", "dx", 1, 4, 512, 1600, 1600, 640, 960),
    ("row 1", "fwd", 1, 1, 8192, 2048, 2048, 1024, 1024),
    ("row 2", "fwd", 2, 1, 8192, 2048, 5632, 2816, 2816),
    ("row 3", "dx", 1, 1, 512, 2048, 2048, 1024, 1024),
    ("row 4", "dx", 2, 1, 512, 2048, 5632, 2816, 2816),
]
# (tag, Bt, nc, Q, nh, hd, N): a Mamba2 and a Hymba prefill layer
SSD = [
    ("row 12 mamba2", 8, 128, 256, 24, 64, 128),
    ("row 12 hymba", 4, 16, 128, 50, 64, 16),
]
# (tag, B, S, H, KV, hd, window)
FLASH = [
    ("row 13 eval", 4, 2048, 32, 4, 64, 0),
    ("row 13 hd 128", 4, 2048, 32, 8, 128, 0),
    ("row 13 hymba", 4, 2048, 25, 5, 64, 1024),
]


def cuda_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while 1e3 * (time.perf_counter() - t0) < WARM_MS:
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


def device_ms(torch, fn, n=20):
    """The device time of the kernels one call of ``fn`` launches, from a
    profile of ``n`` calls (``torch.profiler``: the kernels alone, without
    the host's time between launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / n


def host_us(torch, fn, n=200):
    """Host microseconds a call, over ``n`` calls issued without waiting
    for the card (the wrapper's own cost where the kernel is shorter)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / n


def excess(torch, a, b, slack):
    """The largest ``|a - b| - ulp(b) - slack * max|b|`` (<= 0 passes)."""
    a, b = a.float(), b.float()
    mant, exp = torch.frexp(b)
    ulp = torch.where(mant == 0, torch.zeros_like(b),
                      torch.ldexp(torch.ones_like(b), exp - 8))
    return float(((a - b).abs() - ulp - slack * b.abs().max()).max())


def run_tree(tree, only):
    """One tree's timings, as a dict (runs in its own process)."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rolling_matmul import (make_offsets,
                                                    rolling_mm_dx,
                                                    rolling_mm_fwd)
    from repro_torch.kernels.ssd_chunk import ssd_chunk_intra
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(dev).manual_seed(26)
    _build.library()
    bodies = getattr(_build, "BODIES", None)
    rows = []
    for tag, kind, T, C, M, K, N, win, off in (
            PRODUCTS if only in (None, "products") else []):
        x = torch.randn((C, M, K), device=dev, generator=g).to(bf)
        ws = [torch.randn((C, K, N), device=dev, generator=g).to(bf)
              for _ in range(T)]
        dys = [torch.randn((C, M, win), device=dev, generator=g).to(bf)
               for _ in range(T)]
        o = make_offsets([off] * C, dev)
        if kind == "fwd":
            def kern():
                return rolling_mm_fwd(x, ws, o, win)
            want = ref.rolling_matmul_batched_ref(x, ws, [off] * C, win)
        else:
            def kern():
                return (rolling_mm_dx(dys, ws, o, win),)
            want = (ref.rolling_matmul_batched_dx_ref(dys, ws, [off] * C,
                                                      win),)
        if bodies is not None:
            bodies.clear()
        got = kern()
        body = sorted(bodies) if bodies is not None else None
        e = max(excess(torch, a, b, 1e-6) for a, b in zip(got, want))
        rows.append(dict(tag=tag, kind=kind, T=T, C=C, M=M, K=K, N=N,
                         win=win, body=body, excess=e,
                         ms=cuda_ms(torch, kern),
                         device_ms=device_ms(torch, kern),
                         host_us=host_us(torch, kern)))
        del x, ws, dys, got, want
    for tag, Bt, nc, Q, nh, hd, N in SSD if only in (None, "ssd") else []:
        x, dt, A, B, C = ssd_inputs(torch, dev, g, Bt, nc, Q, nh, hd, N)
        x, dt, B, C = (t.to(bf) for t in (x, dt, B, C))

        def kern():
            return ssd_chunk_intra(x, dt, A, B, C)
        (y, st), (yr, sr) = kern(), ref.ssd_chunk_intra_ref(x, dt, A, B, C)
        e = max(excess(torch, y, yr, 1e-4),
                float((st - sr).abs().max() - 1e-4 * sr.abs().max()))
        del y, st, yr, sr
        rows.append(dict(tag=tag, x=[Bt, nc, Q, nh, hd], N=N, excess=e,
                         ms=cuda_ms(torch, kern),
                         device_ms=device_ms(torch, kern)))
        del x, dt, A, B, C
    for tag, B, S, H, KV, hd, window in (
            FLASH if only in (None, "flash") else []):
        q = torch.randn((B, S, H, hd), device=dev, generator=g).to(bf)
        k = torch.randn((B, S, KV, hd), device=dev, generator=g).to(bf)
        v = torch.randn((B, S, KV, hd), device=dev, generator=g).to(bf)

        def kern():
            return flash_attention(q, k, v, window=window)
        e = excess(torch, kern(), ref.flash_attention_ref(q, k, v,
                                                          window=window),
                   1e-4)
        rows.append(dict(tag=tag, q=[B, S, H, hd], kv_heads=KV,
                         window=window, excess=e, ms=cuda_ms(torch, kern),
                         device_ms=device_ms(torch, kern)))
        del q, k, v
    for tag, kind, T, C, M, K, N, win, off in (
            PRODUCTS[:4] + PRODUCTS[12:] if only == "f32" else []):
        x = torch.randn((C, M, K), device=dev, generator=g)
        ws = [torch.randn((C, K, N), device=dev, generator=g)
              for _ in range(T)]
        dys = [torch.randn((C, M, win), device=dev, generator=g)
               for _ in range(T)]
        o = make_offsets([off] * C, dev)
        if kind == "fwd":
            def kern():
                return rolling_mm_fwd(x, ws, o, win)
        else:
            def kern():
                return (rolling_mm_dx(dys, ws, o, win),)
        rows.append(dict(tag=tag + " f32", sha=digest(kern()),
                         ms=cuda_ms(torch, kern), excess=0.0,
                         device_ms=device_ms(torch, kern)))
        del x, ws, dys
    for tag, Bt, nc, Q, nh, hd, N in SSD if only == "f32" else []:
        x, dt, A, B, C = ssd_inputs(torch, dev, g, Bt, nc, Q, nh, hd, N)

        def kern():
            return ssd_chunk_intra(x, dt, A, B, C)
        rows.append(dict(tag=tag + " f32", sha=digest(kern()),
                         ms=cuda_ms(torch, kern), excess=0.0,
                         device_ms=device_ms(torch, kern)))
        del x, dt, A, B, C
    for tag, B, S, H, KV, hd, window in (FLASH[:2] if only == "f32"
                                         else []):
        q, k, v = (torch.randn((B, S, n, hd), device=dev, generator=g)
                   for n in (H, KV, KV))

        def kern():
            return (flash_attention(q, k, v, window=window),)
        rows.append(dict(tag=tag + " f32", sha=digest(kern()),
                         ms=cuda_ms(torch, kern), excess=0.0,
                         device_ms=device_ms(torch, kern)))
        del q, k, v
    return dict(tree=str(tree), rows=rows)


def ssd_inputs(torch, dev, g, Bt, nc, Q, nh, hd, N):
    """x, dt, A, B, C as the model makes them (``chip_smoke.ssd_inputs``):
    dt a softplus, A negative."""
    F = torch.nn.functional
    return (0.5 * torch.randn((Bt, nc, Q, nh, hd), device=dev, generator=g),
            F.softplus(torch.randn((Bt, nc, Q, nh), device=dev, generator=g)),
            -torch.exp(0.3 * torch.randn((nh,), device=dev, generator=g)),
            0.5 * torch.randn((Bt, nc, Q, N), device=dev, generator=g),
            0.5 * torch.randn((Bt, nc, Q, N), device=dev, generator=g))


def digest(outs):
    """sha256 of the outputs' bytes (two trees' kernels agree to the bit
    where their digests do)."""
    import hashlib
    h = hashlib.sha256()
    for t in outs:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=[str(ROOT)])
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--only", choices=("products", "ssd", "flash", "f32"))
    ap.add_argument("--out", help="also append the JSON lines to this file")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_tree(args.one, args.only)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[card] {smi}")
    order = []
    for _ in range(args.reps):
        order += args.trees + args.trees[::-1]
    rc = 0
    for tree in order:
        cmd = [sys.executable, __file__, "--one", tree]
        if args.only:
            cmd += ["--only", args.only]
        p = subprocess.run(cmd, capture_output=True, text=True,
                           env={**os.environ, "PYTHONPATH": ""})
        if p.returncode:
            print(f"[{tree}] failed:\n{p.stdout}{p.stderr}")
            rc = 1
            continue
        line = p.stdout.strip().splitlines()[-1]
        print(line)
        for r in json.loads(line)["rows"]:
            print(f"[{tree}] {r['tag']:18s} {r['ms']:.4f} ms (device "
                  f"{r['device_ms']:.4f}, host {r.get('host_us', 0):.1f} "
                  f"us a call)  body {r.get('body')}  excess "
                  f"{r['excess']:.3g}  {r.get('sha', '')}")
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
