#!/usr/bin/env python3
"""Time design variants of the in-place update kernels on one card.

    python3 tools/update_variants.py [--out build/update_variants.json]

Builds ``tools/update_variants.cu`` (nvcc, ``sm_90a``, the port's flags)
and compares, for the SGD step (``w <- w - lr * g``, TPU row 10) and the
masked step (``w <- w - (lr * m) * g``, row 9), the port's kernel, the
body it replaced ("old body"), the variants between them, a TMA bulk-copy
route and the one library call for the same function (``add_``,
``addcmul_``), in two parts:

1. ``[leaf]`` the ``w_gate`` client leaf [4, 2048, 5632] of full-width
   TinyLlama-1.1B, f32, against its byte bound (12 and 16 bytes an element
   at 3.35 TB/s); every variant first held bit for bit against the plain
   version.  Each time is ``chip_smoke.cuda_ms`` (the mean of 20 launches
   after a warm-up), taken in the listed order and then in reverse, so
   drift shows.
2. ``[round]`` the update group inside the full-width TinyLlama-1.1B rounds
   of ``chip_smoke.py`` (mask round, then window round): the client
   optimizer's kernel is swapped for each design in turn, two rounds are
   timed and one more is profiled, and the group's device time is summed
   from the profile.

Prints the card's name and power limit and writes everything as JSON to
``--out``.
"""
import argparse
import ctypes
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

SRC = ROOT / "tools" / "update_variants.cu"
OUT = _build.BUILD_DIR.parent / "tools" / "libupdate_variants.so"
SHAPE = (4, 2048, 5632)
KINDS = ((0, "sgd_inplace"), (1, "masked_sgd_inplace"))

# A register design is (U, hint, grid), see update_variants.cu; ("tma", s)
# is the TMA route with s stages of 16 KB an operand.
OLD = (1, 0, 0)
PORT = (1, 0, -1)
LEAF_DESIGNS = [
    ("old body (U1, plain, old grid)", OLD),
    ("+ one wave (U1, plain)", (1, 0, 1)),
    ("+ U4 (plain, one wave)", (4, 0, 1)),
    ("+ hints (U4, one wave)", (4, 1, 1)),
    ("U2, hints, one wave", (2, 1, 1)),
    ("U8, hints, one wave", (8, 1, 1)),
    ("U8, hints, old grid", (8, 1, 0)),
    ("U1, plain, a block a tile (the port's)", PORT),
    ("U1, hints, a block a tile", (1, 1, -1)),
    ("U4, plain, a block a tile", (4, 0, -1)),
    ("U4, hints, a block a tile", (4, 1, -1)),
    ("TMA bulk, 2 stages of 16 KB", ("tma", 2)),
    ("TMA bulk, 4 stages of 16 KB", ("tma", 4)),
]
ROUND_DESIGNS = [
    ("old body (U1, plain, old grid)", OLD),
    ("U1, plain, a block a tile (the port's)", PORT),
    ("U1, hints, a block a tile", (1, 1, -1)),
    ("U4, plain, a block a tile", (4, 0, -1)),
    ("U4, hints, a block a tile", (4, 1, -1)),
    ("+ hints (U4, one wave)", (4, 1, 1)),
    ("TMA bulk, 4 stages of 16 KB", ("tma", 4)),
]


def build():
    """Compile the variants into their own library; returns it and the
    ``-Xptxas -v`` report."""
    OUT.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                          "-v", "-shared", "-o", str(OUT), str(SRC)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(OUT))
    P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.update_variant.argtypes = [I, I, I, I, P, P, P, F, LL, P]
    lib.update_bulk.argtypes = [I, I, P, P, P, F, LL, P]
    lib.update_variant.restype = lib.update_bulk.restype = I
    return lib, res.stdout + res.stderr


def in_turns(designs):
    """``{label: [ms in listed order, ms in reverse order]}``."""
    times = {label: [] for label, _ in designs}
    for order in (designs, designs[::-1]):
        for label, fn in order:
            times[label].append(chip_smoke.cuda_ms(fn))
    return times


class Variants:
    """The variants' library, launched on the current stream."""

    def __init__(self, lib):
        self.lib = lib
        self.stream = torch.cuda.current_stream().cuda_stream

    def __call__(self, masked, design, w, m, g, lr=1e-6):
        ptrs = (w.data_ptr(), m.data_ptr(), g.data_ptr(), lr, w.numel(),
                self.stream)
        if design[0] == "tma":
            err = self.lib.update_bulk(masked, design[1], *ptrs)
        else:
            err = self.lib.update_variant(masked, *design, *ptrs)
        if err:
            raise RuntimeError(f"variant {masked, design}: error {err}")
        return w


def port_and_library(masked):
    """The port's wrapper and the library call, as ``(w, m, g)`` designs."""
    from repro_torch.kernels.masked_update import masked_sgd_, sgd_
    if masked:
        return [("port kernel (wrapper)",
                 lambda w, m, g: masked_sgd_(w, m, g, 1e-6)),
                ("library addcmul_",
                 lambda w, m, g: w.addcmul_(m, g, value=-1e-6))]
    return [("port kernel (wrapper)", lambda w, m, g: sgd_(w, g, 1e-6)),
            ("library add_", lambda w, m, g: w.add_(g, alpha=-1e-6))]


def leaf_table(var):
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    n = SHAPE[0] * SHAPE[1] * SHAPE[2]
    w = torch.randn(n, device=dev, generator=g)
    m = (torch.rand(n, device=dev, generator=g) < 0.5).float()
    gr = torch.randn(n, device=dev, generator=g)
    out = {}
    for masked, kind in KINDS:
        want = (ref.masked_sgd_ref(w.clone(), m, gr, 0.1) if masked
                else ref.sgd_ref(w.clone(), gr, 0.1))
        for label, design in LEAF_DESIGNS:
            got = var(masked, design, w.clone(), m, gr, 0.1)
            if not chip_smoke.bits_equal(got, want):
                raise RuntimeError(f"{kind} {label}: not bit-exact")
        designs = [(label, lambda d=design: var(masked, d, w, m, gr))
                   for label, design in LEAF_DESIGNS]
        designs += [(label, lambda fn=fn: fn(w, m, gr))
                    for label, fn in port_and_library(masked)]
        times = in_turns(designs)
        bound_ms = 1e3 * (16 if masked else 12) * n / chip_smoke.PEAK_BYTES
        print(f"[leaf] {kind} at {list(SHAPE)}: bound {bound_ms:.4f} ms "
              "(bytes); ms in listed order / reverse order")
        for label, t in times.items():
            print(f"[leaf] {kind:19s} {label:40s} {t[0]:.4f} / {t[1]:.4f} "
                  f"ms  {bound_ms / min(t):.3f} of bound")
        out[kind] = dict(bound_ms=bound_ms, times=times)
    return out


def in_round(var):
    """Each design as the client optimizer's kernel inside the full-width
    rounds: seconds per round (two rounds) and the update group's device
    time in one profiled round."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import api
    from repro_torch.kernels import masked_update
    from repro_torch.optim import client
    dev = torch.device("cuda")
    designs = [("port kernel", None)] + ROUND_DESIGNS + [
        ("port kernel again", None)]
    out = {}
    for masked, kind, scheme in ((1, "masked_sgd_inplace", "bernoulli"),
                                 (0, "sgd_inplace", "rolling")):
        _, model, data = chip_smoke.full_width(dev)
        fed = api.fed_round(model, chip_smoke.scfg_for(scheme), device=dev)
        trainer = api.Trainer(fed, model.init(seed=0, device=dev), rng=0)
        trainer.run(iter(data[:1]), 1)
        expected = fed.scfg.local_steps * len(trainer.params)
        rows = {}
        try:
            for label, design in designs:
                client.sgd_ = masked_update.sgd_
                client.masked_sgd_ = masked_update.masked_sgd_
                if design is not None and masked:
                    client.masked_sgd_ = (lambda w, m, g, lr, d=design:
                                          var(1, d, w, m, g, lr))
                elif design is not None:
                    client.sgd_ = (lambda w, g, lr, d=design:
                                   var(0, d, w, g, g, lr))
                secs = []
                for batch in data[1:]:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    trainer.run(iter([batch]), 1)
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    trainer.run(iter(data[:1]), 1)
                    torch.cuda.synchronize()
                kern, _ = chip_smoke.device_kernels(prof)
                upd = [(t, c) for name, t, c in kern if any(
                    k in name for k in ("variant_kernel", "bulk_kernel",
                                        "sgd_inplace_kernel",
                                        "masked_sgd_kernel"))]
                launches = sum(c for _, c in upd)
                # a profile that lost events holds fewer launches than the
                # round made: its group time is not a measurement
                group = (sum(t for t, _ in upd) if launches == expected
                         else None)
                rows[label] = dict(seconds=secs, group_ms=group,
                                   launches=launches)
                shown = (f"{group:.2f} ms" if group is not None else
                         f"not measured ({launches} of {expected} launches "
                         "in the profile)")
                print(f"[round] {kind:19s} {label:40s} s/round "
                      f"{secs[0]:.4f} {secs[1]:.4f}  update group {shown}")
        finally:
            client.sgd_ = masked_update.sgd_
            client.masked_sgd_ = masked_update.masked_sgd_
        out[kind] = rows
        del trainer, fed, model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "update_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("update_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False     # as chip_smoke.py
    lib, ptxas = build()
    print(ptxas)
    smi = chip_smoke.nvidia_smi()
    var = Variants(lib)
    report = {"card": smi, "shape": list(SHAPE)}
    for part in (leaf_table, in_round):
        report[part.__name__] = part(var)
        gc.collect()
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
