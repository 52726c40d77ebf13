"""Dry-run: plan every (architecture x input shape) on ``meta`` and record
its FLOPs, bytes, collective bytes, peak memory and roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_14b \
        --shape train_4k [--world 16] [--multi-pod] \
        [--param-dtype float32,bfloat16] [--out experiments/dryrun_torch]

Ports ``step_fn``, ``run_one`` and ``main`` of ``repro/launch/dryrun.py``.
Where the reference lowers and compiles each step on a host mesh of 256
(512) placeholder devices and reads the compiled HLO, this runs one
rank's share of the step eagerly on ``meta`` tensors (nothing is
allocated, no kernel launches) under ``analysis.cost.Counter``, which
counts each aten op's FLOPs and bytes, the kernels' declared costs, the
collectives' ring-model bytes and the peak of live storage.  Train plans
rematerialise each layer (``make_plan``'s ``remat=True``, the
reference's), so their FLOPs hold the recomputed forwards while
``model_flops`` does not (``useful_ratio`` falls by their share), and
each record carries ``remat``.  Without
``--arch``/``--shape`` it sweeps ``list_archs()`` x ``INPUT_SHAPES``, one
JSON a pair under ``--out``; it exits 1 with the failures listed.
``python -m repro_torch.analysis.report`` renders the tables.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch

from repro_torch.analysis.cost import Counter
from repro_torch.analysis.roofline import Roofline, model_flops
from repro_torch.configs.base import INPUT_SHAPES, list_archs
from repro_torch.launch.specs import RUN_DTYPES, make_plan

GIB = 2 ** 30
#: one H100's 80 GiB, less what the plan cannot see: the CUDA context,
#: cuBLAS's workspaces and the caching allocator's rounding (the card
#: reports 79.6 GiB of its nominal 80)
CARD_GIB, RESERVE_GIB = 80.0, 3.0
NOTES = ("fsdp has no effect in the port: a rank holds whole params",
         "planned in the dtype it runs (param_dtype): no f32-to-bf16 byte "
         "scaling",
         "eager PyTorch: each aten op reads its inputs and writes its "
         "outputs (no fusion); kernels count their declared cost()")


def step_fn(plan):
    """The step one rank runs for ``plan``, called on
    ``plan.abstract_args``: a train plan steps a fed round with the round's
    offsets handed in (mask schemes draw their masks on meta; with a
    server optimizer, ``round_with_server_opt`` on the state in the
    arguments), a prefill
    plan prefills to ``seq_len``, a decode plan takes one decode step on
    caches from ``init_cache`` (context-parallel on ``long_500k``)."""
    model, shape = plan.model, plan.shape
    if plan.kind == "train":
        from repro_torch import api
        fed = api.fed_round(model, plan.scfg, mesh=plan.mesh,
                            mesh_agg=plan.mesh_agg, device="meta",
                            client_opt=plan.client_opt,
                            server_opt=plan.server_opt)

        def train_step(params, *args):
            kw = ({} if not hasattr(fed, "_client_offsets")     # mask mode
                  else {"offsets": fed._client_offsets(0, params)})
            if plan.server_opt is None:
                return fed.round(params, *args, 0, **kw)
            state, batch = args
            return fed.round_with_server_opt(params, state, batch, 0, **kw)

        return train_step
    if plan.kind == "prefill":
        def prefill_step(params, batch):
            extra = batch if "patches" in batch else None
            return model.prefill(params, batch["tokens"], extra,
                                 max_len=shape.seq_len)
        return prefill_step

    def serve_step(params, batch, cache, pos):
        return model.decode_step(params, batch["tokens"], cache, pos,
                                 mesh=plan.mesh if plan.cp else None,
                                 cp=plan.cp)

    return serve_step


def count(plan):
    """Run ``plan``'s step under a :class:`Counter`; returns the counter."""
    fn = step_fn(plan)
    grad = contextlib.nullcontext() if plan.kind == "train" else \
        torch.no_grad()
    with grad, Counter(args=plan.abstract_args, device="meta") as c:
        fn(*plan.abstract_args)
    return c


def tokens_of(plan):
    """Global tokens of one step: K x batch x seq (train), batch x seq
    (prefill), one a sequence (decode)."""
    shape = plan.shape
    if plan.kind == "train":
        return plan.scfg.local_steps * shape.global_batch * shape.seq_len, \
            "train"
    if plan.kind == "prefill":
        return shape.global_batch * shape.seq_len, "serve"
    return shape.global_batch, "serve"


def run_one(arch, shape_name, world=None, multi_pod=False, verbose=True,
            param_dtype=torch.float32, **plan_kw):
    t0 = time.time()
    plan = make_plan(arch, shape_name, world=world, multi_pod=multi_pod,
                     param_dtype=param_dtype, **plan_kw)
    c = count(plan)
    tokens, kind = tokens_of(plan)
    mflops = model_flops(plan.cfg, plan.model.abstract_params(), tokens,
                         kind)
    rl = Roofline(dict(c.flops_by_class), c.bytes, c.coll_bytes,
                  chips=plan.world, model_flops=mflops)
    peak = c.peak_bytes
    res = {"arch": arch, "shape": plan.shape.name, "world": plan.world,
           "multi_pod": multi_pod, "kind": plan.kind,
           "param_dtype": str(param_dtype).replace("torch.", ""),
           "capacity": plan.scfg.capacity, "scheme": plan.scfg.scheme,
           "remat": plan.model.remat,
           "clients_per_rank": plan.scfg.clients_per_round // plan.world}
    res.update(rl.row())
    res["collectives"] = dict(c.coll_by_kind)
    res["collective_counts"] = dict(c.coll_counts)
    res["kernels"] = dict(c.kernels)
    res["tokens"] = tokens
    res["argument_size_in_bytes"] = int(c.argument_bytes)
    res["temp_size_in_bytes"] = int(peak - c.argument_bytes)
    res["peak_bytes"] = int(peak)
    res["per_device_hbm_gb"] = peak / GIB
    res["fits"] = peak <= (CARD_GIB - RESERVE_GIB) * GIB
    res["notes"] = list(NOTES) + [
        f"one rank of {plan.world}: "
        + (f"{res['clients_per_rank']} of {plan.scfg.clients_per_round} "
           f"clients, {plan.mesh_agg} aggregation" if plan.kind == "train"
           else "S / world cache positions (context-parallel)" if plan.cp
           else "global_batch / world sequences (a replica)"),
        f"fits: peak <= {CARD_GIB:g} GiB less {RESERVE_GIB:g} GiB"]
    res["plan_s"] = round(time.time() - t0, 2)
    if verbose:
        print(f"[OK] {arch:20s} {plan.shape.name:12s} w{plan.world:<3d} "
              f"{res['param_dtype']:8s} flops/dev={rl.flops_per_dev:.3e} "
              f"bytes/dev={rl.bytes_per_dev:.3e} "
              f"coll/dev={rl.coll_bytes_per_dev:.3e} "
              f"hbm={res['per_device_hbm_gb']:.2f}GiB fits={res['fits']} "
              f"bneck={res['bottleneck']:10s} "
              f"useful={res['useful_ratio']:.2f} ({res['plan_s']:.1f}s)",
              flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: one client a rank, 16; 32 with "
                         "--multi-pod)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--param-dtype", default="float32",
                    help="float32, bfloat16, or both comma-separated")
    ap.add_argument("--capacity", type=float, default=None)
    ap.add_argument("--scheme", default="rolling")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    dtypes = args.param_dtype.split(",")
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for dt in dtypes:
                tag = (f"{arch}_{shape}_w{args.world or 'd'}"
                       f"{'_mp' if args.multi_pod else ''}_{dt}")
                try:
                    res = run_one(arch, shape, world=args.world,
                                  multi_pod=args.multi_pod,
                                  param_dtype=RUN_DTYPES[dt],
                                  capacity=args.capacity,
                                  scheme=args.scheme)
                    with open(os.path.join(args.out, tag + ".json"),
                              "w") as f:
                        json.dump(res, f, indent=1)
                except Exception as e:  # noqa: BLE001
                    failures.append((tag, repr(e)))
                    print(f"[FAIL] {tag}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print("\nAll dry-runs planned successfully.")


if __name__ == "__main__":
    main()
