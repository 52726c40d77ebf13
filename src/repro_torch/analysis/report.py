"""Tables from the dry-run's JSONs (``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.analysis.report \
        [--dir experiments/dryrun_torch] [--world 16] [--param-dtype float32]

Ports ``dryrun_table``, ``roofline_table`` and ``collective_table`` of
``repro/analysis/report.py``, with its columns, keyed by the plan's
``world`` (ranks) and ``param_dtype`` instead of a mesh; the dry-run's
column reads "plan" (seconds to plan on meta) where the reference's reads
"compile", and a "fits" column says whether the peak fits one H100;
:func:`summary_table` sets each pair's f32 and bf16 plans side by side.
"""
from __future__ import annotations

import argparse
import glob
import json

from repro_torch.configs.base import INPUT_SHAPES


def fmt(x):
    if isinstance(x, float):
        return f"{x:.3g}"
    return str(x)


def load_all(d):
    rows = []
    for f in sorted(glob.glob(f"{d}/*.json")):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def _pick(rows, world, param_dtype):
    return [r for r in rows if (world is None or r["world"] == world)
            and (param_dtype is None or r["param_dtype"] == param_dtype)]


def dryrun_table(rows, world=16, param_dtype=None):
    out = ["| arch | shape | dtype | FLOPs/dev | HBM B/dev | coll B/dev | "
           "HBM/dev (GiB) | fits | plan |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in _pick(rows, world, param_dtype):
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['param_dtype']} | "
            f"{fmt(r['flops_per_dev'])} | {fmt(r['bytes_per_dev'])} | "
            f"{fmt(r['coll_bytes_per_dev'])} | "
            f"{r['per_device_hbm_gb']:.2f} | {'yes' if r['fits'] else 'no'} "
            f"| {r['plan_s']:.0f}s |")
    return "\n".join(out)


def roofline_table(rows, world=16, param_dtype=None):
    out = ["| arch | shape | dtype | t_comp (s) | t_mem (s) | t_coll (s) | "
           "bottleneck | step LB (s) | MODEL_FLOPS | useful |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in _pick(rows, world, param_dtype):
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['param_dtype']} | "
            f"{fmt(r['t_compute_s'])} | {fmt(r['t_memory_s'])} | "
            f"{fmt(r['t_collective_s'])} | **{r['bottleneck']}** | "
            f"{fmt(r['step_lb_s'])} | {fmt(r['model_flops'])} | "
            f"{r['useful_ratio']:.2f} |")
    return "\n".join(out)


def collective_table(rows, world=16, param_dtype=None):
    out = ["| arch | shape | dtype | all-gather | all-reduce | "
           "reduce-scatter | all-to-all | permute |",
           "|---|---|---|---|---|---|---|---|"]
    for r in _pick(rows, world, param_dtype):
        if not r["shape"].startswith("train"):
            continue
        c = r.get("collectives", {})
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['param_dtype']} | "
            f"{fmt(c.get('all-gather', 0))} | {fmt(c.get('all-reduce', 0))} "
            f"| {fmt(c.get('reduce-scatter', 0))} | "
            f"{fmt(c.get('all-to-all', 0))} | "
            f"{fmt(c.get('collective-permute', 0))} |")
    return "\n".join(out)


def summary_table(rows, world=16):
    """One row an architecture, a column an input shape; each cell the f32
    and bf16 plans side by side: the peak per device (GiB; "✗" where it
    does not fit one H100), the step's lower bound (s) and its bottleneck
    (c compute, m memory, x collective)."""
    by, shapes = {}, []
    for r in _pick(rows, world, None):
        by.setdefault(r["arch"], {}).setdefault(r["shape"], {})[
            r["param_dtype"]] = r
        if r["shape"] not in shapes:
            shapes.append(r["shape"])
    order = list(INPUT_SHAPES)
    shapes.sort(key=lambda sh: order.index(sh) if sh in order else len(order))
    out = ["| arch | " + " | ".join(shapes) + " |",
           "|---|" + "---|" * len(shapes)]

    def cell(pair):
        rs = [pair.get(d) for d in ("float32", "bfloat16")]
        hbm = " / ".join("-" if r is None else f"{r['per_device_hbm_gb']:.1f}"
                         for r in rs)
        fits = all(r is None or r["fits"] for r in rs)
        lb = " / ".join("-" if r is None else fmt(r["step_lb_s"]) for r in rs)
        neck = "/".join("-" if r is None else r["bottleneck"][0] for r in rs)
        return f"{hbm} GiB{'' if fits else ' ✗'}; {lb} s ({neck})"
    for arch, per in by.items():
        out.append(f"| {arch} | " + " | ".join(
            cell(per[sh]) if sh in per else "-" for sh in shapes) + " |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--world", type=int, default=16)
    ap.add_argument("--param-dtype", default=None,
                    help="float32 or bfloat16 (default: both)")
    args = ap.parse_args(argv)
    rows = load_all(args.dir)
    kw = dict(world=args.world, param_dtype=args.param_dtype)
    print("## Dry-run\n")
    print(dryrun_table(rows, **kw))
    print("\n## Roofline\n")
    print(roofline_table(rows, **kw))
    print("\n## Train collectives\n")
    print(collective_table(rows, **kw))
    print("\n## f32 and bf16 side by side\n")
    print(summary_table(rows, world=args.world))


if __name__ == "__main__":
    main()
