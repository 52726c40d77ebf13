#!/usr/bin/env python3
"""Plan each of ``chip_smoke.py``'s cut rounds on ``meta``, at its cut and
at its whole depth: the planned peak of each, and whether the whole one
fits one H100 (``launch.dryrun``'s rule: 80 GiB less 3).

    PYTHONPATH=src python3 tools/plan_cuts.py [--only TAG,...]

Each row is a round path ``chip_smoke.py`` runs at a cut depth (its
``run_rounds`` tag, the path's architecture, clients, tokens and
optimizers, as the script builds them); the script's own
``[<tag>] peak memory allocated`` lines give the measured peak beside the
planned one.  Runs on the CPU; nothing is allocated.
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_config  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402

BF = torch.bfloat16
F32 = torch.float32


def cuts():
    """``(tag, arch, cut layers, config overrides, clients, tokens a
    sequence, dtype, scfg, fed_round keywords)`` of each cut round."""
    out = [("hybrid round", "hymba_1_5b", cs.HYB_LAYERS, {}, 4, cs.HYB_SEQ,
            F32, cs.slice_scfg(client_lr=cs.ROUND_LR), {}),
           (f"mask opt {cs.MASK_OPT_LAYERS}L momentum", "tinyllama_1_1b",
            cs.MASK_OPT_LAYERS, {}, 4, 256, F32, cs.scfg_for("bernoulli"),
            {"client_opt": "momentum"})]
    for tag, arch, layers, clients, _, _ in cs.ZOO_ROUNDS:
        out.append((tag, arch, layers, {}, clients, cs.ZOO_SEQ, F32,
                    cs.slice_scfg(clients_per_round=clients), {}))
    for tag, arch, layers, clients, _, _, over in cs.NEW_ROUNDS:
        out.append((tag, arch, layers, over, clients, cs.ZOO_SEQ, F32,
                    cs.slice_scfg(clients_per_round=clients), {}))
    for tag, arch, layers, clients, _, _, over, _ in cs.BF16_ZOO_ROUNDS:
        out.append((tag, arch, layers, over, clients, cs.ZOO_SEQ, BF,
                    cs.slice_scfg(clients_per_round=clients), {}))
    out.append(("bf16 hybrid round", "hymba_1_5b", cs.HYB_LAYERS, {}, 4,
                cs.HYB_SEQ, BF, cs.slice_scfg(client_lr=0.01), {}))
    return out


def plan_peak(arch, cfg, clients, seq, dtype, scfg, kw):
    """The planned peak (bytes) of one round of ``cfg`` (the cut, or the
    published config: its whole depth): ``clients`` x 2 sequences of
    ``seq`` tokens (the vision stub's patches come on top, as
    ``lm_batches`` gives them)."""
    if cfg.vision_stub:
        seq += cfg.vision_patches
    plan = specs.make_plan(arch, ShapeConfig("cut", seq, 2 * clients,
                                             "train"),
                           world=1, cfg=cfg, scfg=scfg, param_dtype=dtype,
                           **kw)
    return dryrun.count(plan).peak_bytes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="")
    args = ap.parse_args(argv)
    only = {t for t in args.only.split(",") if t}
    room = (dryrun.CARD_GIB - dryrun.RESERVE_GIB) * 2 ** 30
    print("| path | cut | planned peak at the cut (GiB) | whole depth | "
          "planned peak whole (GiB) | whole fits |")
    print("|---|---|---|---|---|---|")
    for tag, arch, layers, over, clients, seq, dtype, scfg, kw in cuts():
        if only and tag not in only:
            continue
        t0 = time.time()
        whole = get_config(arch)
        cut = dataclasses.replace(whole, n_layers=layers, **over)
        p_cut = plan_peak(arch, cut, clients, seq, dtype, scfg, kw)
        p_full = plan_peak(arch, whole, clients, seq, dtype, scfg, kw)
        print(f"| {tag} | {layers} of {whole.n_layers} | "
              f"{p_cut / 2**30:.2f} | {whole.n_layers} | "
              f"{p_full / 2**30:.2f} | "
              f"{'yes' if p_full <= room else 'no'} |", flush=True)
        print(f"  ({tag}: planned in {time.time() - t0:.1f} s)",
              file=sys.stderr)


if __name__ == "__main__":
    main()
