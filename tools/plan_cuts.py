#!/usr/bin/env python3
"""Plan each of ``chip_smoke.py``'s rounds that a card's memory or the
script's time shapes, on ``meta``: as the script runs it (its depth and
its ``remat``) and at its whole depth without and with rematerialisation
(``Model.remat``), and whether the whole one fits one H100
(``launch.dryrun``'s rule: 80 GiB less 3).

    PYTHONPATH=src python3 tools/plan_cuts.py [--only TAG,...]

Each row is a round path ``chip_smoke.py`` runs (its ``run_rounds`` tag,
the path's architecture, clients, sequences, tokens, optimizers and
``remat``, as the script builds them): the rounds cut in depth, and the
two that remat lets run whole (the momentum mask round, ``[remat]``'s
``train_4k`` round).  The script's own ``[<tag>] peak memory allocated``
lines give the measured peak beside the planned one.  Runs on the CPU;
nothing is allocated.
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
    """``(tag, arch, layers run, config overrides, sequences a step,
    tokens a sequence, dtype, scfg, fed_round keywords, remat)`` of each
    round: two sequences a client but in ``train_4k``."""
    C = 4
    out = [("hybrid round", "hymba_1_5b", cs.HYB_LAYERS, {}, 2 * C,
            cs.HYB_SEQ, F32, cs.slice_scfg(client_lr=cs.ROUND_LR), {},
            False),
           ("mask opt momentum", "tinyllama_1_1b", 22, {}, 2 * C, 256, F32,
            cs.scfg_for("bernoulli"), {"client_opt": "momentum"}, True),
           (f"mask opt {cs.MASK_OPT_LAYERS}L momentum+adam",
            "tinyllama_1_1b", cs.MASK_OPT_LAYERS, {}, 2 * C, 256, F32,
            cs.scfg_for("bernoulli"),
            {"client_opt": "momentum", "server_opt": "adam"}, False),
           ("train_4k", "tinyllama_1_1b", 22, {}, cs.TRAIN_4K_SEQS,
            cs.TRAIN_4K_SEQ, F32, cs.train_4k_scfg(), {}, True)]
    for tag, arch, layers, clients, _, _ in cs.ZOO_ROUNDS:
        out.append((tag, arch, layers, {}, 2 * clients, cs.ZOO_SEQ, F32,
                    cs.slice_scfg(clients_per_round=clients), {}, False))
    for tag, arch, layers, clients, _, _, over in cs.NEW_ROUNDS:
        out.append((tag, arch, layers, over, 2 * clients, cs.ZOO_SEQ, F32,
                    cs.slice_scfg(clients_per_round=clients), {}, False))
    for tag, arch, layers, clients, _, _, over, _ in cs.BF16_ZOO_ROUNDS:
        out.append((tag, arch, layers, over, 2 * clients, cs.ZOO_SEQ, BF,
                    cs.slice_scfg(clients_per_round=clients), {}, False))
    out.append(("bf16 hybrid round", "hymba_1_5b", cs.HYB_LAYERS, {}, 2 * C,
                cs.HYB_SEQ, BF, cs.slice_scfg(client_lr=0.01), {}, False))
    return out


def plan_peak(arch, cfg, seqs, seq, dtype, scfg, kw, remat):
    """The planned peak (bytes) of one round of ``cfg`` (as the script
    runs it, or the published config: its whole depth): ``seqs``
    sequences of ``seq`` tokens a client step (the vision stub's patches
    come on top, as ``lm_batches`` gives them)."""
    if cfg.vision_stub:
        seq += cfg.vision_patches
    plan = specs.make_plan(arch, ShapeConfig("cut", seq, seqs, "train"),
                           world=1, cfg=cfg, scfg=scfg, param_dtype=dtype,
                           remat=remat, **kw)
    return dryrun.count(plan).peak_bytes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="")
    args = ap.parse_args(argv)
    only = {t for t in args.only.split(",") if t}
    room = (dryrun.CARD_GIB - dryrun.RESERVE_GIB) * 2 ** 30
    print("| path | runs at | remat | planned peak as it runs (GiB) | "
          "planned peak whole (GiB) | whole with remat (GiB) | whole fits "
          "with remat |")
    print("|---|---|---|---|---|---|---|")
    for (tag, arch, layers, over, seqs, seq, dtype, scfg, kw,
         remat) in cuts():
        if only and tag not in only:
            continue
        t0 = time.time()
        whole = get_config(arch)
        cut = dataclasses.replace(whole, n_layers=layers, **over)
        args = (seqs, seq, dtype, scfg, kw)
        p_cut = plan_peak(arch, cut, *args, remat)
        p_full, p_remat = (plan_peak(arch, whole, *args, r)
                           for r in (False, True))
        print(f"| {tag} | {layers} of {whole.n_layers} | "
              f"{'on' if remat else 'off'} | {p_cut / 2**30:.2f} | "
              f"{p_full / 2**30:.2f} | {p_remat / 2**30:.2f} | "
              f"{'yes' if p_remat <= room else 'no'} |", flush=True)
        print(f"  ({tag}: planned in {time.time() - t0:.1f} s)",
              file=sys.stderr)


if __name__ == "__main__":
    main()
