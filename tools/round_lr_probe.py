#!/usr/bin/env python3
"""Run the full-width SSM and hybrid rounds of ``chip_smoke.py`` at other
client learning rates.

    python3 tools/round_lr_probe.py [--lr 0.01 0.003 0.001] [--bf16]

Builds the port's kernels, then runs ``chip_smoke.phase_slice_rounds``
(3 fused rounds, a profiled round, 3 fused rounds from params scaled by
1 + 1e-7 N(0, 1), 3 extract rounds) once for each learning rate on
full-width Mamba2-130M and Hymba-1.5B, and prints ``OK`` or ``FAIL``
after the phase's own lines.  Its ``[... extract] vs the fused rounds``
line says how far rounding alone carries the rounds at that rate: use it
to choose ``chip_smoke.ROUND_LR``.  With ``--bf16`` it runs
``chip_smoke.phase_bf16_slice_rounds`` instead (bf16 params; Hymba at
``chip_smoke.HYB_LAYERS`` layers, as the script runs it), whose ``[...
extract]`` line gives the cosine and norm ratios of the extract rounds'
change against the fused rounds': use it to choose
``chip_smoke.BF16_SLICE_LR``.  Needs one CUDA card.  Exits 1 if any run
failed.
"""
import argparse
import gc
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = {"mamba2_130m": "ssm round", "hymba_1_5b": "hybrid round"}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lr", type=float, nargs="+", default=[0.01, 0.003,
                                                           0.001])
    ap.add_argument("--bf16", action="store_true",
                    help="the bf16 rounds (phase_bf16_slice_rounds)")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("round_lr_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.nvidia_smi())
    cs.phase_build(_build)
    failed = 0
    for lr in args.lr:
        for arch, tag in ARCHS.items():
            cs.ROUND_LR = lr
            seq = cs.SSM_SEQ if arch == "mamba2_130m" else cs.HYB_SEQ
            try:
                if args.bf16:
                    cs.phase_bf16_slice_rounds(
                        dev, _build, f"bf16 {tag} lr {lr}", arch, seq,
                        None if arch == "mamba2_130m" else cs.HYB_LAYERS,
                        lr=lr)
                else:
                    cs.phase_slice_rounds(dev, _build, f"{tag} lr {lr}",
                                          arch, seq)
                print(f"OK {arch} lr {lr}")
            except RuntimeError:
                traceback.print_exc()
                print(f"FAIL {arch} lr {lr}")
                failed += 1
            gc.collect()
            torch.cuda.empty_cache()
    return int(failed > 0)


if __name__ == "__main__":
    sys.exit(main())
