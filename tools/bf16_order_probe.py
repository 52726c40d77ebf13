#!/usr/bin/env python3
"""How far two correct summation orders carry the full-width bf16 rounds
apart.

    python3 tools/bf16_order_probe.py

Full-width TinyLlama-1.1B in ``chip_smoke.py``'s window configuration (C =
4 x K = 2 x 2 x 256 tokens, rolling at 0.5, client lr 0.1), from the same
params, batches and offsets: the fused rounds (the bf16 kernels) against
the extract rounds (cuBLAS bf16), against the fused rounds again (the run
is deterministic), and against fused rounds whose ``models.layers.bmm``
products take operands widened to f32 (the same sums in another order,
each still rounded once); the same after one round of one client step;
and the f32 extract rounds against the f32 fused rounds.  Each line is
``chip_smoke.bf16_change_stats``: the gap ``|a - b| / |b - p0|``, the
cosine of the two changes from the start and their norm ratio, over all
leaves and the span over the leaves moved in 1000 elements or more.
``chip_smoke.py``'s ``[bf16 extract]`` limits come from these readings.
Needs one CUDA card.
"""
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.kernels import _build
    from repro_torch.models import layers
    if not torch.cuda.is_available():
        print("bf16_order_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.nvidia_smi())
    cs.phase_build(_build)

    def rounds(model, p0, data, offsets, ff, steps=2):
        scfg = dataclasses.replace(cs.scfg_for("rolling"), local_steps=steps)
        fed = api.fed_round(model, scfg, fused_forward=ff, device=dev)
        t = api.Trainer(fed, {k: v.to(dev, copy=True) for k, v in p0.items()})
        t.run([(b, {"offsets": o}) for b, o in zip(data, offsets)], len(data))
        return {k: v.cpu() for k, v in t.params.items()}

    def show(tag, a, b, p0):
        st = cs.bf16_change_stats(a, b, p0)
        print(f"[bf16 order] {tag}: gap {st['gap'][0]:.4f} (leaves "
              f"{st['gap'][1]:.4f}-{st['gap'][2]:.4f}), cosine "
              f"{st['cos'][0]:.4f} ({st['cos'][1]:.4f}-{st['cos'][2]:.4f}), "
              f"norm ratio {st['ratio'][0]:.4f} ({st['ratio'][1]:.4f}-"
              f"{st['ratio'][2]:.4f})")

    for dt in (torch.bfloat16, torch.float32):
        cfg, model, data = cs.full_width(dev, param_dtype=dt)
        p0 = {k: v.cpu() for k, v in model.init(seed=0, device=dev).items()}
        fed = api.fed_round(model, cs.scfg_for("rolling"), device=dev)
        offsets = [fed.scheme.offsets(r, 4) for r in range(len(data))]
        name = str(dt).split(".")[-1]
        fused = rounds(model, p0, data, offsets, "on")
        show(f"{name} extract vs fused, 3 rounds",
             rounds(model, p0, data, offsets, "off"), fused, p0)
        if dt == torch.bfloat16:
            show("bfloat16 fused again vs fused, 3 rounds",
                 rounds(model, p0, data, offsets, "on"), fused, p0)
            wide = layers._wide
            layers._wide = lambda t: t.float() if t.dtype == dt else t
            try:
                other = rounds(model, p0, data, offsets, "on")
            finally:
                layers._wide = wide
            show("bfloat16 fused, bmm on widened operands, vs fused, 3 "
                 "rounds", other, fused, p0)
            show("bfloat16 extract vs fused, 1 round of 1 step",
                 rounds(model, p0, data[:1], offsets, "off", 1),
                 rounds(model, p0, data[:1], offsets, "on", 1), p0)
        del model, p0, fused
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
