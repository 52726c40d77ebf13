#!/usr/bin/env python3
"""What ``torch.distributed`` takes on one card: two local ranks (a gloo
world through ``repro_torch.launch.mesh.spawn``) both on ``cuda:0`` try
gloo's ``all_gather`` and ``all_reduce`` (SUM, MAX) on CUDA tensors, then
an NCCL group over the same two ranks (NCCL takes one rank a device).
Prints each collective's result or its error text.

    python3 tools/mesh_probe.py
"""
import json
import sys
from datetime import timedelta
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def probe():
    import torch.distributed as dist
    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.full((1024,), float(rank + 1), device="cuda")
    out = {}

    def attempt(name, fn):
        try:
            out[name] = fn()
            torch.cuda.synchronize()
        except Exception as e:      # the probe reports what was refused
            out[name] = f"refused: {type(e).__name__}: {e}"[:2000]

    def gather():
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return [p[0].item() for p in parts]

    def reduce(op):
        y = x.clone()
        dist.all_reduce(y, op=op)
        return y[0].item()

    attempt("gloo all_gather (cuda)", gather)
    attempt("gloo all_reduce SUM (cuda)", lambda: reduce(dist.ReduceOp.SUM))
    attempt("gloo all_reduce MAX (cuda)", lambda: reduce(dist.ReduceOp.MAX))

    def nccl():
        group = dist.new_group(backend="nccl", timeout=timedelta(seconds=60))
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y[0].item()

    attempt("nccl all_reduce, both ranks on cuda:0", nccl)
    return out


def main():
    from repro_torch.launch.mesh import spawn
    if not torch.cuda.is_available():
        print("mesh_probe: no CUDA device", file=sys.stderr)
        return 2
    print(f"[probe] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__} cuda {torch.version.cuda} nccl "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}")
    print(json.dumps(spawn(probe, 2), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
