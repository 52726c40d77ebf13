"""Batched serving demo on the PyTorch port: prefill + autoregressive decode
with KV/SSM caches across three model families (attention, SSM, hybrid).
The twin of ``examples/serve_demo.py``.

    PYTHONPATH=src python examples/serve_demo_torch.py [--device cpu]

Each family is the reduced config with random weights, served by
``python -m repro_torch.launch.serve`` (on the card unless ``--device
cpu``).
"""
import argparse

from repro_torch.launch import serve

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
for arch in ("tinyllama_1_1b", "mamba2_130m", "hymba_1_5b"):
    print(f"\n=== {arch} ===", flush=True)
    serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
                "16", "--gen", "8", "--device", args.device])
