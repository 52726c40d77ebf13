"""End-to-end driver on the PyTorch port: federated sub-model training of a
language model for a few hundred rounds, with eval, checkpointing, and
resume, all through the ``repro_torch.api`` facade (``fed_round`` +
``Trainer``), as ``examples/train_lm_e2e.py`` runs it in the JAX package.

    PYTHONPATH=src python examples/train_lm_e2e_torch.py [--rounds 200]
        [--resume ckpt.npz] [--device cpu]

A ~5M-param TinyLlama-family model trained with rolling sub-model windows,
capacity 0.5, 8 clients x 2 local steps, on synthetic bigram data whose
optimal loss is well below ln(V), so the curve meaningfully converges.
The rounds run on the card unless ``--device cpu``; the checkpoint is in
the reference's layout, so either package resumes it.
"""
import argparse
import time
from dataclasses import replace

import torch

from repro_torch import api
from repro_torch.checkpoint.checkpoint import load as ckpt_load
from repro_torch.checkpoint.checkpoint import save as ckpt_save
from repro_torch.configs.base import SubmodelConfig, get_reduced_config
from repro_torch.data.synthetic import lm_batches
from repro_torch.models import build_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--ckpt", default="experiments/lm_e2e_torch.npz")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = replace(get_reduced_config("tinyllama_1_1b"),
                  n_layers=2, d_model=128, d_ff=256, vocab=256,
                  n_heads=4, n_kv_heads=2, head_dim=32)
    model = build_model(cfg, remat=False)
    params = model.init(0, device=args.device)
    start = 0
    if args.resume:
        params, meta = ckpt_load(args.resume, device=args.device)
        start = int(meta.get("round", 0))
        print(f"resumed from {args.resume} at round {start}")

    scfg = SubmodelConfig(scheme="rolling", capacity=0.5, local_steps=2,
                          clients_per_round=8, client_lr=0.2,
                          axes=("d_ff", "heads", "kv_heads"))
    fed = api.fed_round(model, scfg, device=args.device)

    it = lm_batches(cfg.vocab, (2, 8, 2), args.seq, seed=1)
    eval_batch = {"tokens": torch.as_tensor(
        next(lm_batches(cfg.vocab, (16,), args.seq, seed=999))["tokens"],
        device=fed.device)}

    t0 = time.time()

    def log(s):
        per = (time.time() - t0) / max(trainer.round_idx - start, 1)
        print(f"{s}  ({per:.2f}s/round)", flush=True)

    trainer = api.Trainer(
        fed, params, rng=1,
        eval_fn=lambda p: {"eval": float(model.loss(p, eval_batch)[0])},
        eval_every=20, log_every=20, log_fn=log, start_round=start)
    params, _ = trainer.run(it, args.rounds)
    ckpt_save(args.ckpt, params, {"round": start + args.rounds,
                                  "arch": cfg.name})
    print("checkpoint ->", args.ckpt)


if __name__ == "__main__":
    main()
