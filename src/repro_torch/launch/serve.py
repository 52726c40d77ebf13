"""Serving launcher: batched prefill, then greedy decode with KV/SSM caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_130m \\
        --reduced --batch 4 --prompt-len 32 --gen 16 --device cpu

Ports the batch engine of ``repro/launch/serve.py``: prefill the batch of
prompts (``launch.specs.sample_prompts``: codebook streams for the audio
model, and the vision stub's patches ahead of the tokens), then decode
greedily, one
``Model.decode_step`` per token, and print the prefill's time, the time per
decoded token and two rows of the generations.  There is no ``jit``: the
same prefill, argmax and decode loop run eagerly, timed to a
``torch.cuda.synchronize()`` on the card.  ``--engine continuous`` routes
a ragged request queue (``launch.specs.request_queue``) through the
slot-pool batcher (``launch.batching.ContinuousBatcher``, attention
families only), as the reference's ``_serve_continuous`` does.  Reduced
configs serve their MoE layers on the ``dense`` path, full ones on
``dropping``, as in the reference.  Runs on the card unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, get_reduced_config
from repro_torch.device import resolve_device
from repro_torch.launch.specs import request_queue, sample_prompts
from repro_torch.models import build_model


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, params, prompts, gen, return_logits=False, extra=None):
    """Greedy generation of ``gen`` tokens after ``prompts [B, S]`` (int, on
    the params' device; ``[B, S, CB]`` for codebook models), behind the
    vision stub's ``extra["patches"] [B, P, vision_d]`` if given: one
    prefill, then ``gen`` decode steps at positions ``P + S + i``, each fed
    the argmax of the logits before it (the reference's loop).  Returns a
    dict with ``tokens [B, gen]`` (``[B, gen, CB]``), ``prefill_s`` and
    ``decode_s`` (host seconds, each ending in a synchronize on the card)
    and, with ``return_logits``, ``logits``: the ``gen + 1`` logits ``[B,
    (CB,) V]`` of the prefill and of every decode step."""
    device = prompts.device
    B, S = prompts.shape[:2]
    P = (extra["patches"].shape[1] if extra is not None
         and "patches" in extra else 0)
    with torch.no_grad():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, prompts, extra,
                                      max_len=P + S + gen)
        tok = torch.argmax(logits, -1)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        kept = [logits] if return_logits else []
        toks = []
        t0 = time.perf_counter()
        for i in range(gen):
            toks.append(tok)
            logits, cache = model.decode_step(params, tok, cache, P + S + i)
            tok = torch.argmax(logits, -1)
            if return_logits:
                kept.append(logits)
        _sync(device)
        decode_s = time.perf_counter() - t0
    out = {"tokens": torch.stack(toks, dim=1), "prefill_s": prefill_s,
           "decode_s": decode_s}
    if return_logits:
        out["logits"] = kept
    return out


def _serve_continuous(model, params, args):
    from repro_torch.launch.batching import ContinuousBatcher
    lengths = [max(args.prompt_len + (i % 3) - 1, 1)
               for i in range(args.batch)]
    reqs = request_queue(model.cfg, lengths, max_new=args.gen,
                         seed=args.seed)
    eng = ContinuousBatcher(model, params, batch_slots=min(args.batch, 4),
                            max_len=max(lengths) + args.gen * args.batch + 8)
    for r in reqs:
        eng.submit(r)
    secs = eng.run()
    print(f"continuous: {eng.stats.completed} requests, "
          f"{eng.stats.tokens_generated} tokens in {secs * 1e3:.1f} ms "
          f"({eng.stats.prefills} prefills, {eng.stats.decode_steps} "
          "decode steps)")
    print("sample generations (first 2 requests):")
    print([r.out for r in reqs[:2]])
    return eng


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--engine", default="batch",
                    choices=["batch", "continuous"],
                    help="batch: one generation-level batch; continuous: "
                         "the slot-pool engine (attention families only)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    model = build_model(cfg, moe_path="dense" if args.reduced
                        else "dropping")
    params = model.init(args.seed, device=device)
    if args.engine == "continuous":
        return _serve_continuous(model, params, args)
    B, S, G = args.batch, args.prompt_len, args.gen
    prompts, extra = sample_prompts(cfg, B, S, seed=args.seed)
    prompts = torch.as_tensor(prompts, dtype=torch.long, device=device)
    if extra is not None:
        extra = {k: torch.as_tensor(v, device=device)
                 for k, v in extra.items()}
    out = generate(model, params, prompts, G, extra=extra)
    print(f"prefill: {out['prefill_s'] * 1e3:.1f} ms ({B}x{S} tokens, "
          f"{device.type})")
    print(f"decode : {out['decode_s'] / G * 1e3:.1f} ms/token ({G} steps, "
          f"batch {B})")
    print("sample generations (first 2 rows):")
    print(np.asarray(out["tokens"][:2].cpu()))


if __name__ == "__main__":
    main()
