"""Training launcher: federated sub-model training through ``repro_torch.api``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \\
        --reduced --rounds 3 --scheme rolling --capacity 0.5 --device cpu \\
        [--stagger --client-opt momentum --server-opt adam \\
         --uplink-compression bf16] [--async-buffer 2 --fleet 8 \\
         --straggler-frac 0.25] [--mesh 2 --mesh-agg psum --devices 2]
    # the mesh round on four cards, a rank each (NCCL)
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch tinyllama_1_1b --mesh 4

Ports the flags of ``repro/launch/train.py``: it builds the
model (random weights from ``--seed``), the round (``api.fed_round``) and
``api.Trainer`` (or, with ``--async-buffer M``, ``api.AsyncTrainer`` over
a ``FleetSimulator`` of ``--fleet`` clients with the latency flags),
trains on the port's ``data.synthetic.lm_batches``
(``--local-steps`` x ``--clients`` x ``--mb`` sequences of ``--seq``
tokens a round, with the codebook streams and the vision stub's patches
of the architectures that take them), logs ``round N loss ...`` with the
seconds per round every ``--log-every`` rounds, optionally saves a
checkpoint in the reference's layout (``--ckpt``), and prints the
reference's final JSON,
``{"first_loss": ..., "last_loss": ...}`` (the async run adds
``virtual_time``, ``rounds_per_vsec`` and ``mean_staleness``).  MoE
layers take the ``dense`` path on reduced configs and ``dropping`` on
full ones, as in the reference.  Runs on
the card unless ``--device cpu`` is given.  ``--mesh DATA[xMODEL]``
splits the clients over the ``data`` axis of a mesh of
``torch.distributed`` ranks (``--mesh-agg`` crosses them): under
``torchrun`` the ranks are its processes, a card each; without it a world
of one rank; with ``--devices N`` (on the CPU) the CLI starts N local
gloo ranks itself (``launch.mesh.spawn``).  Every rank trains, rank 0
alone prints the round lines and the record.  The reference's
``--kernel-backend``, ``--kernel-block`` and ``--layer-unroll`` have no
counterpart (the port has no backend knob, its kernels pick their tiles,
and it runs eagerly).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import api
from repro_torch.checkpoint.checkpoint import is_writer
from repro_torch.checkpoint.checkpoint import save as ckpt_save
from repro_torch.configs.base import (SubmodelConfig, get_config,
                                      get_reduced_config)
from repro_torch.data.synthetic import lm_batches
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import build_model


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--scheme", default="rolling",
                    choices=["rolling", "random", "static", "full",
                             "bernoulli", "importance"])
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "window", "mask"],
                    help="round form: auto derives it from the scheme "
                         "(bernoulli -> mask, else window)")
    ap.add_argument("--fused-forward", default="auto",
                    choices=["auto", "on", "off"],
                    help="window mode: the fused client phase (full copies "
                         "through the window-aware forward) where every "
                         "windowed axis has one, 'on' forces it, 'off' "
                         "takes the extract phase (compact copies)")
    ap.add_argument("--uplink-compression", default=None, choices=["bf16"],
                    help="window mode: round each client delta to bf16 on "
                         "the simulated uplink (the fused phase's "
                         "aggregation, as in the reference)")
    ap.add_argument("--client-opt", default="sgd",
                    choices=sorted(api.CLIENT_OPTS),
                    help="local-step optimizer (paper: sgd)")
    ap.add_argument("--server-opt", default="none",
                    choices=["none"] + sorted(api.SERVER_OPTS),
                    help="server optimizer on the mean delta (paper: none "
                         "= plain averaging)")
    ap.add_argument("--no-shared-window", action="store_true",
                    help="force the per-client aggregation even when every "
                         "client trains the same window")
    ap.add_argument("--axes", nargs="+", default=None,
                    help="semantic axes to window (default: the "
                         "SubmodelConfig default tuple)")
    ap.add_argument("--stagger", action="store_true",
                    help="rotate the rolling/importance window per client")
    ap.add_argument("--capacity", type=float, default=0.5)
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--mb", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None, metavar="DATA[xMODEL]",
                    help="split the clients over the data axis of a "
                         "(data, model) mesh of torch.distributed ranks, "
                         "e.g. '4' or '4x2'; --clients must be divisible "
                         "by DATA")
    ap.add_argument("--mesh-agg", default="gather",
                    choices=["gather", "psum"],
                    help="crossing ranks: gather is the single-process "
                         "round bit for bit; psum adds model-sized sums")
    ap.add_argument("--devices", type=int, default=None, metavar="N",
                    help="start N local gloo ranks on the CPU for --mesh "
                         "(on cards run under torchrun --nproc-per-node N)")
    ap.add_argument("--async-buffer", type=int, default=0, metavar="M",
                    help="run the async FedBuff server (api.AsyncTrainer), "
                         "aggregating every M client reports; 0 = the "
                         "synchronous Trainer")
    ap.add_argument("--fleet", type=int, default=0,
                    help="virtual fleet size for --async-buffer (0 = "
                         "--clients)")
    ap.add_argument("--straggler-frac", type=float, default=0.0,
                    help="fraction of the fleet running "
                         "--straggler-mult x slower")
    ap.add_argument("--straggler-mult", type=float, default=10.0)
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="per-dispatch client fault probability")
    ap.add_argument("--timeout", type=float, default=None,
                    help="virtual seconds before a slot abandons its "
                         "client and redispatches")
    ap.add_argument("--staleness-policy", default="inverse_sqrt",
                    choices=sorted(api.STALENESS_POLICIES),
                    help="weight w(tau) on a delta computed tau rounds "
                         "ago (w(0)=1)")
    ap.add_argument("--server-lr-schedule", default="constant",
                    choices=sorted(api.SERVER_LR_SCHEDULES),
                    help="server stepsize multiplier per round")
    return ap


def main(argv=None):
    """Run the CLI on ``argv``; returns the final record it prints (rank
    0's, with ``--devices``)."""
    args = parser().parse_args(argv)
    if args.async_buffer and args.mesh:
        raise SystemExit("--async-buffer owns the client axis; drop --mesh")
    if args.devices:
        if torch.device(args.device).type != "cpu":
            raise SystemExit("--devices N starts CPU ranks; on cards run "
                             "torchrun --nproc-per-node N -m "
                             "repro_torch.launch.train ... --mesh N")
        if not args.mesh:
            raise SystemExit("--devices N starts the ranks of a --mesh; "
                             "add --mesh")
        return mesh_lib.spawn(_train, args.devices, args,
                              threads=max(1, torch.get_num_threads()
                                          // args.devices))
    return _train(args)


def _train(args):
    """The training run of one process (one rank of a mesh)."""
    resolve_device(args.device)      # raises without a card
    end_world = mesh_lib.init_world(args.device) if args.mesh else None
    try:
        # after init_world, which puts a torchrun rank on cuda:LOCAL_RANK
        return _run(args, resolve_device(args.device))
    finally:
        if end_world is not None:
            end_world()


def _run(args, device):
    mesh = mesh_lib.host_mesh(args.mesh) if args.mesh else None
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    model = build_model(cfg, moe_path="dense" if args.reduced
                        else "dropping")
    params = model.init(args.seed, device=device)
    axes_kw = {"axes": tuple(args.axes)} if args.axes else {}
    scfg = SubmodelConfig(scheme=args.scheme, capacity=args.capacity,
                          local_steps=args.local_steps,
                          clients_per_round=args.clients,
                          client_lr=args.lr, seed=args.seed,
                          stagger=args.stagger,
                          shared_window=False if args.no_shared_window
                          else None, **axes_kw)
    fed = api.fed_round(model, scfg, mode=args.mode,
                        client_opt=args.client_opt,
                        server_opt=args.server_opt,
                        fused_forward=args.fused_forward,
                        uplink_compression=args.uplink_compression,
                        mesh=mesh, mesh_agg=args.mesh_agg, device=device)
    vision = (cfg.vision_patches, cfg.vision_d) if cfg.vision_stub else None
    it = lm_batches(cfg.vocab, (args.local_steps, args.clients, args.mb),
                    args.seq, seed=args.seed, codebooks=cfg.n_codebooks,
                    vision=vision)
    t0 = time.time()

    def log(s):       # the trainers log on rank 0 alone
        print(f"{s} ({(time.time() - t0) / (trainer.round_idx or 1):.2f}"
              "s/round)", flush=True)

    if args.async_buffer:
        fleet = api.FleetSimulator(
            args.fleet or args.clients,
            api.LatencyModel(straggler_frac=args.straggler_frac,
                             straggler_mult=args.straggler_mult,
                             dropout=args.dropout, timeout=args.timeout,
                             seed=args.seed))
        trainer = api.AsyncTrainer(
            fed, params, rng=args.seed + 1, buffer_size=args.async_buffer,
            fleet=fleet, staleness=args.staleness_policy,
            server_lr_schedule=args.server_lr_schedule,
            log_every=args.log_every, log_fn=log)
    else:
        trainer = api.Trainer(fed, params, rng=args.seed + 1,
                              log_every=args.log_every, log_fn=log)
    params, history = trainer.run(it, args.rounds)
    losses = trainer.losses
    if args.ckpt:
        ckpt_save(args.ckpt, params,
                  {"arch": args.arch, "rounds": args.rounds,
                   "scheme": args.scheme, "history": losses})
        if is_writer():
            print("checkpoint ->", args.ckpt)
    out = {"first_loss": losses[0], "last_loss": losses[-1]}
    if args.async_buffer:
        vt = history[-1]["virtual_time"]
        out.update(virtual_time=vt,
                   rounds_per_vsec=round(args.rounds / vt, 4) if vt else None,
                   mean_staleness=round(
                       sum(h["staleness"] for h in history) / len(history),
                       3))
    if is_writer():
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
