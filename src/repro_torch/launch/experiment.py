"""Paper-protocol experiment runner, the port's results-book generator.

    PYTHONPATH=src python -m repro_torch.launch.experiment --rounds 3
    PYTHONPATH=src python -m repro_torch.launch.experiment --device cpu \
        --rounds 1

Ports ``SCHEMES``, ``PARTITIONS``, ``emit``, ``write_results``,
``metric_names``, the three tracks and the CLI of
``repro/launch/experiment.py``; the CLI has the reference's flags plus
``--device`` (default ``cuda``).  One command reproduces the paper's two
headline claims end to end and merges its records into the ``--out`` JSON
file (``paper_protocol`` section, the keys of :func:`metric_names`, which
``docs/experiments.md`` documents; by default the port's own artifact,
:data:`RESULTS_PATH`: the reference's ``experiments/bench_results.json``
belongs to ``benchmarks/run.py``):

* **convergence**: ``scheme in {shuffled, random, static} x partition in
  {iid, dirichlet, label} x capacity mix`` through the paper's §5.1
  protocol (:class:`repro_torch.core.paper_protocol.PaperExperiment`);
  ``shuffled`` is the paper's shuffled-rolling scheme (Algorithm 2).
* **stability**: perturb-one-sample twin runs per scheme
  (:func:`repro_torch.core.stability.stability_experiment`, Definition 4):
  E||A(S) - A(S')|| on neighbouring datasets, which Theorem 5 bounds.
* **theory**: the excess suboptimality of masked training on the
  closed-form quadratic problem against the Theorem 1 residual bound
  (:mod:`repro_torch.core.theory`).

The losses of the stability and theory tracks take ``[C, ...]`` leaves,
as every loss of the port's rounds does.  The rolling order and the
Bernoulli draws are torch's, not ``jax.random``'s, so the curves are
other samples of the same experiment than the reference's.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

SCHEMES = ("shuffled", "random", "static")
PARTITIONS = ("iid", "dirichlet")      # sweep default; "label" also valid
SECTION = "paper_protocol"
#: the port's results artifact, beside the reference's
#: ``experiments/bench_results.json``, which this CLI never writes unless
#: ``--out`` names it
RESULTS_PATH = "experiments/bench_results_torch.json"

# paper name used by PaperExperiment (its SCHEME_MAP then resolves the
# SubmodelConfig scheme: random -> unstructured Bernoulli masks)
_TO_PAPER = {"shuffled": "rolling", "random": "random", "static": "static"}
# SubmodelConfig scheme for the mask-mode stability twins
_TO_SCFG = {"shuffled": "rolling", "random": "bernoulli", "static": "static"}

RESULTS: dict = {}


def emit(metric, value, section=SECTION):
    RESULTS.setdefault(section, {})[metric] = value
    shown = f"[{len(value)} rows]" if isinstance(value, list) else value
    print(f"{section},{metric},{shown}", flush=True)


def write_results(path):
    """Merge-on-write into the results file: keep other sections, update
    ours."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    out = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                out = json.load(f)
        except (json.JSONDecodeError, OSError):
            out = {}
    for name, metrics in RESULTS.items():
        out.setdefault(name, {}).update(metrics)
    with open(path, "w") as f:
        json.dump(out, f, indent=1, default=str)
    return path


def metric_names(schemes=SCHEMES, partitions=PARTITIONS):
    """The exact record keys one run emits into the ``paper_protocol``
    section (the reference's, which ``docs/experiments.md`` documents)."""
    names = ["rounds", "schemes", "partitions", "capacity_mix"]
    for s in schemes:
        for p in partitions:
            names += [f"{s}_{p}_final_loss", f"{s}_{p}_final_acc",
                      f"{s}_{p}_curve"]
        names += [f"{s}_final_loss", f"{s}_stability_distance"]
    if "shuffled" in schemes and "random" in schemes:
        names.append("shuffled_beats_random")
    names += ["stability_finite", "thm1_excess", "thm1_bound",
              "thm1_bound_holds"]
    return names


# ---------------------------------------------------------------------------
# Track 1: convergence sweep (Theorem 1 / Figures 1-2 protocol)
# ---------------------------------------------------------------------------


def run_convergence(schemes, partitions, rounds, capacity_mix, seed,
                    n_clients, participate, device="cuda"):
    from repro_torch.core.paper_protocol import PaperExperiment

    finals = {}
    for part in partitions:
        for s in schemes:
            # a fresh experiment per cell: every scheme replays the same
            # seed-keyed data stream
            exp = PaperExperiment(n_clients=n_clients,
                                  participate=participate, partition=part,
                                  capacities=tuple(capacity_mix),
                                  n_train=800, n_test=200, mb=8, seed=seed,
                                  device=device)
            r = exp.run(_TO_PAPER[s], rounds=rounds, eval_every=1)
            emit(f"{s}_{part}_final_loss", round(r["final"]["test_loss"], 5))
            emit(f"{s}_{part}_final_acc", round(r["final"]["test_acc"], 5))
            emit(f"{s}_{part}_curve", r["curve"])
            if part == partitions[0]:
                finals[s] = r["final"]["test_loss"]
                emit(f"{s}_final_loss", round(finals[s], 5))
    if "shuffled" in finals and "random" in finals:
        emit("shuffled_beats_random",
             int(finals["shuffled"] <= finals["random"] + 1e-9))
    return finals


# ---------------------------------------------------------------------------
# Track 2: algorithmic stability (Theorem 5, Definition 4 twin runs)
# ---------------------------------------------------------------------------


def _linear_loss(w, b):
    """Each client's least-squares loss: ``w [C, d]``, ``x [C, m, d]``,
    ``y [C, m]`` -> ``[C]``."""
    r = torch.einsum("cmd,cd->cm", b["x"], w["w"]) - b["y"]
    return 0.5 * (r * r).mean(-1), {}


def run_stability(schemes, rounds, seed, n_pairs, device="cuda"):
    from repro_torch import api
    from repro_torch.configs.base import SubmodelConfig
    from repro_torch.core.stability import stability_experiment
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    d, n_per, C = 16, 32, 4
    rng = np.random.default_rng(seed)
    Xs = rng.standard_normal((C, n_per, d)).astype(np.float32)
    w_true = rng.standard_normal(d).astype(np.float32)
    ys = (Xs @ w_true
          + 0.1 * rng.standard_normal((C, n_per))).astype(np.float32)
    ab = {"w": torch.Size((d,))}

    def make_batches(X, y):
        brng = np.random.default_rng(42)

        def gen():
            while True:
                idx = brng.integers(0, n_per, (2, C, 8))
                xb = np.stack([[X[c][idx[k, c]] for c in range(C)]
                               for k in range(2)])
                yb = np.stack([[y[c][idx[k, c]] for c in range(C)]
                               for k in range(2)])
                yield {"x": xb, "y": yb}
        return gen()

    def batches_fn(perturbed, pair_seed):
        Xp, yp = np.copy(Xs), np.copy(ys)
        if perturbed:  # Definition 4: one sample of one client replaced
            prng = np.random.default_rng(123 + pair_seed)
            Xp[0, 0] = prng.standard_normal(d)
            yp[0, 0] = prng.standard_normal()
        return make_batches(Xp, yp)

    dists = {}
    for s in schemes:
        scfg = SubmodelConfig(scheme=_TO_SCFG[s], capacity=0.5,
                              local_steps=2, clients_per_round=C,
                              client_lr=0.02, seed=seed)

        def make_fed(scfg=scfg):
            # dense-mask mode: Theorem 5 is stated for masked training
            return api.fed_round((_linear_loss, ab, {"w": ("d_ff",)}), scfg,
                                 mode="mask", device=dev)

        dist, _ = stability_experiment(make_fed,
                                       {"w": torch.zeros(d, device=dev)},
                                       batches_fn, rounds, seed,
                                       n_pairs=n_pairs)
        dists[s] = dist
        emit(f"{s}_stability_distance", round(dist, 6))
    emit("stability_finite",
         int(all(np.isfinite(v) for v in dists.values())))
    return dists


# ---------------------------------------------------------------------------
# Track 3: empirical rate vs the Theorem-1 bound (quadratic problem)
# ---------------------------------------------------------------------------


def run_theory(rounds, seed, device="cuda"):
    from repro_torch import api
    from repro_torch.configs.base import SubmodelConfig
    from repro_torch.core.theory import QuadraticProblem, thm1_residual

    prob = QuadraticProblem.make(n_clients=4, m=64, d=16, hetero=0.3,
                                 seed=seed, device=device)
    dev = prob.A.device
    consts = prob.constants()
    f_star = prob.global_loss(torch.tensor(prob.w_star(), dtype=torch.float32,
                                           device=dev))
    rng = np.random.default_rng(seed)
    p = 0.7
    A_rows, b_rows = prob.A.reshape(-1, prob.dim), prob.b.reshape(-1)

    def loss(w, batch):
        """``w [C, d]``, ``idx [C, 16]`` rows of the pooled data -> [C]."""
        r = torch.einsum("cmd,cd->cm", A_rows[batch["idx"]], w["w"]) \
            - b_rows[batch["idx"]]
        return 0.5 * (r * r).mean(-1), {}

    def batches():
        while True:
            yield {"idx": rng.integers(0, 4 * 64, (2, 4, 16))}

    ab = {"w": torch.Size((prob.dim,))}
    scfg = SubmodelConfig(scheme="bernoulli", capacity=p, local_steps=2,
                          clients_per_round=4, client_lr=0.05, seed=seed)
    fed = api.fed_round((loss, ab, {"w": ("d_model",)}), scfg,
                        capacities=np.full(4, p), device=dev)
    trainer = api.Trainer(fed, {"w": torch.zeros(prob.dim, device=dev)},
                          rng=seed + 1)
    params, _ = trainer.run(batches(), rounds * 10)
    excess = float(prob.global_loss(params["w"]) - f_star)
    bound = thm1_residual(consts["L"], consts["mu"], G=2.0, W=2.0,
                          d=prob.dim, probs=np.full(4, p))
    emit("thm1_excess", round(excess, 6))
    emit("thm1_bound", round(float(bound), 4))
    emit("thm1_bound_holds", int(excess <= bound))
    return excess, bound


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None):
    from repro_torch.configs.resnet18_cifar import CAPACITY_BETAS
    from repro_torch.data.federated import PARTITIONS as DATA_PARTITIONS
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(
        description="Run the paper-protocol experiment sweep on the port "
                    "(see docs/experiments.md)")
    ap.add_argument("--rounds", type=int, default=10,
                    help="communication rounds per convergence cell "
                         "(stability twins use the same count; the "
                         "theory track runs 10x on the cheap quadratic)")
    ap.add_argument("--schemes", nargs="+", default=list(SCHEMES),
                    choices=list(SCHEMES),
                    help="shuffled = the paper's shuffled-rolling "
                         "Algorithm 2; random = unstructured Bernoulli "
                         "masks (Algorithm 1); static = HeteroFL")
    ap.add_argument("--partitions", nargs="+", default=list(PARTITIONS),
                    choices=list(DATA_PARTITIONS))
    ap.add_argument("--capacity-mix", nargs="+", type=float,
                    default=list(CAPACITY_BETAS),
                    help="client capacity distribution (default: the "
                         "ResNet config's HeteroFL betas)")
    ap.add_argument("--n-clients", type=int, default=10)
    ap.add_argument("--participate", type=int, default=4)
    ap.add_argument("--stability-pairs", type=int, default=1,
                    help="neighboring-dataset pairs per scheme")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=RESULTS_PATH)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the rounds run (cuda raises without a "
                         "card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    RESULTS.pop(SECTION, None)
    emit("rounds", args.rounds)
    emit("schemes", list(args.schemes))
    emit("partitions", list(args.partitions))
    emit("capacity_mix", list(args.capacity_mix))

    run_convergence(args.schemes, args.partitions, args.rounds,
                    args.capacity_mix, args.seed, args.n_clients,
                    args.participate, device)
    run_stability(args.schemes, args.rounds, args.seed,
                  args.stability_pairs, device)
    run_theory(args.rounds, args.seed, device)

    path = write_results(args.out)
    summary = {k: v for k, v in RESULTS[SECTION].items()
               if not isinstance(v, list)}
    print(json.dumps({"written": path, SECTION: summary}, indent=1))
    return RESULTS[SECTION]


if __name__ == "__main__":
    main()
