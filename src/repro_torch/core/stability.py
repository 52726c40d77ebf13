"""Algorithmic-stability harness (paper §4, Theorems 5-6).

Ports ``perturb_one_sample``, ``pairwise_distance``,
``stability_experiment`` and ``generalization_gap`` of
``repro/core/stability.py``.  Trains the same federated algorithm on a
dataset S and a neighbouring dataset S^(i) (one sample of one client
replaced) and measures E||A(S) - A(S')||, the on-average stability that
bounds the generalization gap (Lemma 1); also the §5.3 train-test gap.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.fedavg import run_rounds
from repro_torch.core.submodel import global_norm


def perturb_one_sample(data_parts, data, client=0, index=0, seed=123):
    """A copy of the data dict with one sample of one client replaced by a
    freshly drawn one (a uniform label, a prototype-free noise image or
    re-drawn tokens)."""
    rng = np.random.default_rng(seed)
    new = {k: np.copy(v) for k, v in data.items()}
    gidx = data_parts[client][index]
    for k, v in new.items():
        if v.dtype.kind in "iu":
            lo, hi = int(v.min()), int(v.max()) + 1
            new[k][gidx] = rng.integers(lo, hi, size=v[gidx].shape)
        else:
            new[k][gidx] = rng.standard_normal(v[gidx].shape).astype(v.dtype)
    return new


def pairwise_distance(pa, pb):
    """``||pa - pb||_2`` over every leaf, a float."""
    return float(global_norm({k: pa[k].float() - pb[k].float()
                              for k in pa}))


def stability_experiment(make_fed: Callable, params0, batches_fn, n_rounds,
                         rng, n_pairs=3):
    """The generic E||A(S) - A(S')|| estimator.

    ``make_fed()`` -> a fresh round; ``batches_fn(perturbed, pair)`` -> a
    batch iterator.  The masks' randomness is shared across a pair (the
    same ``rng`` seed), only the data differ: Definition 4.  Each run
    starts from its own copy of ``params0``.
    """
    dists = []
    for pair in range(n_pairs):
        fa, fb = make_fed(), make_fed()
        pa, _ = run_rounds(fa, _copy(params0), batches_fn(False, pair),
                           n_rounds, rng)
        pb, _ = run_rounds(fb, _copy(params0), batches_fn(True, pair),
                           n_rounds, rng)
        dists.append(pairwise_distance(pa, pb))
    return float(np.mean(dists)), dists


def _copy(params):
    return {k: v.clone() for k, v in params.items()}


def generalization_gap(loss_fn, params, train_batch, test_batch):
    """§5.3 metric: (train loss - test loss, train acc - test acc) of one
    model, evaluated under ``torch.no_grad()``."""
    with torch.no_grad():
        ltr, mtr = loss_fn(params, train_batch)
        lte, mte = loss_fn(params, test_batch)
    out = {"train_loss": float(ltr), "test_loss": float(lte),
           "loss_gap": float(lte - ltr)}
    if "acc" in mtr:
        out.update(train_acc=float(mtr["acc"]), test_acc=float(mte["acc"]),
                   acc_gap=float(mtr["acc"] - mte["acc"]))
    return out
