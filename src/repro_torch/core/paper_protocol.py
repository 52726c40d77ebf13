"""The paper's §5 experimental protocol, end to end.

Ports ``SCHEME_MAP`` and ``PaperExperiment`` of
``repro/core/paper_protocol.py``: a pre-act ResNet (static BN + scaler) on
synthetic CIFAR-like data, N clients with label-limited non-IID shards,
the HeteroFL capacity mix beta in {1, 1/2, ..., 1/16}, a share of the
clients taking part in each round, and dense-mask sub-model training
under the schemes rolling, random (Bernoulli), static and full.  Each
round is ``api.fed_round(..., mode="mask", capacities=...)`` with the
round's participants' capacities and their ``1/beta`` scalers in the
batch; the rounds run on ``device`` (default the card).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from repro_torch import api
from repro_torch.configs.base import SubmodelConfig
from repro_torch.configs.resnet18_cifar import (CAPACITY_BETAS, ResNetConfig,
                                                reduced as resnet_reduced)
from repro_torch.core.fedavg import MaskFedAvg
from repro_torch.core.stability import generalization_gap
from repro_torch.data.federated import FederatedDataset
from repro_torch.data.synthetic import SyntheticCIFAR
from repro_torch.device import resolve_device
from repro_torch.models.resnet import build_resnet_params, resnet_loss

SCHEME_MAP = {  # paper name -> scfg scheme
    "rolling": "rolling",
    "random": "bernoulli",          # Algorithm 1: unstructured Bernoulli
    "static": "static",             # HeteroFL
    "full": "full",                 # FedAvg baseline
}


@dataclass
class PaperExperiment:
    n_clients: int = 20
    participate: int = 4
    partition: str = "label"        # iid | label-limited (paper) | dirichlet
    labels_per_client: int = 2      # 2 = high heterogeneity, 5 = low
    alpha: float = 0.5              # dirichlet only: 0.1 ~ L=2, 0.5 ~ L=5
    # default capacity mix = the ResNet config's HeteroFL betas
    capacities: tuple = CAPACITY_BETAS
    k_steps: int = 2
    mb: int = 8
    lr: float = 0.05
    seed: int = 0
    n_train: int = 2000
    n_test: int = 500
    rcfg: ResNetConfig = field(default_factory=resnet_reduced)
    device: str = "cuda"

    def __post_init__(self):
        self.dev = resolve_device(self.device)
        self.data = SyntheticCIFAR(self.rcfg.n_classes, self.rcfg.image_size,
                                   self.n_train, self.n_test, seed=self.seed)
        self.fed_data = FederatedDataset.from_labels(
            self.data.train, self.data.train["labels"], self.n_clients,
            partition=self.partition,
            labels_per_client=self.labels_per_client, alpha=self.alpha,
            seed=self.seed)
        rng = np.random.default_rng(self.seed + 7)
        self.client_caps = np.array(
            [self.capacities[i % len(self.capacities)]
             for i in range(self.n_clients)], np.float32)
        rng.shuffle(self.client_caps)
        self.loss_fn = lambda p, b: resnet_loss(p, self.rcfg, b)

    def init_params(self):
        """``(params, axes)`` drawn from ``seed`` on the device (torch's
        stream: other weights than the reference's for the same seed)."""
        return build_resnet_params(self.rcfg, self.seed, self.dev)

    def make_fed(self, scheme: str, uniform_cap=None) -> MaskFedAvg:
        abstract, axes = build_resnet_params(self.rcfg, 0, "meta")
        abstract = {k: v.shape for k, v in abstract.items()}
        scfg = SubmodelConfig(scheme=SCHEME_MAP[scheme], capacity=0.5,
                              local_steps=self.k_steps,
                              clients_per_round=self.participate,
                              client_lr=self.lr, seed=self.seed,
                              axes=("channels",))
        caps = np.full(self.participate, uniform_cap, np.float32) \
            if uniform_cap else self.client_caps[:self.participate]
        return api.fed_round((self.loss_fn, abstract, axes), scfg,
                             mode="mask", capacities=caps, device=self.dev)

    def _round_batches(self, scheme, uniform_cap):
        """(batch, round_kwargs) pairs: per-round participating capacities
        ride along as the mask round's ``capacities`` argument."""
        it = self.fed_data.round_batches(self.participate, self.k_steps,
                                         self.mb)
        while True:
            batch_np, clients = next(it)
            caps = (np.full(self.participate, uniform_cap, np.float32)
                    if uniform_cap else
                    self.client_caps[clients].astype(np.float32))
            if scheme in ("rolling", "static", "random"):
                scaler = (1.0 / caps)[None].repeat(self.k_steps, 0)
                batch_np["scaler"] = scaler.astype(np.float32)
            yield batch_np, {"capacities": caps}

    def _on_device(self, data):
        """Numpy leaves on the device: images as they are, labels int64."""
        return {k: torch.as_tensor(v).to(self.dev) if v.dtype.kind == "f"
                else torch.as_tensor(v).to(self.dev, torch.long)
                for k, v in data.items()}

    def run(self, scheme: str, rounds: int = 30, uniform_cap=None,
            eval_every: int = 5) -> Dict:
        params, _ = self.init_params()
        fed = self.make_fed(scheme, uniform_cap)
        test = self._on_device(self.data.test)

        def eval_fn(p):
            lt, mt = self.loss_fn(p, test)
            return {"test_loss": float(lt), "test_acc": float(mt["acc"])}

        trainer = api.Trainer(fed, params, rng=self.seed + 1,
                              eval_fn=eval_fn, eval_every=eval_every)
        params, history = trainer.run(
            self._round_batches(scheme, uniform_cap), rounds)
        curve: List[Dict] = [
            {"round": h["round"], "train_loss": float(h["loss"]),
             "test_loss": h["test_loss"], "test_acc": h["test_acc"]}
            for h in history if "test_loss" in h]
        # §5.3 generalization gap: the global model on train vs test data
        ntr = min(self.n_test, self.n_train)
        train_eval = self._on_device({k: v[:ntr] for k, v in
                                      self.data.train.items()})
        gap = generalization_gap(self.loss_fn, params, train_eval, test)
        return {"scheme": scheme, "curve": curve, "gap": gap,
                "final": curve[-1]}
