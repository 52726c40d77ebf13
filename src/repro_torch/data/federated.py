"""Federated data partitioning (the paper's §5.1 protocol), the port's own
numpy copy.

Ports ``iid_partition``, ``label_limited_partition``,
``dirichlet_partition``, ``PARTITIONS`` and ``FederatedDataset``
(``from_labels``, ``sample_clients``, ``round_batch``, ``round_batches``)
of ``repro/data/federated.py`` line for line, so one seed gives the same
client stores and round batches in both packages.

* ``iid_partition``: uniform random split (the homogeneous baseline).
* ``label_limited_partition``: each client sees only L of the label set
  (the paper's high/low heterogeneity: CIFAR-10 L=2 vs L=5).
* ``dirichlet_partition``: the Dirichlet(alpha) alternative (empty clients
  rebalanced deterministically so every store can serve batches).
* ``FederatedDataset``: client stores and round-batch assembly with client
  sampling (the paper's 10%-of-100-clients participation).
"""
from __future__ import annotations

import numpy as np

from repro_torch.fleet.sampler import EpochPermutationSampler


def iid_partition(labels, n_clients, seed=0):
    """Uniform random split: every client draws from the same mixture."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(labels))
    return [np.sort(p).astype(np.int64)
            for p in np.array_split(idx, n_clients)]


def label_limited_partition(labels, n_clients, labels_per_client, seed=0):
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    client_labels = [rng.choice(classes, size=labels_per_client,
                                replace=False) for _ in range(n_clients)]
    # assign each sample to a random client that owns its label
    owners = {c: [i for i, ls in enumerate(client_labels) if c in ls]
              for c in classes}
    parts = [[] for _ in range(n_clients)]
    for idx, y in enumerate(labels):
        cands = owners[y] or list(range(n_clients))
        parts[cands[rng.integers(len(cands))]].append(idx)
    return [np.array(p, np.int64) for p in parts]


def dirichlet_partition(labels, n_clients, alpha, seed=0):
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    parts = [[] for _ in range(n_clients)]
    for c in classes:
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet(alpha * np.ones(n_clients))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for ci, chunk in enumerate(np.split(idx, cuts)):
            parts[ci].extend(chunk)
    # Small alpha concentrates whole classes on few clients and can leave
    # others empty; an empty client store breaks round sampling, so move
    # one sample over from the currently largest part (deterministic).
    for ci in range(n_clients):
        while not parts[ci]:
            donor = max(range(n_clients), key=lambda j: len(parts[j]))
            parts[ci].append(parts[donor].pop())
    return [np.array(p, np.int64) for p in parts]


PARTITIONS = ("iid", "label", "dirichlet")


class FederatedDataset:
    def __init__(self, data, parts, seed=0):
        """data: dict of arrays (leading sample dim); parts: list of index
        arrays per client."""
        self.data = data
        self.parts = parts
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._sampler = None

    @classmethod
    def from_labels(cls, data, labels, n_clients, *, partition="label",
                    labels_per_client=2, alpha=0.5, seed=0):
        """Partition ``data`` by ``labels`` into ``n_clients`` stores:
        ``label`` (the paper's label-limited protocol,
        ``labels_per_client`` classes per client), ``dirichlet``
        (Dirichlet(``alpha``); smaller means more label skew) or ``iid``.
        The same ``seed`` drives the split and the round sampling."""
        if partition not in PARTITIONS:
            raise ValueError(f"unknown partition {partition!r}; expected "
                             f"one of {PARTITIONS}")
        if partition == "iid":
            parts = iid_partition(labels, n_clients, seed=seed)
        elif partition == "label":
            parts = label_limited_partition(labels, n_clients,
                                            labels_per_client, seed=seed)
        else:
            parts = dirichlet_partition(labels, n_clients, alpha, seed=seed)
        return cls(data, parts, seed=seed)

    @property
    def n_clients(self):
        return len(self.parts)

    def sample_clients(self, n, replace=False):
        """Participants for one round: by default without replacement
        across rounds (consecutive calls walk an epoch permutation of the
        clients, :class:`EpochPermutationSampler`); ``replace=True`` draws
        each call independently (distinct within a round only)."""
        if replace:
            return self.rng.choice(self.n_clients, size=n, replace=False)
        if self._sampler is None:
            self._sampler = EpochPermutationSampler(self.n_clients,
                                                    seed=self.seed)
        return self._sampler.sample(n)

    def round_batch(self, clients, k_steps, mb_size):
        """Batch leaves [K, C, mb, ...] for the selected clients."""
        out = {k: [] for k in self.data}
        for _ in range(k_steps):
            step = {k: [] for k in self.data}
            for c in clients:
                idx = self.parts[c]
                take = self.rng.choice(idx, size=mb_size,
                                       replace=len(idx) < mb_size)
                for k in self.data:
                    step[k].append(self.data[k][take])
            for k in self.data:
                out[k].append(np.stack(step[k]))
        return {k: np.stack(v) for k, v in out.items()}

    def round_batches(self, n_participating, k_steps, mb_size):
        while True:
            clients = self.sample_clients(n_participating)
            yield self.round_batch(clients, k_steps, mb_size), clients
