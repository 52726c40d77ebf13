"""Client sampling without replacement across rounds, and the server's
stepsize schedules: the port's own numpy copy of ``repro/fleet/sampler.py``.

Ports ``EpochPermutationSampler`` (random reshuffling of the client set,
arXiv 2201.11066), ``constant``, ``inv_sqrt``, ``step_decay``,
``SERVER_LR_SCHEDULES`` and ``resolve_server_lr_schedule`` line for line,
so one seed draws the same participants in both packages.
"""
from __future__ import annotations

import math
from typing import Callable, Union

import numpy as np


class EpochPermutationSampler:
    """Draw participant sets without replacement across rounds.

    One epoch = one permutation of ``range(n_clients)``; successive
    :meth:`sample` calls consume consecutive blocks of it and a fresh
    permutation is drawn when it runs out.  Within one call the ``n``
    drawn clients are distinct (a leftover block is topped up with the
    non-colliding head of the next permutation, colliding entries
    deferred); when ``n`` divides ``n_clients`` every client participates
    exactly once per ``n_clients / n`` consecutive rounds; the same seed
    gives the same draws (``np.random.default_rng``).
    """

    def __init__(self, n_clients: int, seed: int = 0):
        if n_clients < 1:
            raise ValueError(f"n_clients must be >= 1; got {n_clients}")
        self.n_clients = n_clients
        self.rng = np.random.default_rng(seed)
        self.epoch = 0          # permutations drawn so far
        self._pool: list = []   # unconsumed tail of the current permutation

    def sample(self, n: int) -> np.ndarray:
        if not 0 < n <= self.n_clients:
            raise ValueError(
                f"cannot draw {n} distinct clients from {self.n_clients}")
        while len(self._pool) < n:
            perm = list(self.rng.permutation(self.n_clients))
            if self._pool:
                # keep the imminent draw duplicate-free: entries already in
                # the leftover block go to the back of the new permutation
                left = set(self._pool)
                perm = ([c for c in perm if c not in left]
                        + [c for c in perm if c in left])
            self._pool.extend(perm)
            self.epoch += 1
        take, self._pool = self._pool[:n], self._pool[n:]
        return np.array(take, np.int64)


# Server stepsize schedules: a multiplier on scfg.server_lr per server
# round, folded into the buffered aggregation's per-entry scale.
# "constant" is exactly 1.0, so the M = N anchor stays bit-equal.


def constant() -> Callable[[int], float]:
    return lambda r: 1.0


def inv_sqrt(t0: float = 1.0) -> Callable[[int], float]:
    """``1 / sqrt(1 + r / t0)``, the classic diminishing server stepsize."""
    return lambda r: 1.0 / math.sqrt(1.0 + r / t0)


def step_decay(gamma: float = 0.5, every: int = 100) -> Callable[[int], float]:
    return lambda r: gamma ** (r // every)


SERVER_LR_SCHEDULES = {
    "constant": constant,
    "inv_sqrt": inv_sqrt,
    "step": step_decay,
}


def resolve_server_lr_schedule(
        spec: Union[None, str, Callable[[int], float]]
) -> Callable[[int], float]:
    """None -> constant 1.0; a registry name -> its default factory; a
    callable ``round -> multiplier`` passes through."""
    if spec is None:
        return constant()
    if callable(spec):
        return spec
    if spec not in SERVER_LR_SCHEDULES:
        raise ValueError(
            f"unknown server-lr schedule {spec!r}; expected one of "
            f"{sorted(SERVER_LR_SCHEDULES)} or a callable round -> float")
    return SERVER_LR_SCHEDULES[spec]()
