"""Client sampling without replacement across rounds, the port's own
numpy copy.

Ports ``EpochPermutationSampler`` of ``repro/fleet/sampler.py`` line for
line (random reshuffling of the client set, arXiv 2201.11066), so one seed
draws the same participants in both packages.  The rest of the fleet is
not ported yet (ROADMAP.md queue A, the fleet).
"""
from __future__ import annotations

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
