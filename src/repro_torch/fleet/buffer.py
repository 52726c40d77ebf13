"""The FedBuff-style buffer of client changes, with staleness weights; the
port's numpy copy of ``repro/fleet/buffer.py``.

Completed client reports (each client's change, tagged with the server
round it was computed against) accumulate here; once M have arrived the
server aggregates the M oldest, weighting each by a staleness policy
``w(tau)``, ``tau = server_round - round_tag >= 0``.  Every policy has
``w(0) == 1.0`` exactly (a fresh report is never discounted, which keeps
the M = N zero-spread fleet bit-equal to the synchronous round) and is
non-increasing in tau.  The default is FedBuff's ``1 / sqrt(1 + tau)``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, Tuple, Union

import numpy as np

STALENESS_POLICIES = {
    "inverse_sqrt": lambda tau: 1.0 / math.sqrt(1.0 + tau),
    "inverse": lambda tau: 1.0 / (1.0 + tau),
    "constant": lambda tau: 1.0,
}


def resolve_staleness(policy: Union[str, Callable[[float], float]]
                      ) -> Callable[[float], float]:
    if callable(policy):
        return policy
    if policy not in STALENESS_POLICIES:
        raise ValueError(
            f"unknown staleness policy {policy!r}; expected one of "
            f"{sorted(STALENESS_POLICIES)} or a callable tau -> weight")
    return STALENESS_POLICIES[policy]


@dataclass
class ClientReport:
    """One completed client phase: its row of the cohort's stacked change,
    offsets and losses, each leaf ``[1, ...]`` in storage of its own."""
    client_id: int
    slot: int
    round_tag: int        # server round the change was computed against
    delta: Any            # {path: [1, ...]} (compact or full-shaped)
    offsets: Any          # {axis: [1] ints} ({} for scheme="full")
    losses: Any           # [K, 1] per-local-step losses


class DeltaBuffer:
    """Accumulates :class:`ClientReport`\\ s; ready once ``m`` arrived.

    Reports aggregate in arrival order (the M oldest form the round, later
    ones wait for the next), which makes the M = N anchor replay the
    synchronous client order exactly."""

    def __init__(self, m: int, staleness="inverse_sqrt"):
        if m < 1:
            raise ValueError(f"buffer size m must be >= 1; got {m}")
        self.m = m
        self.staleness = resolve_staleness(staleness)
        self._reports: List[ClientReport] = []

    def __len__(self) -> int:
        return len(self._reports)

    def report(self, rep: ClientReport) -> None:
        self._reports.append(rep)

    def ready(self) -> bool:
        return len(self._reports) >= self.m

    def take(self, server_round: int
             ) -> Tuple[List[ClientReport], np.ndarray, np.ndarray]:
        """Pop the m oldest reports; returns (reports, taus, weights)."""
        if not self.ready():
            raise RuntimeError(
                f"buffer has {len(self._reports)} of {self.m} reports")
        reps, self._reports = self._reports[:self.m], self._reports[self.m:]
        taus = np.array([server_round - r.round_tag for r in reps],
                        np.int64)
        if (taus < 0).any():
            raise RuntimeError(f"report from the future: taus={taus}")
        weights = np.array([self.staleness(float(t)) for t in taus],
                           np.float64)
        return reps, taus, weights
