"""The deterministic virtual-clock fleet simulator, the port's numpy copy
of ``repro/fleet/simulator.py``.

It models when each dispatched client finishes (latency draws, straggler
multipliers, dropouts, the timeout), never what it computes: the client
phase is the round object's own, handed in by the server.  Every draw is
keyed on ``(seed, client_id, dispatch_seq)`` through
``np.random.default_rng``, so a fleet replays the reference's draws bit
for bit.  The default :class:`LatencyModel` is the zero-spread fleet
(every client takes ``base`` seconds), where the async server replays the
synchronous rounds; ``simulate_sync`` is the barrier baseline.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class LatencyModel:
    """Per-client completion time and faults: ``duration = base *
    straggler_mult`` (a straggler) ``* jitter``, jitter ~ lognormal(0,
    jitter_sigma) (1 when sigma = 0).  A dropout (probability ``dropout``
    per dispatch) never reports; its slot frees after ``timeout`` seconds
    (or at the would-be completion with no timeout).  A run slower than
    ``timeout`` is abandoned at the timeout."""
    base: float = 1.0
    jitter_sigma: float = 0.0
    straggler_frac: float = 0.0
    straggler_mult: float = 10.0
    dropout: float = 0.0
    timeout: Optional[float] = None
    seed: int = 0


class FleetSimulator:
    """``n_clients`` virtual clients with deterministic latency and fault
    draws.  The stragglers are the first ``round(straggler_frac *
    n_clients)`` of a seed-keyed permutation, fixed for the fleet's life
    (a larger fraction only adds stragglers).  ``capacities`` (optional,
    ``[n_clients]`` fractions in (0, 1]) is each device's capability: with
    a heterogeneous round the server pairs the most capable sampled client
    with the widest slot; the simulator only stores it."""

    def __init__(self, n_clients: int, latency: LatencyModel = LatencyModel(),
                 capacities=None):
        if n_clients < 1:
            raise ValueError(f"n_clients must be >= 1; got {n_clients}")
        self.n_clients = n_clients
        self.latency = latency
        order = np.random.default_rng(latency.seed).permutation(n_clients)
        k = int(round(latency.straggler_frac * n_clients))
        self.stragglers = frozenset(int(c) for c in order[:k])
        if capacities is None:
            self.capacities = None
        else:
            caps = np.asarray(capacities, np.float64).reshape(-1)
            if caps.shape[0] != n_clients:
                raise ValueError(
                    f"capacities must have length n_clients={n_clients}; "
                    f"got {caps.shape[0]}")
            if np.any(caps <= 0.0) or np.any(caps > 1.0):
                raise ValueError("fleet capacities are per-client fractions "
                                 f"in (0, 1]; got {caps}")
            self.capacities = caps

    def draw(self, client_id: int, seq: int) -> Tuple[float, bool]:
        """(wall-clock duration, dropped?) for dispatch number ``seq``."""
        lm = self.latency
        rng = np.random.default_rng([lm.seed, int(client_id), int(seq)])
        dur = lm.base
        if int(client_id) in self.stragglers:
            dur *= lm.straggler_mult
        if lm.jitter_sigma:
            dur *= float(rng.lognormal(0.0, lm.jitter_sigma))
        dropped = bool(lm.dropout) and bool(rng.random() < lm.dropout)
        return float(dur), dropped

    def completion(self, client_id: int, seq: int) -> Tuple[float, bool]:
        """(delay until the slot frees, did a report arrive?): drops and
        runs over the timeout free the slot at ``timeout`` with no
        report."""
        dur, dropped = self.draw(client_id, seq)
        t = self.latency.timeout
        if dropped:
            return (t if t is not None else dur), False
        if t is not None and dur > t:
            return t, False
        return dur, True

    def run_cohort(self, phase_fn, params, batch, offsets):
        """One dispatch cohort's client phase: every client dispatched at
        the same virtual instant runs as ONE stacked call (leaves ``[K, m,
        ...]``), as in the synchronous round; the simulator decides only
        when the results land."""
        return phase_fn(params, batch, offsets)

    def simulate_sync(self, sampler, n_rounds: int, cohort: int) -> float:
        """Virtual seconds for ``n_rounds`` synchronous barrier rounds:
        each samples ``cohort`` clients and waits for the slowest; a
        dropped or over-timeout client is retried until one run of every
        slot completes."""
        clock, seq = 0.0, 0
        for _ in range(n_rounds):
            round_time = 0.0
            for cid in sampler.sample(cohort):
                waited = 0.0
                while True:
                    delay, ok = self.completion(int(cid), seq)
                    seq += 1
                    waited += delay
                    if ok:
                        break
                round_time = max(round_time, waited)
            clock += round_time
        return clock
