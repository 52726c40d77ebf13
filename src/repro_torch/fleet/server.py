"""The asynchronous federated round server (``api.AsyncTrainer``), a port of
``repro/fleet/server.py``.

Idle slots (one per in-flight client) dispatch together as a cohort at the
current virtual instant: one stacked call of the round object's own
client phase (fused or extract; the bucket phase of a heterogeneous
round), whose completion times go on a ``(time, seq)`` heap drawn from the
:class:`~repro_torch.fleet.simulator.FleetSimulator`.  Completed reports
land in the :class:`~repro_torch.fleet.buffer.DeltaBuffer`; once M of the
N in-flight clients have reported, their changes are aggregated through
the round object's own arms (``_apply_mean_delta*``, ``_mean_delta_full*``
and a ``ServerOpt``), with the staleness weights and the server-lr
schedule folded into one scale per entry.

With M = N, a zero-spread fleet and no dropouts every cohort is the whole
client set at one instant, every report has tau = 0 (scale exactly 1.0,
the multiply skipped), and the rounds equal the synchronous
``api.Trainer``'s bit for bit.

Layering: the package drives the round object handed to it and imports
neither ``repro_torch.core.fedavg`` nor ``repro_torch.api``.
"""
from __future__ import annotations

import dataclasses
import heapq
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import submodel as sm
from repro_torch.core.trainer import _to_device
from repro_torch.fleet.buffer import ClientReport, DeltaBuffer
from repro_torch.fleet.sampler import (EpochPermutationSampler,
                                       resolve_server_lr_schedule)
from repro_torch.fleet.simulator import FleetSimulator


def _reports_of(delta, losses, m):
    """The cohort's stacked changes and losses split into ``m`` rows, each
    leaf ``[1, ...]`` in storage of its own (a view would keep the whole
    cohort tensor alive while any one report is in flight), one leaf at a
    time so the cohort's storage is freed as it is split."""
    rows = [{} for _ in range(m)]
    for path in list(delta):
        d = delta.pop(path)
        for j in range(m):
            rows[j][path] = d[j:j + 1].clone()
        del d
    return rows, [losses[:, j:j + 1].clone() for j in range(m)]


def _concat(parts):
    """``[1, ...]`` report rows stacked back to ``[m, ...]``: pure data
    movement, so the M = N anchor's change is the cohort's bit for bit."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, 0)


@dataclass
class AsyncTrainer:
    """Asynchronous counterpart of :class:`repro_torch.api.Trainer`::

        fed = api.fed_round(model, scfg)
        fleet = api.FleetSimulator(64, api.LatencyModel(straggler_frac=.25))
        at = api.AsyncTrainer(fed, params, buffer_size=4, fleet=fleet)
        params, history = at.run(batches, n_rounds=50)

    ``fed`` is a window-mode round; it runs on ``fed.device``, where
    ``params`` must lie.  ``source`` is an iterator of batches with leaves
    ``[K, C, ...]`` (each dispatch takes one and the dispatched slots'
    lanes) or a callable ``(client_ids) -> batch`` with leaves ``[K,
    len(client_ids), ...]``.  The defaults are the synchronous anchor:
    ``buffer_size=None`` is M = ``scfg.clients_per_round`` and
    ``fleet=None`` a zero-spread fleet of that size.  ``rng`` (an int seed)
    is kept for the reference's signature: the window schemes draw their
    offsets from ``scfg.seed``, one draw per server round, as the
    synchronous round does.  ``history`` holds ``Trainer``'s records
    (``round``, ``loss``, ``client_loss``) plus ``virtual_time`` (the
    virtual clock at aggregation), ``staleness`` (the mean tau of the
    aggregated reports) and ``lr_mult`` (the server-lr schedule's value).

    Heterogeneous rounds (``fed_round(capacities=)``) dispatch through the
    bucket phase and buffer full-shaped changes; their aggregation sums in
    arrival order rather than bucket order, so their M = N anchor holds to
    float32 rounding, not bit for bit.  With ``FleetSimulator(capacities=)``
    too, dispatch pairs the most capable sampled client with the widest
    slot (:meth:`_pair_capacities`).
    """

    fed: Any                               # window-mode round (api.fed_round)
    params: Dict[str, torch.Tensor]
    rng: Optional[int] = None
    buffer_size: Optional[int] = None      # M; None = clients_per_round
    fleet: Optional[FleetSimulator] = None  # None = zero-spread, N = C
    sampler: Optional[EpochPermutationSampler] = None
    staleness: Union[str, Callable] = "inverse_sqrt"
    server_opt: Any = None                 # overrides fed.server_opt
    server_lr_schedule: Any = None         # name | callable(round) -> mult
    callbacks: Sequence[Callable] = ()
    eval_fn: Optional[Callable] = None
    eval_every: int = 0
    log_every: int = 0
    log_fn: Callable = print
    max_ticks: int = 1_000_000             # scheduler-event safety valve

    round_idx: int = field(default=0, init=False)
    history: List[Dict] = field(default_factory=list, init=False)
    opt_state: Any = field(default=None, init=False)

    def __post_init__(self):
        fed = self.fed
        for attr in ("_client_phase", "_client_phase_fused",
                     "_apply_mean_delta", "scfg"):
            if not hasattr(fed, attr):
                raise TypeError(
                    "AsyncTrainer drives window-mode rounds only (build "
                    "one with repro_torch.api.fed_round(model, scfg); mask "
                    "mode has no per-client window deltas to buffer); got "
                    f"{type(fed).__name__}")
        if getattr(fed, "mesh", None) is not None:
            raise ValueError(
                "AsyncTrainer owns the client axis (dispatch cohorts are "
                "dynamic); build the round with mesh=None")
        wrong = [k for k, v in self.params.items() if v.device != fed.device]
        if wrong:
            raise ValueError(f"params {wrong[:3]} are not on the round's "
                             f"device {fed.device}")
        self._C = fed.scfg.clients_per_round       # in-flight slots N
        m = self._C if self.buffer_size is None else self.buffer_size
        self.buffer = DeltaBuffer(m, self.staleness)
        if self.fleet is None:
            self.fleet = FleetSimulator(self._C)
        if self.fleet.n_clients < self._C:
            raise ValueError(
                f"fleet of {self.fleet.n_clients} clients cannot fill "
                f"{self._C} in-flight slots; grow the fleet or shrink "
                "scfg.clients_per_round")
        if self.sampler is None:
            self.sampler = EpochPermutationSampler(self.fleet.n_clients,
                                                   seed=fed.scfg.seed)
        self._schedule = resolve_server_lr_schedule(self.server_lr_schedule)
        if self.server_opt is None:
            self.server_opt = getattr(fed, "server_opt", None)
        if self.server_opt is not None:
            self.opt_state = self.server_opt.init(self.params)

        # scheduler state (persists across run() calls: in-flight work
        # resumes where it stopped)
        self._clock = 0.0
        self._seq = 0                       # dispatch sequence counter
        self._events: list = []             # heap of (time, seq, slot, rep)
        self._idle: List[int] = list(range(self._C))
        self._round_offsets: Dict[int, Any] = {}   # tag -> {axis: [C]}
        self._fused: Optional[bool] = None  # resolved at first dispatch
        self._scatter_fed = None            # shared_window=False clone
        # heterogeneous rounds: cohorts run the bucket phase of their slots
        self._hetero = getattr(fed, "hetero", None)
        self._phase_cache: Dict[Any, Any] = {}
        self.scatter_aggregations = 0       # aggregations on _scatter_arm

    # -- round context ---------------------------------------------------------

    def _offsets_for(self, tag):
        """The round's offsets ``{axis: [C]}`` for a server-round tag, drawn
        once per new tag as the synchronous round draws them; cohorts
        redispatched against the same tag reuse them (a straggler's retry
        trains the same round's window)."""
        if tag not in self._round_offsets:
            self._round_offsets[tag] = self.fed._client_offsets(tag,
                                                                self.params)
        return self._round_offsets[tag]

    def _phase_fn(self, slots):
        if self._hetero is not None:
            # bucket membership depends on which lanes dispatched: one
            # phase per distinct slot set
            key = tuple(slots)
            if key not in self._phase_cache:
                self._phase_cache[key] = self.fed._hetero_phase_for(key)
            return self._phase_cache[key]
        return (self.fed._client_phase_fused if self._fused
                else self.fed._client_phase)

    # -- dispatch --------------------------------------------------------------

    def _next_batch(self, source, ids, slots):
        dev = self.fed.device
        if callable(source):
            return {k: _to_device(v, dev) for k, v in source(ids).items()}
        batch = {k: _to_device(v, dev) for k, v in next(source).items()}
        if slots != list(range(self._C)):
            # a partial cohort takes the dispatched slots' lanes
            lanes = torch.as_tensor(slots, device=dev)
            batch = {k: v.index_select(1, lanes) for k, v in batch.items()}
        return batch

    def _pair_capacities(self, ids, slots):
        """Rank-match sampled clients to width slots: when both the fleet
        (``FleetSimulator(capacities=)``) and the round
        (``fed_round(capacities=)``) carry capacity vectors, the most
        capable sampled client takes the widest dispatched slot; otherwise
        the ids pass through unchanged."""
        fleet_caps = getattr(self.fleet, "capacities", None)
        slot_caps = getattr(self.fed, "capacities", None)
        if fleet_caps is None or slot_caps is None:
            return ids
        ids = np.asarray(ids)
        slot_rank = np.argsort(
            -np.asarray([slot_caps[s] for s in slots]), kind="stable")
        id_rank = np.argsort(-fleet_caps[ids], kind="stable")
        paired = np.empty_like(ids)
        paired[slot_rank] = ids[id_rank]
        return paired

    def _dispatch(self, source):
        slots, self._idle = sorted(self._idle), []
        ids = self._pair_capacities(self.sampler.sample(len(slots)), slots)
        tag = self.round_idx
        offsets = self._offsets_for(tag)
        if self._fused is None:
            # heterogeneous cohorts report full-shaped changes: *_fused arms
            self._fused = (self._hetero is not None
                           or (self.fed.use_fused and bool(offsets)))
        cohort_off = {k: [v[s] for s in slots] for k, v in offsets.items()}
        batch = self._next_batch(source, ids, slots)
        delta, losses = self.fleet.run_cohort(
            self._phase_fn(slots), self.params, batch, cohort_off)
        del batch
        rows, loss_rows = _reports_of(delta, losses, len(slots))
        for j, (slot, cid) in enumerate(zip(slots, ids)):
            delay, ok = self.fleet.completion(int(cid), self._seq)
            rep = ClientReport(
                client_id=int(cid), slot=slot, round_tag=tag, delta=rows[j],
                offsets={k: v[slot:slot + 1] for k, v in offsets.items()},
                losses=loss_rows[j]) if ok else None
            heapq.heappush(self._events,
                           (self._clock + delay, self._seq, slot, rep))
            self._seq += 1

    # -- aggregation -----------------------------------------------------------

    def _scatter_arm(self):
        """A ``shared_window=False`` clone for mixed-window buffers: the
        shared-window mean and single scatter hold only when every buffered
        entry trained the same window; stale entries from older rounds
        break that, so they aggregate through the per-client arm."""
        if self._scatter_fed is None:
            fed = self.fed
            self._scatter_fed = dataclasses.replace(
                fed, scfg=dataclasses.replace(fed.scfg, shared_window=False))
        return self._scatter_fed

    def _entry_scales(self, taus, weights, lr_mult, denom, m):
        """Per-entry multipliers g that make the arm's fixed denominator
        (m on the shared-mean arm, C on the per-client arm) compute the
        staleness-weighted, schedule-scaled mean: ``g_i = lr_mult * w_i *
        denom / sum(w)``.  Equal taus give ``lr_mult * denom / m`` exactly,
        1.0 at tau = 0, M = C and multiplier 1 (the multiply is then
        skipped: the bit-equal anchor)."""
        if np.all(taus == taus[0]):
            return np.full(m, lr_mult * (denom / m), np.float64)
        return lr_mult * weights * (denom / weights.sum())

    def _aggregate(self):
        r = self.round_idx
        reps, taus, weights = self.buffer.take(r)
        m = len(reps)
        delta = {k: _concat([rep.delta.pop(k) for rep in reps])
                 for k in list(reps[0].delta)}
        offsets = {k: [o for rep in reps for o in rep.offsets[k]]
                   for k in reps[0].offsets}
        losses = torch.cat([rep.losses for rep in reps], 1)

        # the shared-window mean and single scatter apply only when every
        # buffered entry trained the same window (staleness mixes rounds)
        shared_arm = bool(self.fed.shared_window) and bool(offsets) and all(
            rep.offsets == reps[0].offsets for rep in reps[1:])
        arm = (self.fed if shared_arm or not self.fed.shared_window
               else self._scatter_arm())
        self.scatter_aggregations += arm is not self.fed
        denom = m if shared_arm else self._C
        lr_mult = float(self._schedule(r))
        g = self._entry_scales(taus, weights, lr_mult, denom, m)
        with torch.no_grad():
            if not np.all(g == 1.0):
                for d in delta.values():
                    gj = torch.as_tensor(g, dtype=torch.float32,
                                         device=d.device)
                    d.mul_(gj.view((-1,) + (1,) * (d.dim() - 1)))
            if self.server_opt is None:
                if self._fused:
                    arm._apply_mean_delta_fused(self.params, delta, offsets)
                else:
                    arm._apply_mean_delta(self.params, delta, offsets)
            else:
                full = (arm._mean_delta_full_fused(delta) if self._fused
                        else arm._mean_delta_full(self.params, delta,
                                                  offsets))
                del delta
                self.params, self.opt_state = self.server_opt.update(
                    self.params, full, self.opt_state)
                del full
            sm.project_l2(self.params, self.fed.scfg.proj_radius)
        self.round_idx += 1
        return {"round": r, "loss": losses.mean(), "client_loss": losses,
                "virtual_time": self._clock,
                "staleness": float(taus.mean()), "lr_mult": lr_mult}

    # -- the event loop --------------------------------------------------------

    def run(self, source, n_rounds):
        """Run until ``n_rounds`` more aggregations; returns ``(params,
        history)``.  In-flight work persists across calls."""
        if not callable(source):
            source = iter(source)
        last = self.round_idx + n_rounds - 1
        ticks = 0
        while self.round_idx <= last:
            if self._idle:
                self._dispatch(source)
            if not self._events:
                raise RuntimeError("fleet deadlock: no in-flight clients "
                                   "and nothing left to dispatch")
            # drain every event at the next virtual instant, in dispatch
            # order, so a full zero-spread cohort lands as one sync round
            t = self._events[0][0]
            self._clock = t
            while self._events and self._events[0][0] == t:
                _, _, slot, rep = heapq.heappop(self._events)
                if rep is not None:
                    self.buffer.report(rep)
                self._idle.append(slot)
            while self.buffer.ready() and self.round_idx <= last:
                rec = self._aggregate()
                r = rec["round"]
                if self.eval_fn and (r == last or (
                        self.eval_every and r % self.eval_every == 0)):
                    with torch.no_grad():
                        rec.update({k: float(v) for k, v in
                                    self.eval_fn(self.params).items()})
                self.history.append(rec)
                for cb in self.callbacks:
                    cb(r, self.params, rec)
                if self.log_every and (r % self.log_every == 0 or r == last):
                    extras = " ".join(f"{k} {float(v):.4f}"
                                      for k, v in rec.items()
                                      if k not in ("round", "loss")
                                      and np.ndim(v) == 0)
                    self.log_fn(f"round {r:4d} loss {float(rec['loss']):.4f}"
                                + (f"  {extras}" if extras else ""))
            ticks += 1
            if ticks > self.max_ticks:
                raise RuntimeError(
                    f"no round completed within {self.max_ticks} scheduler "
                    "ticks: dropout/timeout settings may be starving the "
                    "buffer")
        return self.params, self.history

    @property
    def losses(self) -> List[float]:
        return [float(h["loss"]) for h in self.history]
