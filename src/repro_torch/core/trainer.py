"""The training loop over federated rounds.

Ports ``Trainer`` (``step``, ``run``, ``losses``; the server-optimizer
round with its state carried across rounds; eval, logging, callbacks and
``start_round`` resume) and ``checkpoint_callback`` of
``repro/core/trainer.py``.  Batch iterators yield a batch dict (numpy or
torch leaves ``[K, C, ...]``) or a ``(batch, round_kwargs)`` pair whose
kwargs go to the round, e.g. ``{"offsets": ...}`` to inject window
offsets, ``{"masks": ...}`` to inject masks or ``{"capacities": [...]}``
for a mask round's participants (the paper's protocol passes them so).
A mesh round's ranks each run the same Trainer on the same batches; rank 0
alone logs and writes checkpoints (``checkpoint.save``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import is_writer, save


@dataclass
class Trainer:
    """Drives ``fed.round`` for N rounds on ``fed.device``::

        fed = api.fed_round(model, scfg)
        trainer = api.Trainer(fed, params, log_every=10,
                              eval_fn=lambda p: {"eval": model.loss(
                                  p, eval_batch)[0]})
        params, history = trainer.run(batches, n_rounds=3)
        trainer.run(batches, 3)           # resumes at round 3

    The round updates ``params`` in place.  With a server optimizer (a
    ``ServerOpt`` passed here, or the round's own ``fed.server_opt``) the
    trainer steps ``fed.round_with_server_opt`` and carries
    ``opt_state`` (made by ``server_opt.init(params)``) across rounds.
    ``history`` keeps per-round
    metric records as device tensors; :attr:`losses` reads them once.
    ``rng`` (an int seed; None is 0) seeds one ``torch.Generator`` on the
    round's device, which every round draws its masks from
    (``generator=``).  Its stream is torch's, not ``jax.random``'s: the
    same seed gives other masks than the reference's ``Trainer``.

    After each round, on rounds ``r % eval_every == 0`` and on the last
    round of a :meth:`run` (``eval_every=0``: the last round only),
    ``eval_fn(params)`` runs under ``torch.no_grad()`` (JAX builds no tape
    for a plain call; this is the same, and it lets the flash kernel,
    which has no backward, run) and its values merge into the round's
    record as floats.  Then each callback runs as ``cb(round_idx, params,
    record)``, and every ``log_every`` rounds (and on the last)
    ``log_fn`` gets ``round   r loss x.xxxx`` plus the record's other
    scalars (on rank 0 alone, under an initialised ``torch.distributed``
    world: a mesh round's ranks run the same trainer, and their records
    are equal).  ``start_round`` resumes a restored schedule mid-way.
    """

    fed: Any
    params: Dict[str, torch.Tensor]
    rng: Optional[int] = None
    server_opt: Any = None                # overrides fed.server_opt
    callbacks: Sequence[Callable] = ()
    eval_fn: Optional[Callable] = None    # (params) -> {name: scalar}
    eval_every: int = 0                   # 0 = the last round only
    log_every: int = 0                    # 0 = silent
    log_fn: Callable = print
    start_round: int = 0                  # resume mid-schedule

    round_idx: int = field(default=0, init=False)
    history: List[Dict] = field(default_factory=list, init=False)
    generator: Any = field(default=None, init=False)
    opt_state: Any = field(default=None, init=False)

    def __post_init__(self):
        if self.server_opt is None:
            self.server_opt = getattr(self.fed, "server_opt", None)
        dev = self.fed.device
        wrong = [k for k, v in self.params.items() if v.device != dev]
        if wrong:
            raise ValueError(f"params {wrong[:3]} are not on the round's "
                             f"device {dev}")
        self.round_idx = self.start_round
        self.generator = None          # a plan on meta draws without one
        if dev.type != "meta":
            self.generator = torch.Generator(dev).manual_seed(
                0 if self.rng is None else int(self.rng))
        if self.server_opt is not None:
            self.opt_state = self.server_opt.init(self.params)

    def step(self, batch, round_kwargs=None):
        """Run exactly one round on ``batch``; returns the history record."""
        r, kw = self.round_idx, dict(round_kwargs or {})
        kw.setdefault("generator", self.generator)
        batch = {k: _to_device(v, self.fed.device) for k, v in batch.items()}
        if self.server_opt is None:
            self.params, metrics = self.fed.round(self.params, batch, r, **kw)
        else:
            self.params, self.opt_state, metrics = \
                self.fed.round_with_server_opt(self.params, self.opt_state,
                                               batch, r, self.server_opt,
                                               **kw)
        self.round_idx += 1
        return {"round": r, **metrics}

    def run(self, batch_iter, n_rounds):
        """Train for ``n_rounds``; returns ``(params, history)``."""
        batch_iter = iter(batch_iter)
        last = self.round_idx + n_rounds - 1
        for _ in range(n_rounds):
            item = next(batch_iter)
            batch, kw = item if isinstance(item, tuple) else (item, None)
            rec = self.step(batch, kw)
            r = rec["round"]
            if self.eval_fn and (r == last or (
                    self.eval_every and r % self.eval_every == 0)):
                with torch.no_grad():
                    rec.update({k: float(v) for k, v in
                                self.eval_fn(self.params).items()})
            self.history.append(rec)
            for cb in self.callbacks:
                cb(r, self.params, rec)
            if self.log_every and (r % self.log_every == 0 or
                                   r == last) and is_writer():
                extras = " ".join(f"{k} {float(v):.4f}"
                                  for k, v in rec.items()
                                  if k not in ("round", "loss")
                                  and np.ndim(v) == 0)
                self.log_fn(f"round {r:4d} loss {float(rec['loss']):.4f}"
                            + (f"  {extras}" if extras else ""))
        return self.params, self.history

    @property
    def losses(self) -> List[float]:
        return [float(h["loss"]) for h in self.history]


def checkpoint_callback(path, every=0, meta=None):
    """Trainer callback that checkpoints params (and the running loss
    history) in the reference's file layout (:mod:`repro_torch.checkpoint.
    checkpoint`); ``every=0`` saves on every call, ``every=N`` on rounds
    ``r % N == 0``.  The metadata's ``round`` is the next round to run."""
    losses: List[float] = []

    def cb(round_idx, params, record):
        losses.append(float(record["loss"]))
        if every and round_idx % every != 0:
            return
        save(path, params, {**(meta or {}), "round": round_idx + 1,
                            "history": losses})

    return cb


def _to_device(v, device):
    """A batch leaf on ``device``: integer leaves (tokens, labels) as
    int64, float leaves in their own dtype."""
    t = torch.as_tensor(v)
    if t.is_floating_point():
        return t.to(device)
    return t.to(device, dtype=torch.long)
