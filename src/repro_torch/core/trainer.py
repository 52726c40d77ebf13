"""The training loop over federated rounds.

Ports ``Trainer.step``, ``Trainer.run`` and ``Trainer.losses`` of
``repro/core/trainer.py`` (no eval, logging, checkpoint or server-optimizer
callbacks yet).  Batch iterators yield a batch dict (numpy or torch leaves
``[K, C, ...]``) or a ``(batch, round_kwargs)`` pair whose kwargs go to the
round, e.g. ``{"offsets": ...}`` to inject window offsets, ``{"masks":
...}`` to inject masks or ``{"capacities": [...]}`` for a mask round's
participants (the paper's protocol passes them so).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch


@dataclass
class Trainer:
    """Drives ``fed.round`` for N rounds on ``fed.device``::

        fed = api.fed_round(model, scfg)
        trainer = api.Trainer(fed, params)
        params, history = trainer.run(batches, n_rounds=3)

    The round updates ``params`` in place.  ``history`` keeps per-round
    metric records as device tensors; :attr:`losses` reads them once.
    ``rng`` (an int seed; None is 0) seeds one ``torch.Generator`` on the
    round's device, which every round draws its masks from
    (``generator=``).  Its stream is torch's, not ``jax.random``'s: the
    same seed gives other masks than the reference's ``Trainer``.
    """

    fed: Any
    params: Dict[str, torch.Tensor]
    rng: Optional[int] = None

    round_idx: int = field(default=0, init=False)
    history: List[Dict] = field(default_factory=list, init=False)
    generator: Any = field(default=None, init=False)

    def __post_init__(self):
        dev = self.fed.device
        wrong = [k for k, v in self.params.items() if v.device != dev]
        if wrong:
            raise ValueError(f"params {wrong[:3]} are not on the round's "
                             f"device {dev}")
        self.generator = torch.Generator(dev).manual_seed(
            0 if self.rng is None else int(self.rng))

    def step(self, batch, round_kwargs=None):
        """Run exactly one round on ``batch``; returns the history record."""
        r, kw = self.round_idx, dict(round_kwargs or {})
        kw.setdefault("generator", self.generator)
        batch = {k: _to_device(v, self.fed.device) for k, v in batch.items()}
        self.params, metrics = self.fed.round(self.params, batch, r, **kw)
        self.round_idx += 1
        return {"round": r, **metrics}

    def run(self, batch_iter, n_rounds):
        """Train for ``n_rounds``; returns ``(params, history)``."""
        batch_iter = iter(batch_iter)
        for _ in range(n_rounds):
            item = next(batch_iter)
            batch, kw = item if isinstance(item, tuple) else (item, None)
            self.history.append(self.step(batch, kw))
        return self.params, self.history

    @property
    def losses(self) -> List[float]:
        return [float(h["loss"]) for h in self.history]


def _to_device(v, device):
    """A batch leaf on ``device``: integer leaves (tokens, labels) as
    int64, float leaves in their own dtype."""
    t = torch.as_tensor(v)
    if t.is_floating_point():
        return t.to(device)
    return t.to(device, dtype=torch.long)
