"""Where kernel launches and collectives report their work to counters.

The kernel wrappers of ``repro_torch.kernels`` report a launch's declared
``(flops, hbm_bytes, rate_class)`` (each module's ``cost()``) through
:func:`declare`, and ``sharding/spmd.py``'s collectives report the bytes
one rank moves through :func:`collective`, to every counter in
:data:`ACTIVE`.  ``analysis.cost.Counter`` enters itself there while it
counts.  Callers test ``ACTIVE`` before they work out a cost, so a launch
outside a counter pays nothing for the bookkeeping.
"""
from __future__ import annotations

from typing import List

#: the counters counting now (``analysis.cost.Counter``), innermost last
ACTIVE: List = []


def declare(name: str, flops: float, nbytes: float, klass: str,
            dot: bool = True):
    """A kernel launch's declared work, added to every active counter:
    ``flops`` at rate class ``klass``, ``nbytes`` of HBM traffic; ``dot``
    marks the product kernels (their FLOPs join the dot-and-convolution
    count)."""
    for c in list(ACTIVE):
        c.declared(name, flops, nbytes, klass, dot)


def collective(kind: str, nbytes: float):
    """A collective's bytes on one rank (the ring model's), added to every
    active counter under ``kind`` (``all-gather`` / ``all-reduce``)."""
    for c in list(ACTIVE):
        c.collective(kind, nbytes)


def ring_bytes(kind: str, in_bytes: float, out_bytes: float,
               group: int) -> float:
    """``hlo_cost.py`` ``_collective_bytes``: the bytes one rank moves."""
    if group <= 1:
        return 0.0
    if kind == "all-gather":
        return max(out_bytes - in_bytes, out_bytes * (group - 1) / group)
    if kind == "all-reduce":
        return 2.0 * in_bytes * (group - 1) / group
    raise ValueError(f"unknown collective {kind!r}")
