"""Activation-sharding context.

Ports ``ActivationPolicy``, ``current_policy``, ``activation_policy``,
``constrain``, ``default_rules`` and ``cp_rules`` of
``repro/sharding/ctx.py``.  Launch code installs a policy (mesh +
semantic->mesh-axis rules) and :meth:`ActivationPolicy.spec` gives an
activation's spec (a tuple of mesh-axis entries, as ``policy.leaf_spec``'s),
but :func:`constrain` returns its input: eager PyTorch has no partitioner
to annotate, and the port's mesh round splits clients by hand.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

_STATE = threading.local()


class ActivationPolicy:
    def __init__(self, mesh, rules: dict):
        """rules: semantic axis name -> mesh axis (str | tuple | None)."""
        self.mesh = mesh
        self.rules = dict(rules)

    def spec(self, axes) -> tuple:
        entries, used = [], set()
        for a in axes:
            cand = self.rules.get(a) if a else None
            flat = cand if isinstance(cand, tuple) else (cand,)
            if cand is None or any(c in used for c in flat):
                entries.append(None)
            else:
                entries.append(cand)
                used.update(flat)
        return tuple(entries)


def current_policy() -> Optional[ActivationPolicy]:
    return getattr(_STATE, "policy", None)


@contextlib.contextmanager
def activation_policy(policy: Optional[ActivationPolicy]):
    prev = current_policy()
    _STATE.policy = policy
    try:
        yield
    finally:
        _STATE.policy = prev


def constrain(x, *axes):
    """The reference's activation annotation: returns ``x``."""
    return x


# default rule-sets -----------------------------------------------------------

def default_rules(multi_pod: bool = False) -> dict:
    data = ("pod", "data") if multi_pod else "data"
    return {
        "batch": data, "clients": data, "seq": None, "cache_seq": None,
        "d_model": None, "heads": "model", "kv_heads": "model",
        "d_ff": "model", "moe_d_ff": "model", "experts": "model",
        "vocab": "model", "ssm_heads": None,
    }


def cp_rules(multi_pod: bool = False) -> dict:
    """long-context decode: KV cache sequence sharded over the data axis."""
    r = default_rules(multi_pod)
    r["cache_seq"] = ("pod", "data") if multi_pod else "data"
    r["batch"] = None           # global_batch=1 — cannot shard
    return r
