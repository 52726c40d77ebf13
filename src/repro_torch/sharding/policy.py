"""Parameter sharding policy, from the same semantic axis tags that drive
sub-model windowing.

Ports ``default_param_rules``, ``leaf_spec``, ``param_specs``,
``round_input_shardings`` and ``constrain_tree`` of
``repro/sharding/policy.py`` as pure functions.  A spec is a tuple with one
entry per dim: a mesh-axis name, a tuple of names, or None (the entries of
the reference's ``PartitionSpec``).  Rules map axis tag -> mesh axis; a
leaf dim is sharded only if the mesh axis divides it and is not already
used by an earlier dim of the same leaf (first match wins).

The port shards nothing by spec: its mesh round gives each rank its block
of clients and replicates the server params (``core/fedavg.py``), and
eager PyTorch has no partitioner to annotate, so :func:`constrain_tree`
returns its input.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.sharding.spmd import axis_size

Spec = Tuple


def default_param_rules(multi_pod: bool = False, fsdp: bool = True) -> dict:
    data = ("pod", "data") if multi_pod else "data"
    rules = {
        "vocab": "model",
        "d_ff": "model", "moe_d_ff": "model",
        "heads": "model", "kv_heads": "model",
        "experts": "model",
        "ssm_heads": "model",
        "mla_q_rank": "model",
        "channels": None,
        "clients": data,
    }
    if fsdp:
        rules["d_model"] = data          # ZeRO-3-style shard of the residual dim
    return rules


def leaf_spec(shape, axes, rules, mesh) -> Spec:
    """The spec of one leaf of ``shape`` tagged ``axes``."""
    entries, used = [], set()
    for dim, name in zip(shape, axes):
        cand = rules.get(name)
        flat = cand if isinstance(cand, tuple) else (cand,)
        if (cand is None or any(c in used for c in flat)
                or dim % axis_size(mesh, cand) != 0
                or axis_size(mesh, cand) > dim):
            entries.append(None)
        else:
            entries.append(cand)
            used.update(flat)
    return tuple(entries)


def param_specs(abstract, axes, rules, mesh) -> Dict[str, Spec]:
    """``{path: spec}`` for the port's flat ``{path: shape}`` and ``{path:
    axis tags}``."""
    return {k: leaf_spec(tuple(s), axes[k], rules, mesh)
            for k, s in abstract.items()}


def round_input_shardings(mesh, axis, abstract, batch):
    """The specs of a mesh round's inputs: server params replicated (every
    rank trains its clients against the same full model), batch leaves
    ``[K, C, ...]`` split on the client ``axis``.  Returns ``(param specs,
    batch specs)``."""
    return ({k: () for k in abstract},
            {k: (None, axis) for k in batch})


def constrain_tree(tree, axes, leading=("clients",)):
    """The reference's sharding constraint on a (client-stacked) tree: a
    no-op here, where eager PyTorch has no partitioner to annotate."""
    return tree
