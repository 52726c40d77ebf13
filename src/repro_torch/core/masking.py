"""Sub-model window schemes.

Ports ``collect_axis_dims``, ``capacity_size``, ``WindowScheme`` (sizes,
grids, GQA-derived axes, ``grid_multiple``, ``offsets``,
``importance_offsets``) and ``make_scheme`` of ``repro/core/masking.py``
for every scheme: ``full``, ``static``, ``rolling`` (shared or staggered),
``random`` and ``importance`` (shared or staggered).  Offsets are host
integers, one per client.

The rolling permutation of epoch ``e`` comes from a ``torch.Generator``
seeded by ``(cfg.seed, e)``, and the ``random`` offsets of axis ``i`` from
one seeded by ``(cfg.seed, round, i)``; both are other draws than the
reference's ``jax.random`` ones (``masking.py:167, 182-187``), so the round
also accepts injected offsets, which is how the tests hold it against the
reference.  The grids, and so the set of windows an epoch visits, are the
same, and ``importance`` (no random draw) gives the reference's offsets.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import SubmodelConfig

AxisKey = Tuple[str, int]  # (semantic name, full dim size)

NEVER_WINDOWED = {"layers", "vocab", "classes", "head_dim", "ssm_head_dim",
                  "ssm_state", "conv_w", "conv_kh", "conv_kw", "mla_q_rank",
                  "mla_kv_rank", "rope_dim", "v_head_dim", "codebooks",
                  "vision_d", "none"}


def collect_axis_dims(shapes, axes) -> Dict[AxisKey, None]:
    """Every (axis name, size) pair in the model; ``shapes`` and ``axes``
    are flat ``{path: ...}`` dicts."""
    dims: Dict[AxisKey, None] = {}
    for path, shape in shapes.items():
        for d, name in zip(shape, axes[path]):
            if name not in NEVER_WINDOWED:
                dims[(name, int(d))] = None
    return dims


def _align_down(x, a):
    return (x // a) * a


def capacity_size(capacity: float, n: int, align: int) -> int:
    """Window length for an axis of size ``n`` at fraction ``capacity``,
    aligned down to ``align`` (never below one aligned block, never above
    ``n``)."""
    a = min(align, n)
    w = max(a, _align_down(int(round(capacity * n)), a))
    return min(w, n)


def seeded_generator(seed: int, *ks: int, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded by the tuple ``(seed,
    *ks)`` (an epoch; a round; a round and an axis); None on ``meta``,
    where a draw makes shapes only and takes no generator."""
    s = int(seed)
    for k in ks:
        s = (s * 1_000_003 + int(k)) % (1 << 63)
    if torch.device(device).type == "meta":
        return None        # a plan: meta draws take no generator
    return torch.Generator(device).manual_seed(s)


def _epoch_permutation(seed: int, epoch: int, n: int) -> List[int]:
    return torch.randperm(n, generator=seeded_generator(seed, epoch)).tolist()


@dataclass
class WindowScheme:
    """Resolved window plan for one (model, SubmodelConfig) pair."""

    cfg: SubmodelConfig
    sizes: Dict[AxisKey, int]                    # static window length
    grids: Dict[AxisKey, List[int]]              # rolling offset grid [R]
    derived: Dict[AxisKey, Tuple[AxisKey, int]]  # heads <- (kv_heads, group)
    n_windows: int                               # R

    def importance_offsets(self, params, axes, n_clients
                           ) -> Dict[AxisKey, List[int]]:
        """Data-dependent offsets from the live ``params`` (``{path:
        tensor}``): per primary axis, the grid window of the largest
        squared-weight mass, shared by every client; with ``stagger`` the
        grid windows ranked by mass (a stable sort, so client 0 keeps the
        largest) and client ``i`` on the ``i``-th (mod R).  A unit's mass
        sums over every leaf that carries its axis (the per-layer leaves
        stand in for the reference's stacked ``layers`` axis), in
        float32; derived ``heads`` follow ``kv_heads`` times the group."""
        mass: Dict[AxisKey, torch.Tensor] = {}
        for path, t in params.items():
            for d, name in enumerate(axes[path]):
                key = (name, int(t.shape[d]))
                if key not in self.sizes or key in self.derived:
                    continue
                other = [i for i in range(t.dim()) if i != d]
                contrib = torch.sum(torch.square(t.float()), dim=other)
                mass[key] = contrib if key not in mass else mass[key] + contrib
        out = {}
        for key, m in mass.items():
            w = self.sizes[key]
            csum = torch.cat([m.new_zeros(1), torch.cumsum(m, 0)])
            grid = torch.as_tensor(self.grids[key], device=m.device)
            window_mass = (csum[w:] - csum[:-w])[grid]
            if m.device.type == "meta":
                # a plan: the mass is unknown, the windows' shapes are not;
                # the grid's offsets in order stand in for the ranking
                g = self.grids[key]
                out[key] = [g[i % len(g) if self.cfg.stagger else 0]
                            for i in range(n_clients)]
            elif self.cfg.stagger:
                order = torch.argsort(-window_mass, stable=True).tolist()
                out[key] = [self.grids[key][order[i % len(order)]]
                            for i in range(n_clients)]
            else:
                best = self.grids[key][int(torch.argmax(window_mass))]
                out[key] = [best] * n_clients
        for k, (src, group) in self.derived.items():
            out[k] = [o * group for o in out[src]]
        return out

    def grid_multiple(self, key: AxisKey) -> int:
        """The gcd of every offset the scheme can produce for ``key`` (0
        when it is always 0).  The CUDA kernels take any offset, so the
        port needs no alignment certificate; this mirrors the reference's
        plan for comparison."""
        if key in self.derived:
            src, group = self.derived[key]
            return self.grid_multiple(src) * group
        if self.cfg.scheme in ("full", "static"):
            return 0
        if self.cfg.scheme == "random":
            return max(self.cfg.align, 1)   # offsets are align multiples
        return int(np.gcd.reduce(np.asarray(self.grids[key])))

    def offsets(self, round_idx: int, n_clients: int
                ) -> Dict[AxisKey, List[int]]:
        """Per-client offsets ``{axis: [C] ints}`` for this round: 0 for
        ``full``/``static``; the epoch's permuted grid for ``rolling``
        (staggered: client c on the epoch's ``(r + c)``-th window, the
        reference's ``perm[(r + c) % R]``); the first grid window for
        ``importance`` without params (the round passes them to
        :meth:`importance_offsets`); ``randint(0, (n - w) // align + 1) *
        align`` per client for ``random``."""
        c = self.cfg
        prim = [k for k in self.sizes if k not in self.derived]
        out = {}
        if c.scheme in ("full", "static"):
            for k in prim:
                out[k] = [0] * n_clients
        elif c.scheme == "rolling":
            R = self.n_windows
            r = round_idx % R
            perm = _epoch_permutation(c.seed, round_idx // R, R)
            # staggered: client c takes the epoch's (r + c)-th window
            idx = [perm[(r + i) % R] if c.stagger else perm[r]
                   for i in range(n_clients)]
            for k in prim:
                out[k] = [self.grids[k][j] for j in idx]
        elif c.scheme == "importance":
            for k in prim:
                out[k] = [self.grids[k][0]] * n_clients
        elif c.scheme == "random":
            for i, k in enumerate(prim):
                hi = max((k[1] - self.sizes[k]) // c.align + 1, 1)
                draw = torch.randint(0, hi, (n_clients,),
                                     generator=seeded_generator(
                                         c.seed, round_idx, i))
                out[k] = [int(o) * c.align for o in draw]
        else:
            raise ValueError(c.scheme)
        for k, (src, group) in self.derived.items():
            out[k] = [o * group for o in out[src]]
        return out


def make_scheme(submodel_cfg: SubmodelConfig, axis_dims) -> WindowScheme:
    c = submodel_cfg
    windowed = [(name, n) for (name, n) in axis_dims
                if name in c.axes and c.capacity < 1.0 and c.scheme != "full"]

    # GQA coupling: window kv_heads as primary, heads derived
    derived = {}
    kv_keys = {n: (name, n) for (name, n) in windowed if name == "kv_heads"}
    for (name, n) in windowed:
        if name == "heads":
            for kvn, kvk in kv_keys.items():
                if n % kvn == 0:
                    derived[(name, n)] = (kvk, n // kvn)

    sizes, grids = {}, {}
    for key in windowed:
        if key in derived:
            continue  # size derived below
        name, n = key
        a = min(c.align, n)
        w = capacity_size(c.capacity, n, c.align)
        sizes[key] = w
        R = max(1, math.ceil(n / w))
        if R == 1:
            grids[key] = [0]
            continue
        g = [_align_down(round(i * (n - w) / (R - 1)), a) for i in range(R)]
        g[-1] = n - w          # tail coverage: the exact last offset
        step = max(_align_down(w, a), a)
        out = [g[0]]
        for o in g[1:]:        # fill holes so the windows cover every unit
            if o == out[-1]:
                continue
            while o - out[-1] > w:
                out.append(out[-1] + step)
            out.append(o)
        grids[key] = out

    n_windows = max([len(g) for g in grids.values()] + [1])
    for k, g in grids.items():   # re-pad grids to a common R (cycle)
        if len(g) < n_windows:
            grids[k] = (g * math.ceil(n_windows / len(g)))[:n_windows]
    for k, (src, group) in derived.items():
        sizes[k] = sizes[src] * group
    return WindowScheme(cfg=c, sizes=sizes, grids=grids, derived=derived,
                        n_windows=n_windows)
