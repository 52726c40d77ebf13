"""The federated rounds: window mode (Algorithm 2) with one shared window,
per-client windows or none, and mask mode (Algorithm 1 and the paper's
protocol round), each with the plain server average or a server
optimizer.

Ports, from ``repro/core/fedavg.py``: ``resolve_shared_window``,
``WindowFedAvg`` (construction, ``_resolve_fused``, ``_client_offsets``,
``_fused_window``, ``_extract_clients``, ``_client_phase``,
``_client_phase_fused``, ``_apply_mean_delta``, ``_uplink``,
``_apply_mean_delta_fused``, ``_mean_delta_full``,
``_mean_delta_full_fused``, ``round`` and ``round_with_server_opt``),
the heterogeneous-capacity buckets (``CapacityBucket``, ``capacities``,
``_resolve_hetero``, ``_hetero_offsets``, ``_local_delta_sum``,
``_hetero_delta_sum``, ``_round_hetero`` and ``_hetero_phase_for``, the
cohort phase of the asynchronous fleet), the mesh round (``MESH_AGGS``,
``_client_phase_sharded``, ``_round_mesh``, ``_mean_delta_full_mesh``),
``_scatter_update``, ``dense_client_masks``, ``MaskFedAvg`` (with
``round_with_server_opt``), ``_build_mask_fed``, ``output_model`` and
``run_rounds``.

Clients are an explicit leading dimension ``[C, ...]`` of every leaf (the
reference vmaps them).  Window mode has two client phases, as the
reference's.  The fused one trains each client's copy of the FULL model
through the window-aware forward, so coordinates outside its window get
exactly zero gradient; the server adds the clients' mean change into the
shared window in place, or (per-client windows) sums the clients' full
changes, which are already their scattered forms.  The extract one
(Algorithm 2 as written) gives each client a compact copy of its own
window (a full replica when no axis is windowed, as under scheme
``full``), trains it through the model's ordinary loss and sends back
the change; the server averages the changes and scatters them into the
windows.  Both phases hand the server the clients' float32 changes.
Heterogeneous capacities split the clients into width buckets, each a
homogeneous round of its own (per-client arms), whose change sums are
added in bucket order before the one division by C.  In mask mode each
client's copy starts as ``w * m_c`` under a dense mask, its steps are
masked, and the server takes the fill-in average.  A server optimizer takes the full-shaped float32 mean change
instead, built one leaf at a time.  Batch leaves are ``[K, C, ...]``.

The mesh round splits the C clients over the ranks of a mesh axis
(``torch.distributed``, one process a rank): every rank takes the round's
whole batch and offsets, runs the ordinary fused or extract client phase on
its own contiguous block of C / S clients, and gathers the losses.  Under
``mesh_agg="gather"`` it gathers the clients' changes in client order and
replays the single-process aggregation, so the round is the ``mesh=None``
round bit for bit; under ``"psum"`` each rank sums its clients' scattered
changes and the ranks add their sums (the same values, reassociated).
Every rank ends the round with the same params.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import SubmodelConfig
from repro_torch.core import submodel as sm
from repro_torch.core.extract import extract, scatter_delta
from repro_torch.core.masking import (WindowScheme, collect_axis_dims,
                                      make_scheme, seeded_generator)
from repro_torch.core.server_opt import ServerOpt
from repro_torch.core.trainer import Trainer, _to_device
from repro_torch.models.layers import AxisWindow, WindowMap
from repro_torch.optim.client import ClientOpt, resolve_client_opt
from repro_torch.sharding import spmd

MESH_AGGS = ("gather", "psum")

_SHARED_WINDOW_SCHEMES = ("rolling", "static", "importance")


def resolve_shared_window(scfg: SubmodelConfig) -> bool:
    """``scfg.shared_window``, or (None) whether the scheme puts every
    client on the same window."""
    derived = scfg.scheme in _SHARED_WINDOW_SCHEMES and not scfg.stagger
    if scfg.shared_window is None:
        return derived
    if scfg.shared_window and not derived:
        raise ValueError(
            f"shared_window=True requires a shared-window scheme "
            f"({'/'.join(_SHARED_WINDOW_SCHEMES)}, stagger=False); got "
            f"scheme={scfg.scheme!r} stagger={scfg.stagger}")
    return scfg.shared_window


def _steps(params, batch, loss_fn, opt, lr):
    """K local steps on ``params`` (``{path: [C, ...]}``, trained in place)
    over batch leaves ``[K, C, ...]``; ``loss_fn(params, step batch)``
    returns ``([C], aux)``.  Returns the losses ``[K, C]``."""
    for v in params.values():
        v.requires_grad_()
    state = opt.init(params)
    losses = []
    for k in range(next(iter(batch.values())).shape[0]):
        loss, _ = loss_fn(params, {name: v[k] for name, v in batch.items()})
        # summing the per-client losses gives each client its own grad
        grads = torch.autograd.grad(loss.sum(), list(params.values()))
        with torch.no_grad():
            params, state = opt.update(params, dict(zip(params, grads)),
                                       state, lr)
        del grads
        losses.append(loss.detach())
    for v in params.values():
        v.requires_grad_(False)
    return torch.stack(losses)


@dataclass(frozen=True)
class CapacityBucket:
    """One width class of a heterogeneous-capacity round: the clients whose
    capacity is ``beta`` (``idx``, their lanes in the round's client axis,
    ascending) and ``fed``, a homogeneous :class:`WindowFedAvg` clone at
    ``scfg.capacity = beta`` with ``clients_per_round = len(idx)`` and
    per-client aggregation.  Each bucket's computation is that of an
    independently built homogeneous round at ``beta``."""

    beta: float
    idx: Any            # tuple of C_b client lanes, ascending
    fed: Any            # homogeneous WindowFedAvg at this beta


@dataclass
class WindowFedAvg:
    loss_fn: Callable                 # (params, batch) -> ([C], aux)
    scfg: SubmodelConfig
    abstract: Dict[str, torch.Size]   # {path: full shape}
    axes: Dict[str, tuple]            # {path: axis tags}
    scheme: WindowScheme
    device: torch.device
    client_opt: Optional[ClientOpt] = None
    server_opt: Optional[ServerOpt] = None    # the Trainer steps with it
    # loss_fn(params, batch, window=WindowMap): the fused client phase runs
    # it; None (a loss without window=) leaves the extract phase only
    windowed_loss_fn: Optional[Callable] = None
    fused_forward: Any = "auto"       # "auto" | True/"on" | False/"off"
    # per-client window fractions beta_c in (0, 1], [clients_per_round];
    # None (or every beta_c == scfg.capacity): the homogeneous round.
    # Otherwise the clients are bucketed by beta (CapacityBucket), each
    # bucket runs its own homogeneous client phase, and the float32 sums of
    # the buckets' changes are added in bucket order before the one / C
    capacities: Any = None
    # "bf16": each client's change crosses the simulated uplink as
    # bfloat16 and is widened to float32 before the mean (the fused arms
    # only, as in the reference); None: the exact float32 uplink
    uplink_compression: Optional[str] = None
    # The mesh round: ``mesh`` (a DeviceMesh over the initialised world;
    # None = one process) splits the clients over its axis ``spmd_axis``
    # (resolved by api.fed_round; without a mesh it pins nothing here, where
    # no vmap runs), and ``mesh_agg`` crosses ranks: "gather" (the changes
    # gathered in client order, then the single-process aggregation, bit for
    # bit) or "psum" (each rank's float32 sum of its clients' scattered
    # changes, added over the ranks: the same values, reassociated)
    spmd_axis: Any = None
    mesh: Any = None
    mesh_agg: str = "gather"

    def __post_init__(self):
        self.hetero = None
        if self.uplink_compression not in (None, "bf16"):
            raise ValueError(
                "uplink_compression must be None (exact f32 uplink) or "
                f"'bf16'; got {self.uplink_compression!r}")
        self.client_opt = resolve_client_opt(self.client_opt)
        if self.capacities is not None:
            self._resolve_hetero()
        if self.hetero is None:
            self.shared_window = resolve_shared_window(self.scfg)
        self.use_fused = self._resolve_fused()

    def _resolve_hetero(self):
        """Check ``capacities`` and build the width buckets, in descending
        beta, with the reference's errors.  Uniform capacities at
        ``scfg.capacity`` keep the plain round (``hetero`` stays None)."""
        c = self.scfg
        caps = np.asarray(self.capacities, np.float64).reshape(-1)
        if caps.shape[0] != c.clients_per_round:
            raise ValueError(
                f"capacities must have length clients_per_round="
                f"{c.clients_per_round}; got {caps.shape[0]}")
        if np.any(caps <= 0.0) or np.any(caps > 1.0):
            raise ValueError(
                "window-mode capacities are per-client window fractions "
                f"in (0, 1]; got {np.asarray(self.capacities)}")
        if self.mesh is not None:
            raise ValueError(
                "capacities= (heterogeneous windows) and mesh= are "
                "mutually exclusive: bucket batch slices break the static "
                "per-shard client count; drive heterogeneous fleets "
                "through AsyncTrainer/FleetSimulator instead")
        if c.scheme == "full":
            raise ValueError(
                "capacities have no effect under scheme='full' (every "
                "client trains the full model); drop capacities= or pick "
                "a windowed scheme")
        self.capacities = tuple(float(b) for b in caps)
        if np.all(caps == c.capacity):
            return
        if c.shared_window:
            raise ValueError(
                "shared_window=True is incompatible with heterogeneous "
                "capacities (clients train different window *sizes*, so "
                "no single window is shared); leave shared_window unset")
        self.shared_window = False    # per-client aggregation only
        dims = collect_axis_dims(self.abstract, self.axes)
        buckets = []
        for beta in sorted(set(self.capacities), reverse=True):
            idx = tuple(int(i) for i in np.nonzero(caps == beta)[0])
            bscfg = replace(c, capacity=float(beta),
                            clients_per_round=len(idx), shared_window=False)
            # beta = 1.0 windows nothing, which fused_forward="on" would
            # refuse: such a bucket resolves "auto" (the extract phase on a
            # full replica)
            bfed = replace(
                self, scfg=bscfg, scheme=make_scheme(bscfg, dims),
                capacities=None,
                fused_forward=self.fused_forward if beta < 1.0 else "auto")
            buckets.append(CapacityBucket(beta=float(beta), idx=idx,
                                          fed=bfed))
        self.hetero = buckets

    def _resolve_fused(self) -> bool:
        """Whether the round takes the fused client phase (every properly
        windowed axis has a fused forward) or the extract one, as the
        reference resolves it, for shared and per-client windows alike."""
        want = self.fused_forward
        if want not in (True, "on", False, "off", "auto", None):
            raise ValueError(f"fused_forward must be 'auto', 'on'/True or "
                             f"'off'/False; got {want!r}")
        if want in (False, "off"):
            return False
        # proper windows only (size < full dim): improper ones are no-ops
        proper = {k: w for k, w in self.scheme.sizes.items() if w < k[1]}
        reasons = []
        if self.windowed_loss_fn is None:
            reasons.append("the model exposes no windowed forward "
                           "(loss(params, batch, window=...))")
        if not proper:
            reasons.append("no axis is actually windowed (nothing to fuse)")
        unsupported = [k for k in proper if k[0] not in WindowMap.SUPPORTED]
        if unsupported:
            reasons.append(f"axes {sorted(unsupported)} have no fused "
                           f"window-aware forward (supported: "
                           f"{WindowMap.SUPPORTED})")
        # GQA coupling: a heads window must derive from the kv_heads one
        uncoupled = [k for k in proper
                     if k[0] == "heads" and k not in self.scheme.derived]
        if uncoupled and any(name == "kv_heads" for name, _ in
                             collect_axis_dims(self.abstract, self.axes)):
            reasons.append(f"heads windows {sorted(uncoupled)} are not "
                           "GQA-derived from a kv_heads window")
        if reasons:
            if want in (True, "on"):
                raise ValueError("fused_forward=True requires: "
                                 + "; ".join(reasons))
            return False
        self._fused_keys = proper
        return True

    # -- round phases ---------------------------------------------------------

    def _client_offsets(self, round_idx, params=None):
        """The scheme's offsets ``{axis: [C] ints}`` for this round;
        ``importance`` reads them off the live ``params``; heterogeneous
        rounds give the union of their buckets' draws."""
        C = self.scfg.clients_per_round
        if self.hetero is not None:
            return self._hetero_offsets(round_idx, params)
        if self.scfg.scheme == "importance":
            if params is None:
                raise ValueError("importance offsets need the round's params")
            return self.scheme.importance_offsets(params, self.axes, C)
        return self.scheme.offsets(round_idx, C)

    def _check_offsets(self, offsets):
        """Injected offsets ``{axis: [C] ints}``: the scheme's axes, one
        in-range window start per client, the same for every client when
        the window is shared.  Heterogeneous rounds take the union vector:
        each lane holds its own bucket's window start, and 0 on an axis its
        bucket does not window."""
        C = self.scfg.clients_per_round
        if self.hetero is None:
            plan = [(range(C), self.scheme.sizes)]
        else:
            plan = [(b.idx, b.fed.scheme.sizes) for b in self.hetero]
        names = set().union(*(sizes for _, sizes in plan))
        if set(offsets) != names:
            raise ValueError(f"offsets name axes {sorted(offsets)}; the "
                             f"scheme windows {sorted(names)}")
        out = {}
        for k, v in offsets.items():
            v = [int(o) for o in v]
            ok = len(v) == C and all(
                (0 <= v[i] <= k[1] - sizes[k]) if k in sizes else v[i] == 0
                for lanes, sizes in plan for i in lanes)
            if not ok or (self.shared_window and len(set(v)) != 1):
                raise ValueError(
                    f"offsets {v} for {k} are not {C} in-range window starts"
                    + (" shared by every client" if self.shared_window
                       else ""))
            out[k] = v
        return out

    def _fused_window(self, offsets) -> WindowMap:
        return WindowMap({k: AxisWindow(offsets[k], w)
                          for k, w in self._fused_keys.items()})

    @staticmethod
    def _one(offsets, c):
        """Client ``c``'s offsets ``{axis: int}``."""
        return {k: v[c] for k, v in offsets.items()}

    # -- heterogeneous capacities: the bucket loop ----------------------------

    def _hetero_offsets(self, round_idx, params=None):
        """The union offset vectors ``{axis: [C]}`` of the buckets' draws:
        each lane its own bucket's window start (a bucket's draw is that of
        an independently built homogeneous round at its beta), 0 on the
        axes its bucket does not window (beta = 1.0)."""
        C = self.scfg.clients_per_round
        out = {}
        for b in self.hetero:
            for k, v in b.fed._client_offsets(round_idx, params).items():
                base = out.setdefault(k, [0] * C)
                for lane, o in zip(b.idx, v):
                    base[lane] = int(o)
        return out

    def _bucket_parts(self, params, batch, lanes_of, offsets, round_idx):
        """Each bucket's client phase on its lanes of ``batch`` (``lanes_of
        (b)``: the batch columns, in the bucket's lane order): yields
        ``(bucket, columns, delta, losses, offsets, fused)``.  Offsets come
        from ``offsets`` (the union vector, indexed by the same columns) or
        from the bucket's own draw."""
        for b in self.hetero:
            cols = lanes_of(b)
            if not cols:
                continue
            index = torch.as_tensor(cols, device=self.device)
            bb = {k: v.index_select(1, index.to(v.device))
                  for k, v in batch.items()}
            if offsets is None:
                boff = b.fed._client_offsets(round_idx, params)
            else:
                boff = {k: [offsets[k][j] for j in cols]
                        for k in b.fed.scheme.sizes}
            fused = b.fed.use_fused and bool(boff)
            phase = b.fed._client_phase_fused if fused else b.fed._client_phase
            delta, losses = phase(params, bb, boff)
            yield b, cols, delta, losses, boff, fused

    def _local_delta_sum(self, delta, offsets, fused):
        """The float32 sum over clients of their scattered changes (no / C),
        in client order, one leaf at a time (each leaf's client changes are
        freed as it is done): fused changes are already full-shaped, with
        zeros outside each window; extract ones are scattered first."""
        out = {}
        for path in list(delta):
            d = delta.pop(path)
            acc = torch.zeros(tuple(self.abstract[path]), dtype=torch.float32,
                              device=d.device)
            for ci in range(d.shape[0]):
                acc += d[ci] if fused else scatter_delta(
                    {path: d[ci]}, self.abstract, self.axes,
                    self._one(offsets, ci), self.scheme.sizes)[path]
            del d
            out[path] = acc
        return out

    def _hetero_delta_sum(self, params, batch, round_idx, offsets=None):
        """The float32 sum of every client's scattered change (no / C),
        accumulated bucket by bucket in descending beta, and the losses
        ``[K, C]`` put back in client order.  Each bucket runs its own
        homogeneous client phase on its lanes and adds its
        :meth:`_local_delta_sum`."""
        acc = {k: torch.zeros(tuple(s), dtype=torch.float32,
                              device=self.device)
               for k, s in self.abstract.items()}
        parts, order = [], []
        for b, cols, delta, losses, boff, fused in self._bucket_parts(
                params, batch, lambda b: list(b.idx), offsets, round_idx):
            for k, p in b.fed._local_delta_sum(delta, boff, fused).items():
                acc[k] += p
            del delta
            parts.append(losses)
            order += cols
        inv = torch.as_tensor(np.argsort(order), device=parts[0].device)
        return acc, torch.cat(parts, 1).index_select(1, inv)

    def _round_hetero(self, params, batch, round_idx, offsets=None):
        """One heterogeneous-capacity round: the bucket loop, then the
        per-client arm's update ``w + server_lr * (sum of the clients'
        scattered changes) / C``, in place, and the projection."""
        c = self.scfg
        acc, losses = self._hetero_delta_sum(params, batch, round_idx,
                                             offsets)
        with torch.no_grad():
            for path, w in params.items():
                d = acc.pop(path)
                w.copy_((w.float() + c.server_lr * d / c.clients_per_round)
                        .to(w.dtype))
                del d
            sm.project_l2(params, c.proj_radius)
        return params, {"loss": losses.mean(), "client_loss": losses}

    def _hetero_phase_for(self, slots):
        """The client phase of a lane subset of a heterogeneous cohort (the
        asynchronous fleet's dispatch).  ``slots`` are client lanes; the
        returned ``phase(params, batch, offsets)`` takes batch leaves ``[K,
        m, ...]`` and the union offsets sliced to the cohort ``{axis: [m]}``
        (both in slot order) and returns full-shaped float32 client changes
        ``{path: [m, ...]}`` (zeros outside each client's window; extract
        buckets' changes scattered per client) and the losses ``[K, m]``,
        in slot order."""
        slots = tuple(int(s) for s in slots)
        pos = {s: j for j, s in enumerate(slots)}

        def lanes_of(b):
            return [pos[lane] for lane in b.idx if lane in pos]

        def phase(params, batch, offsets):
            m = len(slots)
            out = {k: torch.empty((m, *s), dtype=torch.float32,
                                  device=self.device)
                   for k, s in self.abstract.items()}
            parts, order = [], []
            for b, cols, delta, losses, boff, fused in self._bucket_parts(
                    params, batch, lanes_of, offsets, None):
                index = torch.as_tensor(cols, device=self.device)
                for path in list(delta):
                    d = delta.pop(path)
                    if not fused and boff:
                        d = torch.stack([scatter_delta(
                            {path: d[i]}, self.abstract, self.axes,
                            b.fed._one(boff, i), b.fed.scheme.sizes)[path]
                            for i in range(len(cols))])
                    out[path].index_copy_(0, index, d)
                    del d
                parts.append(losses)
                order += cols
            inv = torch.as_tensor(np.argsort(order),
                                  device=parts[0].device)
            return out, torch.cat(parts, 1).index_select(1, inv)

        return phase

    # -- homogeneous phases and aggregation arms -------------------------------

    def _extract_clients(self, params, offsets, count=None):
        """Per-client compact sub-models ``{path: [C, *sub shape]}``,
        contiguous copies (the client steps update them in place): each
        client's own window, or with no offsets a full replica each.
        ``count`` overrides C."""
        C = self.scfg.clients_per_round if count is None else count
        if self.shared_window or not offsets:
            sub = extract(params, self.axes, self._one(offsets, 0),
                          self.scheme.sizes)
            return {k: v.unsqueeze(0).repeat(C, *([1] * v.dim()))
                    for k, v in sub.items()}
        subs = [extract(params, self.axes, self._one(offsets, c),
                        self.scheme.sizes) for c in range(C)]
        return {k: torch.stack([s[k] for s in subs]) for k in params}

    def _client_phase(self, params, batch, offsets):
        """extract -> K local steps through the ordinary ``loss_fn`` ->
        delta.  Returns the clients' float32 changes ``{path: [C, *sub
        shape]}`` (computed in place of their trained copies) and the
        losses ``[K, C]``."""
        C = next(iter(batch.values())).shape[1]       # every leaf [K, C, ...]
        sub = self._extract_clients(params, offsets, count=C)
        losses = _steps(sub, batch, self.loss_fn, self.client_opt,
                        self.scfg.client_lr)
        with torch.no_grad():
            delta = {k: v.float() for k, v in sub.items()}
            for c in range(C):
                sub_0 = extract(params, self.axes, self._one(offsets, c),
                                self.scheme.sizes)
                for k, d in delta.items():
                    d[c].sub_(sub_0[k].float())
        return delta, losses

    def _apply_mean_delta(self, params, delta, offsets):
        """Plain averaging (the paper's fill-in update, delta form), in
        place.  Shared window: the mean change over the delta's clients,
        then one in-place scatter.  Otherwise (per-client windows, or no
        windowed axis, where every scatter is the identity) the float32
        sum of the clients' scattered changes in client order, ``w +
        server_lr * sum / C`` with C the round's ``clients_per_round``
        (however many changes were handed in).  The extract arms take no
        uplink, as the reference's."""
        c = self.scfg
        if self.shared_window and offsets:
            dbar = {k: d.float().mean(0) for k, d in delta.items()}
            return _scatter_update(params, dbar, self.axes,
                                   self._one(offsets, 0), self.scheme.sizes,
                                   c.server_lr)
        for path, w in params.items():
            d = delta[path]
            acc = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
            for ci in range(d.shape[0]):
                acc += scatter_delta({path: d[ci]}, self.abstract,
                                     self.axes, self._one(offsets, ci),
                                     self.scheme.sizes)[path]
            w.copy_((w.float() + c.server_lr * acc / c.clients_per_round)
                    .to(w.dtype))
        return params

    def _mean_delta_full(self, params, delta, offsets):
        """The full-shaped float32 mean client delta (a server optimizer's
        pseudo-gradient, ``output_model``'s averaged gradient): the
        clients' mean, scattered into the shared window (no windowed axis:
        the mean itself); per-client windows: the sum of each client's
        scattered change over the round's C, in client order."""
        if not offsets:
            return {k: d.float().mean(0) for k, d in delta.items()}
        if self.shared_window:
            dbar = {k: d.float().mean(0) for k, d in delta.items()}
            return scatter_delta(dbar, self.abstract, self.axes,
                                 self._one(offsets, 0), self.scheme.sizes)
        C = self.scfg.clients_per_round
        out = {}
        for path, d in delta.items():
            acc = torch.zeros(tuple(self.abstract[path]), dtype=torch.float32,
                              device=d.device)
            for ci in range(d.shape[0]):
                acc += scatter_delta({path: d[ci]}, self.abstract, self.axes,
                                     self._one(offsets, ci),
                                     self.scheme.sizes)[path] / C
            out[path] = acc
        return out

    def _client_phase_fused(self, params, batch, offsets):
        """K client steps on per-client copies of the FULL model, through
        the window-aware forward; no compact copy of any leaf the kernels
        read.  Every client trains its own window (one offset per client:
        the windowed products take them all in one launch).  Returns the
        clients' full-shaped float32 changes ``{path: [C, ...]}``, exactly
        0 outside each client's window (float32 leaves subtract in place of
        the trained copies; others into a new float32 tensor), and the
        losses ``[K, C]``."""
        C = next(iter(batch.values())).shape[1]       # every leaf [K, C, ...]
        full = {k: v.unsqueeze(0).repeat(C, *([1] * v.dim()))
                for k, v in params.items()}
        window = self._fused_window(offsets)
        wloss = self.windowed_loss_fn
        losses = _steps(full, batch, lambda p, mb: wloss(p, mb, window=window),
                        self.client_opt, self.scfg.client_lr)
        with torch.no_grad():
            for k, w in params.items():
                if full[k].dtype == torch.float32:
                    full[k].sub_(w[None])
                else:
                    full[k] = full[k].float() - w.float()[None]
        return full, losses

    def _uplink(self, d):
        """A float32 client change as the server receives it: itself, or
        (``"bf16"``) rounded to bfloat16 and widened back to float32, one
        rounding per change, never a bfloat16 sum."""
        if self.uplink_compression is None:
            return d
        return d.to(torch.bfloat16).float()

    def _apply_mean_delta_fused(self, params, delta_full, offsets):
        """Aggregation of the fused phase's full-shaped changes, in place.
        Shared window: out-of-window coordinates of every change are exactly
        0, so the server extracts each client's window, takes the mean over
        the delta's clients and adds it into its window once.  Per-client
        windows: each client's full change already is its scattered form,
        so the sum over clients in client order, over the round's C, is the
        extract arm's scatter-add, one leaf at a time (each leaf's client
        changes are freed as it is done)."""
        c = self.scfg
        if self.shared_window:
            off0 = self._one(offsets, 0)
            sub = extract(delta_full, self.axes, off0, self.scheme.sizes,
                          lead=1)
            dbar = {k: self._uplink(sub[k]).mean(0) for k in params}
            return _scatter_update(params, dbar, self.axes, off0,
                                   self.scheme.sizes, c.server_lr)
        for path, w in params.items():
            d = delta_full.pop(path)
            acc = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
            for ci in range(d.shape[0]):
                acc += self._uplink(d[ci])
            del d
            w.copy_((w.float() + c.server_lr * acc / c.clients_per_round)
                    .to(w.dtype))
        return params

    def _mean_delta_full_fused(self, delta_full):
        """The server optimizer's pseudo-gradient from the fused phase,
        built one leaf at a time (each leaf's client changes are freed as
        it is done): the changes, through the uplink, are full-shaped with
        exact zeros outside each client's window; a shared window takes
        their mean, per-client windows the sum of each change over the
        round's C in client order (the extract arm's scatter-average)."""
        C = self.scfg.clients_per_round
        out = {}
        for path in list(delta_full):
            d = self._uplink(delta_full.pop(path))
            if self.shared_window:
                out[path] = d.mean(0)
            else:
                acc = torch.zeros(d.shape[1:], dtype=torch.float32,
                                  device=d.device)
                for ci in range(d.shape[0]):
                    acc += d[ci] / C
                out[path] = acc
            del d
        return out

    # -- the mesh round: the clients split over a mesh axis -------------------

    def _client_phase_sharded(self, params, batch, offsets):
        """The client phase of this rank's block of clients: the ``b``-th
        contiguous C / S of the round's batch (dim 1) and offsets, ``b``
        the rank's coordinate on the client axis (ranks along the other
        axes compute the same clients), through the ordinary fused or
        extract phase.  The losses are gathered to ``[K, C]``.  Crossing
        ranks, ``"gather"`` returns every client's change in client order
        (``{path: [C, ...]}``, the single-process phase's values), leaf by
        leaf; ``"psum"`` returns the float32 sum over all C clients of
        their scattered changes (``_local_delta_sum`` on each rank, added
        over the axis)."""
        mesh, axis = self.mesh, self.spmd_axis
        n = self.scfg.clients_per_round // spmd.axis_size(mesh, axis)
        lo = spmd.axis_index(mesh, axis) * n
        fused = self.use_fused and bool(offsets)
        local_batch = {k: v[:, lo:lo + n] for k, v in batch.items()}
        local_off = {k: v[lo:lo + n] for k, v in offsets.items()}
        phase = self._client_phase_fused if fused else self._client_phase
        delta, losses = phase(params, local_batch, local_off)
        losses = spmd.all_gather(mesh, axis, losses.t()).t().contiguous()
        with torch.no_grad():
            if self.mesh_agg == "psum":
                out = self._local_delta_sum(delta, local_off, fused)
                for v in out.values():
                    spmd.all_reduce_sum(mesh, axis, v)
                return out, losses
            return {path: spmd.all_gather(mesh, axis, delta.pop(path))
                    for path in list(delta)}, losses

    def _round_mesh(self, params, batch, offsets):
        """One round with the clients split over ``self.mesh``: ``psum``
        takes ``w + server_lr * sum / C`` (the per-client arm's update);
        ``gather`` the unchanged single-process aggregation."""
        c = self.scfg
        out, losses = self._client_phase_sharded(params, batch, offsets)
        with torch.no_grad():
            if self.mesh_agg == "psum":
                for path, w in params.items():
                    d = out.pop(path)
                    w.copy_((w.float() + c.server_lr * d / c.clients_per_round)
                            .to(w.dtype))
                    del d
            elif self.use_fused and offsets:
                self._apply_mean_delta_fused(params, out, offsets)
            else:
                self._apply_mean_delta(params, out, offsets)
            del out
            sm.project_l2(params, c.proj_radius)
        return params, {"loss": losses.mean(), "client_loss": losses}

    def _mean_delta_full_mesh(self, params, batch, offsets):
        """The sharded client phase and the full-shaped float32 mean change
        (the server optimizer's pseudo-gradient)."""
        out, losses = self._client_phase_sharded(params, batch, offsets)
        with torch.no_grad():
            if self.mesh_agg == "psum":
                dbar = {k: out.pop(k) / self.scfg.clients_per_round
                        for k in list(out)}
            elif self.use_fused and offsets:
                dbar = self._mean_delta_full_fused(out)
            else:
                dbar = self._mean_delta_full(params, out, offsets)
        return dbar, losses

    def round(self, params, batch, round_idx, generator=None, offsets=None):
        """One communication round; updates ``params`` in place and returns
        ``(params, {"loss": mean, "client_loss": [K, C]})``.  ``offsets``
        (``{axis: [C] ints}``; the union vector of a heterogeneous round)
        replaces the scheme's own draw.  ``generator`` is the round's
        random stream, as for :meth:`MaskFedAvg.round`; the window schemes
        draw nothing from it (their draws are seeded by ``scfg.seed``)."""
        offsets = None if offsets is None else self._check_offsets(offsets)
        if self.hetero is not None:
            return self._round_hetero(params, batch, round_idx, offsets)
        if offsets is None:
            offsets = self._client_offsets(round_idx, params)
        if self.mesh is not None:
            return self._round_mesh(params, batch, offsets)
        if self.use_fused and offsets:
            delta, losses = self._client_phase_fused(params, batch, offsets)
            with torch.no_grad():
                self._apply_mean_delta_fused(params, delta, offsets)
        else:
            delta, losses = self._client_phase(params, batch, offsets)
            with torch.no_grad():
                self._apply_mean_delta(params, delta, offsets)
        del delta
        with torch.no_grad():
            sm.project_l2(params, self.scfg.proj_radius)
        return params, {"loss": losses.mean(), "client_loss": losses}

    def round_with_server_opt(self, params, opt_state, batch, round_idx,
                              server_opt=None, generator=None, offsets=None):
        """The same client phase as :meth:`round`; the server then steps
        ``server_opt`` (default: the round's own) on the full-shaped
        float32 mean client delta as a pseudo-gradient (FedAvgM, FedAdam),
        then ``project_l2``.  Updates ``params`` and ``opt_state`` in place
        and returns ``(params, opt_state, metrics)``."""
        server_opt = server_opt if server_opt is not None else self.server_opt
        if server_opt is None:
            raise ValueError(
                "no server optimizer attached; pass server_opt= or build "
                "the round with api.fed_round(..., server_opt=...)")
        offsets = None if offsets is None else self._check_offsets(offsets)
        if self.hetero is not None:
            acc, losses = self._hetero_delta_sum(params, batch, round_idx,
                                                 offsets)
            with torch.no_grad():
                dbar = {k: acc.pop(k) / self.scfg.clients_per_round
                        for k in list(acc)}
        else:
            if offsets is None:
                offsets = self._client_offsets(round_idx, params)
            if self.mesh is not None:
                dbar, losses = self._mean_delta_full_mesh(params, batch,
                                                          offsets)
            elif self.use_fused and offsets:
                delta, losses = self._client_phase_fused(params, batch,
                                                         offsets)
                with torch.no_grad():
                    dbar = self._mean_delta_full_fused(delta)
                del delta
            else:
                delta, losses = self._client_phase(params, batch, offsets)
                with torch.no_grad():
                    dbar = self._mean_delta_full(params, delta, offsets)
                del delta
        with torch.no_grad():
            params, opt_state = server_opt.update(params, dbar, opt_state)
            del dbar
            sm.project_l2(params, self.scfg.proj_radius)
        return params, opt_state, {"loss": losses.mean(),
                                   "client_loss": losses}


def _scatter_update(params, dbar, axes, off0, sizes, server_lr):
    """``w[window] += server_lr * dbar``, in place on a view of each leaf's
    window (no copy of the leaf)."""
    for path, cur in extract(params, axes, off0, sizes).items():
        cur.copy_((cur.float() + server_lr * dbar[path]).to(cur.dtype))
    return params


def build_window_fed(loss_fn, scfg, abstract, axes, device, client_opt=None,
                     server_opt=None, windowed_loss_fn=None,
                     fused_forward="auto", capacities=None,
                     uplink_compression=None, spmd_axis=None, mesh=None,
                     mesh_agg="gather") -> WindowFedAvg:
    scheme = make_scheme(scfg, collect_axis_dims(abstract, axes))
    return WindowFedAvg(loss_fn=loss_fn, scfg=scfg, abstract=abstract,
                        axes=axes, scheme=scheme, device=device,
                        client_opt=client_opt, server_opt=server_opt,
                        windowed_loss_fn=windowed_loss_fn,
                        fused_forward=fused_forward,
                        capacities=capacities,
                        uplink_compression=uplink_compression,
                        spmd_axis=spmd_axis, mesh=mesh, mesh_agg=mesh_agg)


# ---------------------------------------------------------------------------
# Mask (dense) mode: the paper's literal formulation
# ---------------------------------------------------------------------------


def _round_generator(generator, scfg, round_idx, device):
    """``generator``, or (None) one seeded by ``(scfg.seed, round_idx)``."""
    if generator is not None:
        return generator
    return seeded_generator(scfg.seed, round_idx, device=device)


def _window_sizes(caps, n, align):
    """Per-client window lengths on an axis of size ``n``, as the
    reference computes them: ``cap * n`` in float32, rounded half to even,
    aligned down, clipped to ``[align, n]``."""
    a = min(align, n)
    w = np.round(caps * np.float32(n)).astype(np.int32)
    return np.clip((w // a) * a, a, n)


def _check_masks(masks, abstract, C, device):
    """Injected masks ``{path: [C, *shape]}`` as float32 on ``device``."""
    if set(masks) != set(abstract):
        raise ValueError(f"masks name {sorted(set(masks) ^ set(abstract))[:3]}"
                         " unlike the model's params")
    out = {}
    for path, shape in abstract.items():
        m = torch.as_tensor(masks[path]).to(device, torch.float32)
        if m.shape != (C, *shape):
            raise ValueError(f"mask {path} is {tuple(m.shape)}; expected "
                             f"{(C, *shape)}")
        out[path] = m.contiguous()
    return out


def dense_client_masks(generator, abstract, axes, scfg: SubmodelConfig,
                       capacities, round_idx, device, offsets=None,
                       masks=None) -> Dict[str, torch.Tensor]:
    """Float32 masks ``{path: [C, *shape]}``, client c at capacity
    ``capacities[c]`` (heterogeneous capacities allowed).

    Schemes: ``full`` (ones), ``bernoulli`` (unstructured, Algorithm 1,
    drawn on ``device``), and the structured ``static``, ``rolling``
    (shared or ``stagger``) and ``random``: one 0/1 selector per windowed
    axis of each leaf, multiplied together, of the client's own size and
    offset, contiguous or (``wrap``) cyclic.  ``heads`` is sized on its
    own, not coupled to ``kv_heads``, as in the reference.  Random draws
    (``bernoulli`` and the ``random`` offsets) come from ``generator``, or
    one seeded by ``(scfg.seed, round_idx)``; torch cannot reproduce
    ``jax.random``, so ``offsets`` (``{axis: [C] ints}``) may replace the
    rolling order and ``masks`` the whole draw.
    """
    caps = np.asarray(capacities, np.float32).reshape(-1)
    C = caps.shape[0]
    if masks is not None:
        return _check_masks(masks, abstract, C, device)
    if offsets is not None and scfg.scheme != "rolling":
        raise ValueError("offsets= replaces the rolling order; the scheme "
                         f"is {scfg.scheme!r}")
    if scfg.scheme == "full":
        return {k: torch.ones((C, *s), device=device)
                for k, s in abstract.items()}
    if scfg.scheme == "bernoulli":
        return sm.bernoulli_masks(
            _round_generator(generator, scfg, round_idx, device), abstract,
            torch.from_numpy(caps), device)
    if scfg.scheme not in ("static", "rolling", "random"):
        # "importance" needs live params, which dense masks never see
        raise ValueError(
            f"scheme {scfg.scheme!r} is not supported in dense-mask mode; "
            "use window mode (api.fed_round(..., mode='window')) instead")
    dims = collect_axis_dims(abstract, axes)
    if scfg.scheme == "rolling":
        # the same grid (and GQA-derived heads offsets) as window mode
        plan = make_scheme(scfg, dims)
        roll = (plan.offsets(round_idx, C) if offsets is None
                else {k: [int(o) for o in v] for k, v in offsets.items()})
        if set(roll) != set(plan.sizes) or \
                any(len(v) != C for v in roll.values()):
            raise ValueError(f"rolling offsets name {sorted(roll)}; the "
                             f"scheme windows {sorted(plan.sizes)}, one "
                             f"offset per client ({C})")
    elif scfg.scheme == "random":
        gen = _round_generator(generator, scfg, round_idx, device)
    sel = {}
    for key in sorted(d for d in dims if d[0] in scfg.axes):
        n = key[1]
        size = torch.as_tensor(_window_sizes(caps, n, scfg.align),
                               device=device, dtype=torch.long)
        if scfg.scheme == "static":
            off = torch.zeros(C, dtype=torch.long, device=device)
        elif scfg.scheme == "rolling":
            off = torch.tensor(roll.get(key, [0] * C), device=device)
        else:
            off = torch.randint(0, n, (C,), generator=gen, device=device)
        idx = torch.arange(n, device=device)[None]
        if scfg.wrap:
            s = ((idx - off[:, None]) % n) < size[:, None]
        else:
            off = torch.minimum(off, n - size)[:, None]
            s = (idx >= off) & (idx < off + size[:, None])
        sel[key] = s.float()
    out = {}
    for path, shape in abstract.items():
        m = torch.ones((C, *shape), device=device)
        for d, name in enumerate(axes[path]):
            key = (name, int(shape[d]))
            if key in sel:
                view = [C] + [1] * len(shape)
                view[1 + d] = key[1]
                m.mul_(sel[key].view(view))
        out[path] = m
    return out


def _in_param_dtypes(masks, params):
    """The round's masks in each param's dtype (0/1 is exact in bf16), as
    the reference casts them for the masked step and the fill-in
    (``kernels/ops.py:54, 70``): the update kernels take operands of one
    dtype.  A float32 mask is itself."""
    return {k: m.to(params[k].dtype) for k, m in masks.items()}


@dataclass
class MaskFedAvg:
    """The mask-mode round: dense per-client masks, K masked local SGD
    steps on per-client copies of the FULL model, then the server's
    fill-in average (Algorithm 1; the round of every experiment of the
    paper's protocol)."""

    loss_fn: Callable                 # (params, batch) -> ([C], aux)
    scfg: SubmodelConfig
    abstract: Dict[str, torch.Size]   # {path: shape}
    axes: Dict[str, tuple]            # {path: axis tags}
    capacities: Any                   # [C] floats
    device: torch.device
    client_opt: Optional[ClientOpt] = None
    server_opt: Optional[ServerOpt] = None    # the Trainer steps with it

    def __post_init__(self):
        self.client_opt = resolve_client_opt(self.client_opt)
        self.capacities = self._check_capacities(self.capacities)

    def _check_capacities(self, capacities):
        caps = np.asarray(capacities, np.float32).reshape(-1)
        if caps.shape != (self.scfg.clients_per_round,):
            raise ValueError(f"{caps.shape[0]} capacities for "
                             f"{self.scfg.clients_per_round} clients")
        return caps

    def client_phase(self, params, batch, masks, literal=False):
        """K masked steps from ``w_c = w * m_c``; returns the clients'
        params after K steps (``{path: [C, ...]}``) and the losses
        ``[K, C]``.

        With the paper's plain SGD the model runs on ``w_c`` itself rather
        than on ``m * w_c``: ``w_c`` starts as ``w * m`` and a masked step
        changes it only where m = 1, so ``m * w_c == w_c`` bit for bit,
        and the masked step's ``m * g`` makes ``m * (m * grad f) == m *
        grad f``.  The update is the literal ``m * grad f(m * w_c)`` with
        no masked copy of the model and two fewer elementwise passes per
        leaf per step.  That holds for plain SGD with finite gradients
        only: any other client optimizer, or ``literal=True``, runs
        :func:`submodel.masked_value_and_grad`.
        """
        c = self.scfg
        literal = literal or self.client_opt.name != "sgd"
        with torch.no_grad():
            w_c = {k: v[None] * masks[k] for k, v in params.items()}
        opt, state = self.client_opt, self.client_opt.init(w_c)
        mvg = sm.masked_value_and_grad(self.loss_fn)
        losses = []
        for k in range(c.local_steps):
            mb = {name: v[k] for name, v in batch.items()}
            if literal:
                (loss, _), grads = mvg(w_c, masks, mb)
            else:
                for v in w_c.values():
                    v.requires_grad_()
                loss, _ = self.loss_fn(w_c, mb)
                grads = dict(zip(w_c, torch.autograd.grad(
                    loss.sum(), list(w_c.values()))))
            with torch.no_grad():
                w_c, state = opt.update(w_c, grads, state, c.client_lr,
                                        masks=masks)
            del grads
            losses.append(loss.detach())
        for v in w_c.values():
            v.requires_grad_(False)
        return w_c, torch.stack(losses)

    def round(self, params, batch, round_idx, generator=None, masks=None,
              capacities=None):
        """One communication round; updates ``params`` in place and returns
        ``(params, {"loss": mean, "client_loss": [K, C]})``.
        ``capacities`` (``[C]``) replaces the round's per-client capacities
        (the paper's protocol passes each round's participants');
        ``generator`` is the stream the masks are drawn from (None: one
        seeded by ``(scfg.seed, round_idx)``); ``masks`` replaces the draw.
        """
        caps = (self.capacities if capacities is None
                else self._check_capacities(capacities))
        masks = _in_param_dtypes(dense_client_masks(
            generator, self.abstract, self.axes, self.scfg, caps, round_idx,
            self.device, masks=masks), params)
        w_c, losses = self.client_phase(params, batch, masks)
        with torch.no_grad():
            sm.fillin_average(params, w_c, masks, self.scfg.server_lr)
            del w_c, masks
            sm.project_l2(params, self.scfg.proj_radius)
        return params, {"loss": losses.mean(), "client_loss": losses}

    def round_with_server_opt(self, params, opt_state, batch, round_idx,
                              server_opt=None, generator=None, masks=None,
                              capacities=None):
        """The same client phase as :meth:`round`; the server then steps
        ``server_opt`` (default: the round's own) on the masked mean
        delta ``mean_c m_c * (w_c - w)`` in float32 (built one leaf at a
        time, each leaf's client copies and masks freed as it is done),
        then ``project_l2``.  Returns ``(params, opt_state, metrics)``."""
        server_opt = server_opt if server_opt is not None else self.server_opt
        if server_opt is None:
            raise ValueError(
                "no server optimizer attached; pass server_opt= or build "
                "the round with api.fed_round(..., server_opt=...)")
        caps = (self.capacities if capacities is None
                else self._check_capacities(capacities))
        masks = _in_param_dtypes(dense_client_masks(
            generator, self.abstract, self.axes, self.scfg, caps, round_idx,
            self.device, masks=masks), params)
        w_c, losses = self.client_phase(params, batch, masks)
        with torch.no_grad():
            dbar = {}
            for k, w in params.items():
                wk, m = w_c.pop(k), masks.pop(k)
                dbar[k] = (m * (wk.float() - w.float()[None])).mean(0)
                del wk, m
            params, opt_state = server_opt.update(params, dbar, opt_state)
            del dbar
            sm.project_l2(params, self.scfg.proj_radius)
        return params, opt_state, {"loss": losses.mean(),
                                   "client_loss": losses}


def build_mask_fed(loss_fn, scfg, abstract, axes, capacities, device,
                   client_opt=None, server_opt=None) -> MaskFedAvg:
    return MaskFedAvg(loss_fn=loss_fn, scfg=scfg, abstract=abstract,
                      axes=axes, capacities=capacities, device=device,
                      client_opt=client_opt, server_opt=server_opt)


# ---------------------------------------------------------------------------
# Output model (hat-w): the paper's final one-step corrected output
# ---------------------------------------------------------------------------


def output_model(fed, params, batch, generator=None, lipschitz=1.0,
                 round_idx=0, masks=None, offsets=None):
    """``hat-w = P_W(w - (1/L) avg_i m_i * grad f_i(m_i * w))`` (the output
    of Algorithms 1 and 2), on step 0 of ``batch`` (leaves ``[K, C,
    ...]``); returns new params and leaves ``params`` as they are.

    Mask mode evaluates the literal dense-mask formula, with the round's
    masks drawn from ``generator`` (or ``masks`` injected).  Window mode
    evaluates the same quantity in compact form: one gradient on each
    client's compact sub-model, scattered back and averaged (``offsets``
    may replace the scheme's draw).
    """
    scfg = fed.scfg
    mb = {k: _to_device(v, fed.device)[0] for k, v in batch.items()}
    if isinstance(fed, MaskFedAvg):
        masks = _in_param_dtypes(dense_client_masks(
            generator, fed.abstract, fed.axes, scfg, fed.capacities,
            round_idx, fed.device, masks=masks), params)
        w_c = {k: v[None] * masks[k] for k, v in params.items()}
        _, g = sm.masked_value_and_grad(fed.loss_fn)(w_c, masks, mb)
        gbar = {k: (masks[k] * g[k]).mean(0) for k in params}
    else:
        offsets = (fed._client_offsets(round_idx, params) if offsets is None
                   else fed._check_offsets(offsets))
        sub0 = {k: v.requires_grad_() for k, v in
                fed._extract_clients(params, offsets).items()}
        loss, _ = fed.loss_fn(sub0, mb)
        g = dict(zip(sub0, torch.autograd.grad(loss.sum(),
                                               list(sub0.values()))))
        gbar = fed._mean_delta_full(params, g, offsets)
    with torch.no_grad():
        new = {k: w - gbar[k].to(w.dtype) / lipschitz
               for k, w in params.items()}
        return sm.project_l2(new, scfg.proj_radius)


def run_rounds(fed, params, batch_iter, n_rounds, rng=None, callback=None):
    """Thin wrapper over :class:`repro_torch.core.trainer.Trainer` (kept for
    the theory and stability harnesses): ``n_rounds`` rounds from
    ``params`` (updated in place, as the Trainer does), the masks drawn
    from a generator seeded by ``rng``.  Returns ``(params, history)``,
    the per-round metric records."""
    trainer = Trainer(fed, params, rng=rng,
                      callbacks=(callback,) if callback else ())
    return trainer.run(batch_iter, n_rounds)
