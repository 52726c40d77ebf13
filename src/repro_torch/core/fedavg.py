"""The federated rounds: window mode with one shared window or none
(Algorithm 2) and mask mode (Algorithm 1 and the paper's protocol round).

Ports, from ``repro/core/fedavg.py``: ``resolve_shared_window``,
``WindowFedAvg`` (construction, ``_resolve_fused``, ``_client_offsets``,
``_fused_window``, ``_extract_clients``, ``_client_phase``,
``_apply_mean_delta``, ``_mean_delta_full``, ``_client_phase_fused`` and
``_apply_mean_delta_fused`` for the shared window, ``round``),
``_scatter_update``, ``dense_client_masks``, ``MaskFedAvg``,
``_build_mask_fed``, ``output_model`` and ``run_rounds``.

Clients are an explicit leading dimension ``[C, ...]`` of every leaf (the
reference vmaps them).  Window mode has two client phases, as the
reference's.  The fused one trains each client's copy of the FULL model
through the window-aware forward, so coordinates outside the window get
exactly zero gradient, and the server adds the clients' mean change into
the window in place.  The extract one (Algorithm 2 as written) gives each
client a compact copy of its window (a full replica when no axis is
windowed, as under scheme ``full``), trains it through the model's
ordinary loss and sends back the change; the server averages the changes
and scatters them into the window.  In mask mode each client's copy
starts as ``w * m_c`` under a dense mask, its steps are masked, and the
server takes the fill-in average.  Batch leaves are ``[K, C, ...]``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import SubmodelConfig
from repro_torch.core import submodel as sm
from repro_torch.core.extract import extract, scatter_delta
from repro_torch.core.masking import (WindowScheme, collect_axis_dims,
                                      make_scheme, seeded_generator)
from repro_torch.core.trainer import Trainer, _to_device
from repro_torch.models.layers import AxisWindow, WindowMap
from repro_torch.optim.client import ClientOpt, resolve_client_opt

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


@dataclass
class WindowFedAvg:
    loss_fn: Callable                 # (params, batch) -> ([C], aux)
    scfg: SubmodelConfig
    abstract: Dict[str, torch.Size]   # {path: full shape}
    axes: Dict[str, tuple]            # {path: axis tags}
    scheme: WindowScheme
    device: torch.device
    client_opt: Optional[ClientOpt] = None
    # loss_fn(params, batch, window=WindowMap): the fused client phase runs
    # it; None (a loss without window=) leaves the extract phase only
    windowed_loss_fn: Optional[Callable] = None
    fused_forward: Any = "auto"       # "auto" | True/"on" | False/"off"

    def __post_init__(self):
        self.shared_window = resolve_shared_window(self.scfg)
        self.client_opt = resolve_client_opt(self.client_opt)
        self.use_fused = self._resolve_fused()

    def _resolve_fused(self) -> bool:
        """Whether the round takes the fused client phase (every properly
        windowed axis has a fused forward) or the extract one, as the
        reference resolves it; per-client windows are not ported."""
        want = self.fused_forward
        if want not in (True, "on", False, "off", "auto", None):
            raise ValueError(f"fused_forward must be 'auto', 'on'/True or "
                             f"'off'/False; got {want!r}")
        # proper windows only (size < full dim): improper ones are no-ops
        proper = {k: w for k, w in self.scheme.sizes.items() if w < k[1]}
        if proper and not self.shared_window:
            raise NotImplementedError(
                "per-client (staggered or random) windows are not ported yet "
                "(ROADMAP.md queue A, per-client windows)")
        if want in (False, "off"):
            return False
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

    def _client_offsets(self, round_idx):
        return self.scheme.offsets(round_idx, self.scfg.clients_per_round)

    def _check_offsets(self, offsets):
        """Injected offsets ``{axis: [C] ints}``: the scheme's axes, one
        shared in-range offset per client."""
        C = self.scfg.clients_per_round
        if set(offsets) != set(self.scheme.sizes):
            raise ValueError(f"offsets name axes {sorted(offsets)}; the "
                             f"scheme windows {sorted(self.scheme.sizes)}")
        out = {}
        for k, v in offsets.items():
            v = [int(o) for o in v]
            if len(v) != C or len(set(v)) != 1 or not \
                    0 <= v[0] <= k[1] - self.scheme.sizes[k]:
                raise ValueError(f"offsets {v} for {k} are not one in-range "
                                 f"window start shared by {C} clients")
            out[k] = v
        return out

    def _fused_window(self, offsets) -> WindowMap:
        return WindowMap({k: AxisWindow(offsets[k], w)
                          for k, w in self._fused_keys.items()})

    def _extract_clients(self, params, offsets, count=None):
        """Per-client compact sub-models ``{path: [C, *sub shape]}``,
        contiguous copies (the client steps update them in place); with no
        offsets every client gets a full replica.  ``count`` overrides C."""
        C = self.scfg.clients_per_round if count is None else count
        off0 = {k: v[0] for k, v in offsets.items()}
        sub = extract(params, self.axes, off0, self.scheme.sizes)
        return {k: v.unsqueeze(0).repeat(C, *([1] * v.dim()))
                for k, v in sub.items()}

    def _client_phase(self, params, batch, offsets):
        """extract -> K local steps through the ordinary ``loss_fn`` ->
        delta.  Returns the clients' float32 changes ``{path: [C, *sub
        shape]}`` (computed in place of their trained copies) and the
        losses ``[K, C]``."""
        C = next(iter(batch.values())).shape[1]       # every leaf [K, C, ...]
        sub = self._extract_clients(params, offsets, count=C)
        losses = _steps(sub, batch, self.loss_fn, self.client_opt,
                        self.scfg.client_lr)
        off0 = {k: v[0] for k, v in offsets.items()}
        sub_0 = extract(params, self.axes, off0, self.scheme.sizes)
        with torch.no_grad():
            delta = {k: v.float().sub_(sub_0[k].float()[None])
                     for k, v in sub.items()}
        return delta, losses

    def _apply_mean_delta(self, params, delta, offsets):
        """Plain averaging (the paper's fill-in update, delta form), in
        place.  Shared window: the mean change over clients, then one
        in-place scatter.  Otherwise (no windowed axis, where every
        scatter is the identity) the float32 sum of the clients' scattered
        changes, ``w + server_lr * sum / C``."""
        c = self.scfg
        if self.shared_window and offsets:
            off0 = {k: v[0] for k, v in offsets.items()}
            dbar = {k: d.float().mean(0) for k, d in delta.items()}
            return _scatter_update(params, dbar, self.axes, off0,
                                   self.scheme.sizes, c.server_lr)
        C = next(iter(delta.values())).shape[0]
        for path, w in params.items():
            acc = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
            for ci in range(C):
                off_c = {k: v[ci] for k, v in offsets.items()}
                acc += scatter_delta({path: delta[path][ci]}, self.abstract,
                                     self.axes, off_c,
                                     self.scheme.sizes)[path]
            w.copy_((w.float() + c.server_lr * acc / C).to(w.dtype))
        return params

    def _mean_delta_full(self, params, delta, offsets):
        """The full-shaped float32 mean client delta (``output_model``'s
        averaged gradient): the clients' mean, scattered into the shared
        window (no windowed axis: the mean itself)."""
        dbar = {k: d.float().mean(0) for k, d in delta.items()}
        if not offsets:
            return dbar
        off0 = {k: v[0] for k, v in offsets.items()}
        return scatter_delta(dbar, self.abstract, self.axes, off0,
                             self.scheme.sizes)

    def _client_phase_fused(self, params, batch, offsets):
        """K SGD steps on per-client copies of the FULL model, through the
        window-aware forward; no compact copy of any leaf.  Returns the
        clients' params after K steps (``{path: [C, ...]}``) and the
        losses ``[K, C]``."""
        C = next(iter(batch.values())).shape[1]       # every leaf [K, C, ...]
        full = {k: v.unsqueeze(0).repeat(C, *([1] * v.dim()))
                for k, v in params.items()}
        window = self._fused_window(offsets)
        wloss = self.windowed_loss_fn
        losses = _steps(full, batch, lambda p, mb: wloss(p, mb, window=window),
                        self.client_opt, self.scfg.client_lr)
        return full, losses

    def _apply_mean_delta_fused(self, params, full_k, offsets):
        """Shared window: out-of-window coordinates of every client's change
        are exactly 0, so the server extracts each client's window, takes
        the mean change over clients and adds it into its window once."""
        off0 = {k: v[0] for k, v in offsets.items()}
        sub_k = extract(full_k, self.axes, off0, self.scheme.sizes, lead=1)
        sub_0 = extract(params, self.axes, off0, self.scheme.sizes)
        dbar = {k: (sub_k[k].float() - sub_0[k].float()[None]).mean(0)
                for k in params}
        return _scatter_update(params, dbar, self.axes, off0,
                               self.scheme.sizes, self.scfg.server_lr)

    def round(self, params, batch, round_idx, generator=None, offsets=None):
        """One communication round; updates ``params`` in place and returns
        ``(params, {"loss": mean, "client_loss": [K, C]})``.  ``offsets``
        (``{axis: [C] ints}``) replaces the scheme's own draw.
        ``generator`` is the round's random stream, as for
        :meth:`MaskFedAvg.round`; the shared-window schemes draw nothing
        from it (their order is seeded by ``scfg.seed``)."""
        offsets = (self._client_offsets(round_idx) if offsets is None
                   else self._check_offsets(offsets))
        if self.use_fused and offsets:
            full_k, losses = self._client_phase_fused(params, batch, offsets)
            with torch.no_grad():
                self._apply_mean_delta_fused(params, full_k, offsets)
            del full_k
        else:
            delta, losses = self._client_phase(params, batch, offsets)
            with torch.no_grad():
                self._apply_mean_delta(params, delta, offsets)
            del delta
        with torch.no_grad():
            sm.project_l2(params, self.scfg.proj_radius)
        return params, {"loss": losses.mean(), "client_loss": losses}


def _scatter_update(params, dbar, axes, off0, sizes, server_lr):
    """``w[window] += server_lr * dbar``, in place on a view of each leaf's
    window (no copy of the leaf)."""
    for path, cur in extract(params, axes, off0, sizes).items():
        cur.copy_((cur.float() + server_lr * dbar[path]).to(cur.dtype))
    return params


def build_window_fed(loss_fn, scfg, abstract, axes, device, client_opt=None,
                     windowed_loss_fn=None,
                     fused_forward="auto") -> WindowFedAvg:
    scheme = make_scheme(scfg, collect_axis_dims(abstract, axes))
    return WindowFedAvg(loss_fn=loss_fn, scfg=scfg, abstract=abstract,
                        axes=axes, scheme=scheme, device=device,
                        client_opt=client_opt,
                        windowed_loss_fn=windowed_loss_fn,
                        fused_forward=fused_forward)


# ---------------------------------------------------------------------------
# Mask (dense) mode: the paper's literal formulation
# ---------------------------------------------------------------------------


def _round_generator(generator, scfg, round_idx, device):
    """``generator``, or (None) one seeded by ``(scfg.seed, round_idx)``."""
    if generator is not None:
        return generator
    return seeded_generator(scfg.seed, round_idx, device)


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
        masks = dense_client_masks(generator, self.abstract, self.axes,
                                   self.scfg, caps, round_idx, self.device,
                                   masks=masks)
        w_c, losses = self.client_phase(params, batch, masks)
        with torch.no_grad():
            sm.fillin_average(params, w_c, masks, self.scfg.server_lr)
            del w_c, masks
            sm.project_l2(params, self.scfg.proj_radius)
        return params, {"loss": losses.mean(), "client_loss": losses}

    def round_with_server_opt(self, *args, **kwargs):
        raise NotImplementedError(
            "server optimizers are not ported yet (ROADMAP.md queue A, "
            "optimizers and the uplink)")


def build_mask_fed(loss_fn, scfg, abstract, axes, capacities, device,
                   client_opt=None) -> MaskFedAvg:
    return MaskFedAvg(loss_fn=loss_fn, scfg=scfg, abstract=abstract,
                      axes=axes, capacities=capacities, device=device,
                      client_opt=client_opt)


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
    client's compact sub-model, scattered back and averaged (shared window
    or no windowed axis; ``offsets`` may replace the scheme's draw).
    """
    scfg = fed.scfg
    mb = {k: _to_device(v, fed.device)[0] for k, v in batch.items()}
    if isinstance(fed, MaskFedAvg):
        masks = dense_client_masks(generator, fed.abstract, fed.axes, scfg,
                                   fed.capacities, round_idx, fed.device,
                                   masks=masks)
        w_c = {k: v[None] * masks[k] for k, v in params.items()}
        _, g = sm.masked_value_and_grad(fed.loss_fn)(w_c, masks, mb)
        gbar = {k: (masks[k] * g[k]).mean(0) for k in params}
    else:
        offsets = (fed._client_offsets(round_idx) if offsets is None
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
