"""The window-mode federated round with one shared window (Algorithm 2).

Ports, from ``repro/core/fedavg.py``: ``resolve_shared_window``,
``WindowFedAvg`` (construction, ``_resolve_fused`` for what this port
covers, ``_client_offsets``, ``_fused_window``, ``_client_phase_fused``
and ``_apply_mean_delta_fused`` for the shared window, ``round``) and
``_scatter_update``.

Clients are an explicit leading dimension ``[C, ...]`` of every leaf (the
reference vmaps them).  Each client trains K plain-SGD steps on its own
copy of the FULL model through the window-aware forward, so coordinates
outside the window get exactly zero gradient; the server then takes the
clients' mean change inside the window and adds it in place.  Batch
leaves are ``[K, C, ...]``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import SubmodelConfig
from repro_torch.core import submodel as sm
from repro_torch.core.extract import extract
from repro_torch.core.masking import (WindowScheme, collect_axis_dims,
                                      make_scheme)
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


@dataclass
class WindowFedAvg:
    loss_fn: Callable                 # (params, batch, window=) -> ([C], aux)
    scfg: SubmodelConfig
    axes: Dict[str, tuple]            # {path: axis tags}
    scheme: WindowScheme
    device: torch.device
    client_opt: Optional[ClientOpt] = None
    fused_forward: Any = "auto"       # "auto" | True/"on"

    def __post_init__(self):
        self.shared_window = resolve_shared_window(self.scfg)
        self.client_opt = resolve_client_opt(self.client_opt)
        self._fused_keys = self._resolve_fused()

    def _resolve_fused(self):
        """The windows the fused client phase runs (every properly
        windowed axis).  The port runs only the fused phase, with one
        shared window; anything else is not ported yet and says so."""
        if self.fused_forward in (False, "off"):
            raise NotImplementedError(
                "the extract client phase is not ported yet (ROADMAP.md "
                "queue A, extract client phase)")
        if self.fused_forward not in (True, "on", "auto", None):
            raise ValueError(f"fused_forward must be 'auto' or 'on'; got "
                             f"{self.fused_forward!r}")
        if not self.shared_window:
            raise NotImplementedError(
                "per-client (staggered or random) windows are not ported yet "
                "(ROADMAP.md queue A, per-client windows)")
        proper = {k: w for k, w in self.scheme.sizes.items() if w < k[1]}
        if not proper:
            raise NotImplementedError(
                "no axis is windowed, so the round would train the full "
                "model through the extract client phase, which is not "
                "ported yet (ROADMAP.md queue A, extract client phase)")
        unsupported = sorted(k for k in proper
                             if k[0] not in WindowMap.SUPPORTED)
        uncoupled = sorted(k for k in proper if k[0] == "heads"
                           and k not in self.scheme.derived)
        if unsupported or uncoupled:
            raise NotImplementedError(
                f"axes {unsupported + uncoupled} have no fused window-aware "
                f"forward in the port (it fuses {WindowMap.SUPPORTED}, heads "
                "GQA-derived from kv_heads); the extract client phase is not "
                "ported yet (ROADMAP.md queue A, extract client phase)")
        return proper

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

    def _client_phase_fused(self, params, batch, offsets):
        """K SGD steps on per-client copies of the FULL model, through the
        window-aware forward.  Returns the clients' params after K steps
        (``{path: [C, ...]}``) and the losses ``[K, C]``."""
        c = self.scfg
        tokens = batch["tokens"]                      # [K, C, mb, S]
        C = tokens.shape[1]
        full = {k: v.unsqueeze(0).repeat(C, *([1] * v.dim())).requires_grad_()
                for k, v in params.items()}
        window = self._fused_window(offsets)
        opt, state = self.client_opt, self.client_opt.init(full)
        losses = []
        for k in range(tokens.shape[0]):
            loss, _ = self.loss_fn(full, {"tokens": tokens[k]},
                                   window=window)
            # summing the per-client losses gives each client its own grad
            grads = torch.autograd.grad(loss.sum(), list(full.values()))
            with torch.no_grad():
                full, state = opt.update(full, dict(zip(full, grads)), state,
                                         c.client_lr)
            del grads
            losses.append(loss.detach())
        for v in full.values():
            v.requires_grad_(False)
        return full, torch.stack(losses)

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

    def round(self, params, batch, round_idx, offsets=None):
        """One communication round; updates ``params`` in place and returns
        ``(params, {"loss": mean, "client_loss": [K, C]})``.  ``offsets``
        (``{axis: [C] ints}``) replaces the scheme's own draw."""
        offsets = (self._client_offsets(round_idx) if offsets is None
                   else self._check_offsets(offsets))
        full_k, losses = self._client_phase_fused(params, batch, offsets)
        with torch.no_grad():
            self._apply_mean_delta_fused(params, full_k, offsets)
            del full_k
            sm.project_l2(params, self.scfg.proj_radius)
        return params, {"loss": losses.mean(), "client_loss": losses}


def _scatter_update(params, dbar, axes, off0, sizes, server_lr):
    """``w[window] += server_lr * dbar``, in place on a view of each leaf's
    window (no copy of the leaf)."""
    for path, cur in extract(params, axes, off0, sizes).items():
        cur.copy_((cur.float() + server_lr * dbar[path]).to(cur.dtype))
    return params


def build_window_fed(loss_fn, scfg, abstract, axes, device, client_opt=None,
                     fused_forward="auto") -> WindowFedAvg:
    scheme = make_scheme(scfg, collect_axis_dims(abstract, axes))
    return WindowFedAvg(loss_fn=loss_fn, scfg=scfg, axes=axes,
                        scheme=scheme, device=device,
                        client_opt=client_opt, fused_forward=fused_forward)
