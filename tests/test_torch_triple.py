"""``fed_round`` on a ``(loss_fn, abstract, axes)`` triple, against the JAX
reference.

The model is the reference's tiny MLP regression (``tests/test_api.py``
``_small_problem``): d_in 24, d_h 32, C = 4 clients, K = 2 local steps,
batch ``{x: [K, C, 8, 24], y: [K, C, 8]}``.  Its loss takes ``window=`` and
applies the ``d_ff`` window through each package's own ``WindowMap.get``,
so both packages resolve their fused client phase.  Each loss follows
its package's convention: the reference's is per client (vmapped by the
round), the port's takes ``[C, ...]`` params and batch leaves and returns
``[C]`` losses.

Both packages start from the same params (numpy, through
``repro_torch.convert``), take the same batches, and the port gets the
reference's rolling offsets and Bernoulli masks injected (torch cannot
reproduce ``jax.random``).  Tolerance: float32, atol 1e-6 and rtol 1e-6 on
params and per-client losses: the two frameworks' matmuls and reductions
sum in different orders, a few ulp each, and the reference's XLA fuses
``p - lr * m * g`` into one FMA where the port rounds twice.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as ref_api  # noqa: E402
from repro.configs.base import SubmodelConfig as RefSubmodelConfig  # noqa
from repro.core.fedavg import dense_client_masks as ref_masks  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch.configs.base import SubmodelConfig  # noqa: E402

ATOL = RTOL = 1e-6
D_IN, D_H, C, K, MB = 24, 32, 4, 2, 8
ROUNDS = 3
AXES = {"w1": ("d_model", "d_ff"), "b1": ("d_ff",), "w2": ("d_ff",)}
BASE = dict(capacity=0.5, local_steps=K, clients_per_round=C,
            client_lr=0.05, axes=("d_ff",))


def ref_loss(w, b, window=None):
    """One client's loss, the reference's convention."""
    w1, b1, w2 = w["w1"], w["b1"], w["w2"]
    win = None if window is None else window.get("d_ff", D_H)
    if win is not None:
        w1 = jax.lax.dynamic_slice_in_dim(w1, win.offset, win.win, axis=1)
        b1 = jax.lax.dynamic_slice_in_dim(b1, win.offset, win.win)
        w2 = jax.lax.dynamic_slice_in_dim(w2, win.offset, win.win)
    h = jnp.tanh(b["x"] @ w1 + b1)
    r = h @ w2 - b["y"]
    return 0.5 * jnp.mean(r * r), {}


def port_loss(w, b, window=None):
    """All clients' losses ``[C]``: params and batch leaves ``[C, ...]``."""
    w1, b1, w2 = w["w1"], w["b1"], w["w2"]
    win = None if window is None else window.get("d_ff", D_H)
    if win is not None:
        o = win.shared_offset()
        w1, b1, w2 = (w1[..., o:o + win.win], b1[:, o:o + win.win],
                      w2[:, o:o + win.win])
    h = torch.tanh(torch.bmm(b["x"], w1) + b1[:, None])
    r = torch.bmm(h, w2[..., None])[..., 0] - b["y"]
    return 0.5 * (r * r).mean(-1), {}


def _params0():
    rng = np.random.default_rng(1)
    return {"w1": (rng.standard_normal((D_IN, D_H)) * 0.3).astype(np.float32),
            "b1": np.zeros(D_H, np.float32),
            "w2": (rng.standard_normal(D_H) * 0.3).astype(np.float32)}


def _batches():
    rng = np.random.default_rng(0)
    return [{"x": rng.standard_normal((K, C, MB, D_IN)).astype(np.float32),
             "y": rng.standard_normal((K, C, MB)).astype(np.float32)}
            for _ in range(ROUNDS)]


def _ref_triple():
    abstract = {k: jax.ShapeDtypeStruct(v.shape, jnp.float32)
                for k, v in _params0().items()}
    return ref_loss, abstract, AXES


def _port_triple(loss=port_loss):
    return loss, {k: torch.Size(v.shape) for k, v in _params0().items()}, AXES


def _jnp(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def reference_runs():
    """Three window rounds and three Bernoulli mask rounds of the
    reference (jnp arm) on the triple, with what the port must inject."""
    batches = _batches()
    out = {"batches": batches}
    fed = ref_api.fed_round(_ref_triple(), RefSubmodelConfig(
        scheme="rolling", **BASE), kernel_backend="jnp")
    assert fed.use_fused and fed.shared_window
    params, losses, offsets = _jnp(_params0()), [], []
    for r in range(ROUNDS):
        offsets.append({k: [int(o) for o in np.asarray(v)] for k, v in
                        fed.scheme.offsets(None, r, C).items()})
        params, metrics = fed.round(params, _jnp(batches[r]), r,
                                    jax.random.PRNGKey(r))
        losses.append(np.asarray(metrics["client_loss"]))
    out["window"] = dict(params={k: np.asarray(v) for k, v in params.items()},
                         client_loss=losses, offsets=offsets)

    scfg = RefSubmodelConfig(scheme="bernoulli", **BASE)
    fed = ref_api.fed_round(_ref_triple(), scfg, kernel_backend="jnp")
    assert isinstance(fed, ref_api.MaskFedAvg)
    caps = jnp.full((C,), BASE["capacity"], jnp.float32)
    params, losses, masks = _jnp(_params0()), [], []
    for r in range(ROUNDS):
        key = jax.random.PRNGKey(10 + r)
        masks.append({k: np.asarray(v) for k, v in ref_masks(
            key, _ref_triple()[1], AXES, scfg, caps, r).items()})
        params, metrics = fed.round(params, _jnp(batches[r]), r, key)
        losses.append(np.asarray(metrics["client_loss"]))
    out["mask"] = dict(params={k: np.asarray(v) for k, v in params.items()},
                       client_loss=losses, masks=masks)
    return out


def _assert_run_matches(trainer, want):
    for r, h in enumerate(trainer.history):
        np.testing.assert_allclose(h["client_loss"].numpy(),
                                   want["client_loss"][r], atol=ATOL,
                                   rtol=RTOL, err_msg=f"round {r}")
    for k, v in want["params"].items():
        np.testing.assert_allclose(trainer.params[k].numpy(), v, atol=ATOL,
                                   rtol=RTOL, err_msg=k)


def test_window_rounds_on_a_triple_match_reference(reference_runs):
    ref = reference_runs
    fed = api.fed_round(_port_triple(), SubmodelConfig(scheme="rolling",
                                                       **BASE), device="cpu")
    assert isinstance(fed, api.WindowFedAvg)
    trainer = api.Trainer(fed, convert.from_reference(_params0(),
                                                      device="cpu"))
    trainer.run(((b, {"offsets": o}) for b, o in
                 zip(ref["batches"], ref["window"]["offsets"])), ROUNDS)
    _assert_run_matches(trainer, ref["window"])


def test_mask_rounds_on_a_triple_match_reference(reference_runs):
    ref = reference_runs
    fed = api.fed_round(_port_triple(), SubmodelConfig(scheme="bernoulli",
                                                       **BASE), device="cpu")
    assert isinstance(fed, api.MaskFedAvg)
    trainer = api.Trainer(fed, convert.from_reference(_params0(),
                                                      device="cpu"))
    trainer.run(((b, {"masks": convert.from_reference(m, device="cpu")})
                 for b, m in zip(ref["batches"], ref["mask"]["masks"])),
                ROUNDS)
    _assert_run_matches(trainer, ref["mask"])


@pytest.mark.parametrize("form", [tuple, list])
@pytest.mark.parametrize("scheme,want", [("rolling", api.WindowFedAvg),
                                         ("bernoulli", api.MaskFedAvg)])
def test_triple_builds_both_modes(form, scheme, want):
    fed = api.fed_round(form(_port_triple()), SubmodelConfig(scheme=scheme,
                                                             **BASE),
                        device="cpu")
    assert isinstance(fed, want)
    assert fed.loss_fn is port_loss and fed.axes is AXES


@pytest.mark.parametrize("bad", [object(), (port_loss, {}),
                                 [port_loss, {}, AXES, None], "model"],
                         ids=["object", "pair", "four", "str"])
def test_other_objects_raise_type_error(bad):
    with pytest.raises(TypeError, match="triple"):
        api.fed_round(bad, SubmodelConfig(scheme="rolling", **BASE),
                      device="cpu")


def test_window_mode_needs_a_window_aware_loss():
    """Only a loss with ``window=`` gets the fused client phase: without it
    window mode takes the extract phase, as the reference's does, and
    ``fused_forward="on"`` raises; mask mode takes it."""
    def plain(w, b):
        return port_loss(w, b)

    scfg = SubmodelConfig(scheme="rolling", **BASE)
    fed = api.fed_round(_port_triple(plain), scfg, device="cpu")
    assert isinstance(fed, api.WindowFedAvg) and not fed.use_fused
    assert api.fed_round(_port_triple(), scfg, device="cpu").use_fused
    with pytest.raises(ValueError, match="no windowed forward"):
        api.fed_round(_port_triple(plain), scfg, fused_forward="on",
                      device="cpu")
    fed = api.fed_round(_port_triple(plain), scfg, mode="mask", device="cpu")
    assert isinstance(fed, api.MaskFedAvg)


def test_every_batch_leaf_reaches_the_window_loss():
    """Each local step hands the loss step k of every leaf, ``[C, ...]``;
    K comes from the first leaf, whatever its name."""
    seen = []

    def loss(w, b, window=None):
        seen.append({k: tuple(v.shape) for k, v in b.items()})
        return port_loss(w, {"x": b["x"], "y": b["y"] + b["shift"]}, window)

    fed = api.fed_round(_port_triple(loss), SubmodelConfig(scheme="rolling",
                                                           **BASE),
                        device="cpu")
    batch = {k: torch.tensor(v) for k, v in _batches()[0].items()}
    batch = {"shift": torch.zeros(K, C, MB), **batch}
    params = convert.from_reference(_params0(), device="cpu")
    _, metrics = fed.round(params, batch, 0)
    assert seen == [{"shift": (C, MB), "x": (C, MB, D_IN), "y": (C, MB)}] * K
    assert metrics["client_loss"].shape == (K, C)
