"""The port's extract client phase (Algorithm 2 as written) against the JAX
reference.

Reduced TinyLlama (2 layers), S = 32, C = 4, K = 2, on the CPU.  The
reference runs ``fused_forward="off"`` (its extract arm) with
``kernel_backend="jnp"``; the port runs the same rounds from the same
params (converted through numpy) and tokens, with the reference's rolling
offsets injected (torch cannot reproduce ``jax.random``).  Tolerance:
float32, atol 1e-5 and rtol 1e-5 on params and per-client losses, as
``tests/test_torch_round.py`` (the frameworks' matmuls sum in different
orders, a few ulp each, and 6 SGD steps at lr 0.1 carry that into the
weights).  ``scatter_delta``, ``window_mask`` and ``sub_abstract`` are
exact.  Inside the port the fused and the extract client phases agree to
0 ulp, the reference's own pin (``tests/test_fused_forward.py``).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as ref_api  # noqa: E402
from repro.configs.base import SubmodelConfig as RefSubmodelConfig  # noqa
from repro.configs.base import get_reduced_config as ref_reduced  # noqa: E402
from repro.core import extract as ref_ex  # noqa: E402
from repro.core.fedavg import dense_client_masks as ref_masks  # noqa: E402
from repro.core.fedavg import output_model as ref_output_model  # noqa: E402
from repro.data.synthetic import lm_batches as ref_lm_batches  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch.configs.base import (SubmodelConfig,  # noqa: E402
                                      get_reduced_config)
from repro_torch.core import extract as ex  # noqa: E402
from repro_torch.core.fedavg import output_model  # noqa: E402
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ATOL = RTOL = 1e-5
ROUNDS, S, C = 3, 32, 4
SCFG = dict(scheme="rolling", capacity=0.5, local_steps=2,
            clients_per_round=C, client_lr=0.1,
            axes=("d_ff", "heads", "kv_heads"))
SCHEMES = ("rolling", "full")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes at once, and torch's pool of a thread per core in
    each of them oversubscribes the machine (its parallel regions then
    wait on descheduled threads, hundreds of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _offsets(fed, r):
    return {k: [int(o) for o in np.asarray(v)] for k, v in
            fed.scheme.offsets(None, r, C).items()}


@pytest.fixture(scope="module")
def ref_model():
    return ref_build(ref_reduced("tinyllama_1_1b"), remat=False)


@pytest.fixture(scope="module")
def port_model():
    return build_model(get_reduced_config("tinyllama_1_1b"))


@pytest.fixture(scope="module")
def reference_runs(ref_model):
    """Three reference extract rounds per scheme (rolling and full), with
    the offsets each round drew, shared by the tests of this module."""
    params0 = _np(ref_model.init(jax.random.PRNGKey(0)))
    it = ref_lm_batches(ref_model.cfg.vocab, (2, C, 2), S, seed=0)
    batches = [next(it) for _ in range(ROUNDS)]
    runs = {}
    for scheme in SCHEMES:
        fed = ref_api.fed_round(ref_model, RefSubmodelConfig(
            **{**SCFG, "scheme": scheme}), kernel_backend="jnp",
            fused_forward="off")
        assert not fed.use_fused
        trainer = ref_api.Trainer(fed, jax.tree_util.tree_map(
            jnp.asarray, params0), rng=1)
        params, history = trainer.run(
            ({k: jnp.asarray(v) for k, v in b.items()} for b in batches),
            ROUNDS)
        runs[scheme] = dict(
            params=_np(params), offsets=[_offsets(fed, r)
                                         for r in range(ROUNDS)],
            client_loss=[np.asarray(h["client_loss"]) for h in history])
    return dict(params0=params0, batches=batches, runs=runs)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


# -- (a) the extract module ---------------------------------------------------


def _plan(ref_model):
    fed = ref_api.fed_round(ref_model, RefSubmodelConfig(**SCFG),
                            kernel_backend="jnp", fused_forward="off")
    off = {k: int(np.asarray(v)[0]) for k, v in
           fed.scheme.offsets(None, 1, C).items()}
    return fed.scheme.sizes, off


def test_sub_abstract_matches_reference(ref_model, port_model):
    sizes, _ = _plan(ref_model)
    want = ref_ex.sub_abstract(ref_model.abstract_params(), ref_model.axes(),
                               sizes)
    got = ex.sub_abstract(port_model.abstract_params(), port_model.axes(),
                          sizes)
    ref_shapes = convert.from_reference(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), want), device="cpu")
    assert {k: v.shape for k, v in ref_shapes.items()} == got
    assert got["layers/0/mlp/w_gate"][-1] == sizes[("d_ff", 512)]


def test_scatter_delta_and_window_mask_match_reference(ref_model,
                                                       port_model):
    sizes, off = _plan(ref_model)
    sub = ref_ex.sub_abstract(ref_model.abstract_params(), ref_model.axes(),
                              sizes)
    rng = np.random.default_rng(3)
    delta = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), sub)
    want = _np(ref_ex.scatter_delta(
        jax.tree_util.tree_map(jnp.asarray, delta),
        ref_model.abstract_params(), ref_model.axes(), off, sizes))
    got = ex.scatter_delta(convert.from_reference(delta, device="cpu"),
                           port_model.abstract_params(), port_model.axes(),
                           off, sizes)
    got = _leaves(convert.to_reference(got))
    for path, w in _leaves(want).items():
        np.testing.assert_array_equal(got[path], w, err_msg=str(path))

    want = _np(ref_ex.window_mask(ref_model.abstract_params(),
                                  ref_model.axes(), off, sizes))
    got = _leaves(convert.to_reference(ex.window_mask(
        port_model.abstract_params(), port_model.axes(), off, sizes)))
    for path, m in _leaves(want).items():
        np.testing.assert_array_equal(got[path], m, err_msg=str(path))


def test_scatter_delta_of_an_unwindowed_leaf_is_the_leaf():
    d = {"w": torch.randn(3, 4)}
    out = ex.scatter_delta(d, {"w": torch.Size([3, 4])}, {"w": ("a", "b")},
                           {}, {})
    assert out["w"] is d["w"]


# -- (b) extract rounds against the reference's extract arm -------------------


def _port_fed(port_model, scheme, **kw):
    return api.fed_round(port_model, SubmodelConfig(**{**SCFG,
                                                       "scheme": scheme}),
                         device="cpu", **kw)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_three_extract_rounds_match_reference(reference_runs, port_model,
                                              scheme):
    ref = reference_runs
    run = ref["runs"][scheme]
    fed = _port_fed(port_model, scheme, fused_forward="off")
    assert not fed.use_fused
    trainer = api.Trainer(fed, convert.from_reference(ref["params0"], "cpu"))
    trainer.run(((b, {"offsets": o}) for b, o in
                 zip(ref["batches"], run["offsets"])), ROUNDS)
    for r, h in enumerate(trainer.history):
        np.testing.assert_allclose(h["client_loss"].numpy(),
                                   run["client_loss"][r], atol=ATOL,
                                   rtol=RTOL)
    got = _leaves(convert.to_reference(trainer.params))
    for path, want in _leaves(run["params"]).items():
        np.testing.assert_allclose(got[path], want, atol=ATOL, rtol=RTOL,
                                   err_msg=str(path))


def test_scheme_full_trains_full_replicas_without_offsets(port_model):
    """Scheme ``full`` resolves to the extract phase with no windowed axis:
    offsets are empty and every leaf moves."""
    fed = _port_fed(port_model, "full")
    assert not fed.use_fused and fed.scheme.sizes == {}
    assert fed._client_offsets(0) == {}
    params = port_model.init(0, device="cpu")
    before = {k: v.clone() for k, v in params.items()}
    batch = {"tokens": torch.randint(0, 512, (2, C, 2, S))}
    fed.round(params, batch, 0)
    assert all(not torch.equal(params[k], before[k]) for k in params)


# -- (c) fused == extract inside the port, 0 ulp -------------------------------


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("over", [{}, dict(d_ff=768, n_kv_heads=2)],
                         ids=["reduced", "d_ff768_kv2"])
def test_fused_equals_extract_to_the_bit(over):
    """The dense family's fused client phase (full copies through the
    window-aware forward) and its extract phase (compact copies through
    the ordinary forward) give the same rounds bit for bit: losses and
    every param, 3 rolling rounds.  The second config's windows (d_ff 384
    of 768) are where a per-client ``mm`` rounds otherwise than ``bmm`` on
    the CPU: the plain products take one ``bmm`` for a shared window, as
    the extract phase does."""
    cfg = dataclasses.replace(get_reduced_config("tinyllama_1_1b"), **over)
    model = build_model(cfg)
    batches = lm_batches(cfg.vocab, (2, C, 2), S, seed=0)
    batches = [next(batches) for _ in range(ROUNDS)]
    out = {}
    for ff in ("on", "off"):
        fed = api.fed_round(model, SubmodelConfig(**SCFG), fused_forward=ff,
                            device="cpu")
        assert fed.use_fused == (ff == "on")
        trainer = api.Trainer(fed, model.init(0, device="cpu"))
        trainer.run(iter(batches), ROUNDS)
        out[ff] = trainer
    fused, extract = out["on"], out["off"]
    for a, b in zip(fused.history, extract.history):
        assert torch.equal(_bits(a["client_loss"]), _bits(b["client_loss"]))
    for k in fused.params:
        assert torch.equal(_bits(fused.params[k]),
                           _bits(extract.params[k])), k


# -- (d) fed_round's choice of client phase ------------------------------------


def _plain(model):
    """The model's loss without ``window=`` (a triple the fused phase
    cannot take)."""
    return (lambda p, b: model.loss(p, b), model.abstract_params(),
            model.axes())


def test_triple_without_window_builds_the_extract_round(reference_runs,
                                                        port_model):
    ref = reference_runs
    fed = api.fed_round(_plain(port_model), SubmodelConfig(**SCFG),
                        device="cpu")
    assert isinstance(fed, api.WindowFedAvg) and not fed.use_fused
    assert fed.windowed_loss_fn is None
    trainer = api.Trainer(fed, convert.from_reference(ref["params0"], "cpu"))
    run = ref["runs"]["rolling"]
    trainer.run(((b, {"offsets": o}) for b, o in
                 zip(ref["batches"], run["offsets"])), ROUNDS)
    got = _leaves(convert.to_reference(trainer.params))
    for path, want in _leaves(run["params"]).items():
        np.testing.assert_allclose(got[path], want, atol=ATOL, rtol=RTOL,
                                   err_msg=str(path))


def _ref_plain(model):
    return (lambda p, b: model.loss(p, b), model.abstract_params(),
            model.axes())


@pytest.mark.parametrize("case", [
    ("no window loss", dict(), True),
    ("scheme full", dict(scheme="full"), False),
    ("d_model axis", dict(axes=("d_model",)), False),
], ids=lambda c: c[0])
def test_fused_on_raises_where_the_reference_raises(ref_model, port_model,
                                                    case):
    _, over, plain = case
    ref_m = _ref_plain(ref_model) if plain else ref_model
    port_m = _plain(port_model) if plain else port_model
    with pytest.raises(ValueError, match="fused_forward=True requires"):
        ref_api.fed_round(ref_m, RefSubmodelConfig(**{**SCFG, **over}),
                          fused_forward="on")
    with pytest.raises(ValueError, match="fused_forward=True requires"):
        api.fed_round(port_m, SubmodelConfig(**{**SCFG, **over}),
                      fused_forward="on", device="cpu")
    for ff in ("auto", "off", False):
        fed = api.fed_round(port_m, SubmodelConfig(**{**SCFG, **over}),
                            fused_forward=ff, device="cpu")
        assert not fed.use_fused


def test_uncovered_axis_runs_the_extract_phase(port_model):
    """``d_model`` has no fused forward: ``auto`` takes the extract phase,
    which trains compact copies narrowed on it."""
    scfg = SubmodelConfig(**{**SCFG, "axes": ("d_model", "d_ff")})
    fed = api.fed_round(port_model, scfg, device="cpu")
    assert not fed.use_fused
    params = port_model.init(0, device="cpu")
    _, metrics = fed.round(params, {"tokens": torch.randint(
        0, 512, (2, C, 2, S))}, 0)
    assert torch.isfinite(metrics["client_loss"]).all()


# -- (e) output_model -----------------------------------------------------------


def test_output_model_matches_reference(reference_runs, ref_model,
                                        port_model):
    ref = reference_runs
    params0 = jax.tree_util.tree_map(jnp.asarray, ref["params0"])
    batch = ref["batches"][0]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(5)
    cases = [("bernoulli", "mask"), ("rolling", "window"),
             ("full", "window")]
    for scheme, mode in cases:
        over = {**SCFG, "scheme": scheme}
        rfed = ref_api.fed_round(ref_model, RefSubmodelConfig(**over),
                                 mode=mode, kernel_backend="jnp",
                                 fused_forward="off" if mode == "window"
                                 else "auto")
        want = _np(ref_output_model(rfed, params0, jbatch, key,
                                    lipschitz=2.0, round_idx=1))
        fed = api.fed_round(port_model, SubmodelConfig(**over), mode=mode,
                            device="cpu")
        kw = {}
        if mode == "mask":
            kw["masks"] = convert.from_reference(_np(ref_masks(
                key, ref_model.abstract_params(), ref_model.axes(),
                rfed.scfg, rfed.capacities, 1)), "cpu", lead=1)
        else:
            kw["offsets"] = _offsets(rfed, 1)
        params = convert.from_reference(ref["params0"], "cpu")
        got = output_model(fed, params, batch, lipschitz=2.0, round_idx=1,
                           **kw)
        assert all(torch.equal(params[k], v) for k, v in
                   convert.from_reference(ref["params0"], "cpu").items())
        got = _leaves(convert.to_reference(got))
        for path, w in _leaves(want).items():
            np.testing.assert_allclose(got[path], w, atol=ATOL, rtol=RTOL,
                                       err_msg=f"{scheme} {path}")


# -- (f) the example ------------------------------------------------------------


def test_quickstart_example_runs_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
         "--device", "cpu", "--rounds", "4"], capture_output=True,
        text=True, env=env, timeout=300, check=True).stdout
    assert "OK" in out and "window sizes" in out
