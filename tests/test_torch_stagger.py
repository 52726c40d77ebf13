"""Per-client windows in the port's window round against the JAX reference.

Staggered rolling, ``random`` and ``importance`` (shared and staggered)
windows, and the per-client aggregation forced with ``shared_window=False``
(``--no-shared-window``), on reduced TinyLlama (2 layers), S = 32, C = 4,
K = 2, on the CPU.  The reference runs ``kernel_backend="jnp"``, both its
fused arm (the batched-offset products) and its extract arm; the port runs
the same rounds from the same params (converted through numpy) and tokens.
torch cannot reproduce ``jax.random``, so the reference's rolling and
random offsets are injected; the importance offsets carry no random draw,
so the port computes its own and they must equal the reference's.

Tolerance: float32, atol 1e-5 and rtol 1e-5 on params and per-client
losses, as ``tests/test_torch_round.py`` and ``test_torch_extract.py``:
the frameworks' matmuls sum in different orders, a few ulp each, and 6 SGD
steps at lr 0.1 carry that into the weights (the largest difference seen
is about 1e-6).  Inside the port the fused and the extract client phases
agree to 0 ulp for per-client windows too, at windows of 256 and of 384
columns (past the width where one ``mm`` per client rounds otherwise than
one ``bmm``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as ref_api  # noqa: E402
from repro.configs.base import SubmodelConfig as RefSubmodelConfig  # noqa
from repro.configs.base import get_reduced_config as ref_reduced  # noqa: E402
from repro.data.synthetic import lm_batches as ref_lm_batches  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch.configs.base import (SubmodelConfig,  # noqa: E402
                                      get_reduced_config)
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ATOL = RTOL = 1e-5
ROUNDS, S, C = 3, 32, 4
SCFG = dict(scheme="rolling", capacity=0.5, local_steps=2,
            clients_per_round=C, client_lr=0.1,
            axes=("d_ff", "heads", "kv_heads"))
# name -> (SubmodelConfig overrides, the reference's fused_forward)
CASES = {
    "stagger_fused": (dict(stagger=True), "auto"),
    "stagger_extract": (dict(stagger=True), "off"),
    "random": (dict(scheme="random"), "auto"),
    "importance": (dict(scheme="importance"), "auto"),
    "importance_stagger": (dict(scheme="importance", stagger=True), "auto"),
    "no_shared_window": (dict(shared_window=False), "auto"),
}


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


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _host(offsets):
    return {k: [int(o) for o in np.asarray(v)] for k, v in offsets.items()}


@pytest.fixture(scope="module")
def ref_model():
    return ref_build(ref_reduced("tinyllama_1_1b"), remat=False)


@pytest.fixture(scope="module")
def port_model():
    return build_model(get_reduced_config("tinyllama_1_1b"))


@pytest.fixture(scope="module")
def reference_runs(ref_model):
    """Three reference rounds per case of ``CASES``, one at a time, with
    the offsets each round took (read off the round's params for
    ``importance``), shared by the tests of this module."""
    params0 = _np(ref_model.init(jax.random.PRNGKey(0)))
    it = ref_lm_batches(ref_model.cfg.vocab, (2, C, 2), S, seed=0)
    batches = [next(it) for _ in range(ROUNDS)]
    runs = {}
    for name, (over, ff) in CASES.items():
        fed = ref_api.fed_round(ref_model,
                                RefSubmodelConfig(**{**SCFG, **over}),
                                kernel_backend="jnp", fused_forward=ff)
        assert fed.use_fused == (ff == "auto")
        assert fed.shared_window == (name == "importance")
        trainer = ref_api.Trainer(fed, jax.tree_util.tree_map(
            jnp.asarray, params0), rng=1)
        offsets = []
        for b in batches:
            offsets.append(_host(fed._client_offsets(
                trainer.params, trainer.round_idx, None)))
            trainer.run(iter([{k: jnp.asarray(v) for k, v in b.items()}]), 1)
        runs[name] = dict(
            params=_np(trainer.params), offsets=offsets,
            client_loss=[np.asarray(h["client_loss"])
                         for h in trainer.history])
    return dict(params0=params0, batches=batches, runs=runs)


def _port_fed(port_model, over, **kw):
    return api.fed_round(port_model, SubmodelConfig(**{**SCFG, **over}),
                         device="cpu", **kw)


def _close(trainer, run, what):
    for r, h in enumerate(trainer.history):
        np.testing.assert_allclose(h["client_loss"].numpy(),
                                   run["client_loss"][r], atol=ATOL,
                                   rtol=RTOL, err_msg=f"{what} round {r}")
    got = _leaves(convert.to_reference(trainer.params))
    for path, want in _leaves(run["params"]).items():
        np.testing.assert_allclose(got[path], want, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{what} {path}")


# -- (a) the offsets ----------------------------------------------------------


def test_per_client_schemes_take_distinct_windows(reference_runs):
    """The staggered and random schemes give the clients other windows in
    one round; the shared ones (importance, and rolling with the
    per-client aggregation forced) one window."""
    runs = reference_runs["runs"]
    for name in ("stagger_fused", "random", "importance_stagger"):
        d_ff = [v for k, v in runs[name]["offsets"][0].items()
                if k[0] == "d_ff"][0]
        assert len(set(d_ff)) > 1, (name, d_ff)
    for name in ("importance", "no_shared_window"):
        assert all(len(set(v)) == 1 for o in runs[name]["offsets"]
                   for v in o.values()), name


@pytest.mark.parametrize("stagger", [False, True], ids=["shared", "stagger"])
def test_importance_offsets_match_reference(ref_model, port_model,
                                            reference_runs, stagger):
    """``WindowScheme.importance_offsets`` on the same params gives the
    reference's offsets (the stable ranking keeps client 0 on the
    largest window; ``heads`` follow ``kv_heads`` times the group)."""
    over = dict(scheme="importance", stagger=stagger)
    ref_fed = ref_api.fed_round(ref_model,
                                RefSubmodelConfig(**{**SCFG, **over}),
                                kernel_backend="jnp")
    fed = _port_fed(port_model, over)
    rng = np.random.default_rng(7)
    for params in (reference_runs["params0"],
                   reference_runs["runs"]["random"]["params"],
                   jax.tree_util.tree_map(
                       lambda x: rng.standard_normal(x.shape).astype(
                           np.float32), reference_runs["params0"])):
        want = _host(ref_fed.scheme.importance_offsets(
            jax.tree_util.tree_map(jnp.asarray, params), ref_model.axes(), C))
        got = fed.scheme.importance_offsets(
            convert.from_reference(params, "cpu"), fed.axes, C)
        assert got == want
    heads = [k for k in got if k[0] == "heads"][0]
    (src, group), = fed.scheme.derived.values()
    assert got[heads] == [o * group for o in got[src]]


def test_random_offsets_are_aligned_and_in_range(port_model):
    """The port's own ``random`` draw: ``randint(0, (n - w) // align + 1)
    * align`` per client, seeded by ``(seed, round, axis)``, so a round's
    offsets repeat and the next round's differ."""
    for align in (1, 32):
        fed = _port_fed(port_model, dict(scheme="random", align=align))
        assert fed.scheme.grid_multiple(("d_ff", 512)) == align
        seen = [fed._client_offsets(r) for r in range(4)]
        assert fed._client_offsets(1) == seen[1] and seen[0] != seen[1]
        for offs in seen:
            for k, v in offs.items():
                if k in fed.scheme.derived:
                    continue
                assert all(0 <= o <= k[1] - fed.scheme.sizes[k]
                           and o % align == 0 for o in v), (k, v)


# -- (b) three rounds against the reference -----------------------------------


@pytest.mark.parametrize("name", ["stagger_fused", "stagger_extract",
                                  "random", "no_shared_window"])
def test_three_per_client_rounds_match_reference(reference_runs, port_model,
                                                 name):
    """The port's fused round (or, for ``stagger_extract``, its extract
    round) with the reference's offsets injected, against the same arm of
    the reference."""
    ref = reference_runs
    run = ref["runs"][name]
    over, ff = CASES[name]
    fed = _port_fed(port_model, over, fused_forward=ff)
    assert fed.use_fused == (ff == "auto") and not fed.shared_window
    trainer = api.Trainer(fed, convert.from_reference(ref["params0"], "cpu"))
    trainer.run(((b, {"offsets": o}) for b, o in
                 zip(ref["batches"], run["offsets"])), ROUNDS)
    _close(trainer, run, name)


@pytest.mark.parametrize("name", ["importance", "importance_stagger"])
def test_importance_rounds_match_reference(reference_runs, port_model, name):
    """The port reads each round's importance offsets off its own params;
    they equal the reference's, and so do the rounds."""
    ref = reference_runs
    run = ref["runs"][name]
    fed = _port_fed(port_model, CASES[name][0])
    assert fed.use_fused
    trainer = api.Trainer(fed, convert.from_reference(ref["params0"], "cpu"))
    for r, b in enumerate(ref["batches"]):
        assert fed._client_offsets(r, trainer.params) == run["offsets"][r]
        trainer.run(iter([b]), 1)
    _close(trainer, run, name)


def test_staggered_fused_agrees_with_reference_extract_arm(reference_runs):
    """The reference's own fused and extract arms agree on the dense GQA
    staggered round (its failing staggered pins are the SSM and hybrid
    families'); the port is held against both above."""
    runs = reference_runs["runs"]
    fused, extract = runs["stagger_fused"], runs["stagger_extract"]
    for path, want in _leaves(extract["params"]).items():
        np.testing.assert_allclose(_leaves(fused["params"])[path], want,
                                   atol=ATOL, rtol=RTOL, err_msg=str(path))


# -- (c) inside the port ------------------------------------------------------


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("over", [{}, dict(d_ff=768, n_kv_heads=2)],
                         ids=["dff512_win256", "dff768_win384"])
@pytest.mark.parametrize("scheme", [dict(stagger=True),
                                    dict(scheme="random")],
                         ids=["stagger", "random"])
def test_per_client_fused_equals_extract_to_the_bit(over, scheme):
    """Per-client windows: the fused client phase (full copies through the
    batched-offset products and the per-client row gathers of ``w_down``
    and ``wo``) and the extract phase (stacked per-client compact copies)
    give the same 3 rounds bit for bit, losses and every param, at d_ff
    windows of 256 and 384 columns: the plain products take one ``bmm`` on
    the gathered windows, as the extract phase does."""
    cfg = dataclasses.replace(get_reduced_config("tinyllama_1_1b"), **over)
    model = build_model(cfg)
    it = lm_batches(cfg.vocab, (2, C, 2), S, seed=0)
    batches = [next(it) for _ in range(ROUNDS)]
    out = {}
    for ff in ("on", "off"):
        fed = api.fed_round(model, SubmodelConfig(**{**SCFG, **scheme}),
                            fused_forward=ff, device="cpu")
        assert fed.use_fused == (ff == "on") and not fed.shared_window
        trainer = api.Trainer(fed, model.init(0, device="cpu"))
        trainer.run(iter(batches), ROUNDS)
        out[ff] = trainer
    d_ff = [v for k, v in fed._client_offsets(0).items() if k[0] == "d_ff"]
    assert len(set(d_ff[0])) > 1
    fused, extract = out["on"], out["off"]
    for a, b in zip(fused.history, extract.history):
        assert torch.equal(_bits(a["client_loss"]), _bits(b["client_loss"]))
    for k in fused.params:
        assert torch.equal(_bits(fused.params[k]),
                           _bits(extract.params[k])), k


def test_no_shared_window_equals_the_shared_round(port_model):
    """``shared_window=False`` with the rolling scheme's one window a
    round: the per-client aggregation (the clients' full changes summed
    over C) against the shared-window one (the mean compact change,
    scattered once), 3 rounds from the same params, within the stated
    tolerance."""
    it = lm_batches(512, (2, C, 2), S, seed=0)
    batches = [next(it) for _ in range(ROUNDS)]
    out = {}
    for over in ({}, dict(shared_window=False)):
        fed = _port_fed(port_model, over)
        assert fed.use_fused and fed.shared_window == (not over)
        trainer = api.Trainer(fed, port_model.init(0, device="cpu"))
        trainer.run(iter(batches), ROUNDS)
        out[bool(over)] = trainer
    a, b = out[False], out[True]
    for x, y in zip(a.history, b.history):
        np.testing.assert_allclose(x["client_loss"], y["client_loss"],
                                   atol=ATOL, rtol=RTOL)
    for k in a.params:
        np.testing.assert_allclose(a.params[k], b.params[k], atol=ATOL,
                                   rtol=RTOL, err_msg=k)


def test_per_client_windows_gather_w_down_and_wo_rows():
    """``AxisWindow.take``: a shared window is a view of the leaf; distinct
    offsets are one gather ``[C, win, ...]`` whose backward writes the
    clients' rows into one full-shaped zero gradient."""
    from repro_torch.models.layers import AxisWindow
    w = torch.randn(3, 10, 4, requires_grad=True)
    shared = AxisWindow([2, 2, 2], 5).take(w)
    assert shared._base is w or shared.data_ptr() == w[:, 2:].data_ptr()
    spec = AxisWindow([0, 3, 5], 5)
    sub = spec.take(w)
    assert sub.shape == (3, 5, 4)
    for c, o in enumerate(spec.offsets):
        assert torch.equal(sub[c], w[c, o:o + 5])
    (g,) = torch.autograd.grad(sub.sum(), [w])
    for c, o in enumerate(spec.offsets):
        assert g[c, o:o + 5].eq(1).all() and g[c].sum() == 5 * 4
    with pytest.raises(ValueError, match="differ"):
        spec.shared_offset()
