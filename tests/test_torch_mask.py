"""The port's mask-mode round against the JAX reference.

``repro_torch``'s ``dense_client_masks``, ``MaskFedAvg`` and ``api.Trainer``
on the CPU against ``repro`` with ``kernel_backend="jnp"``, on reduced
TinyLlama (2 layers), S = 32, C = 4, K = 2, from the same params (converted
through numpy) and the same tokens.  torch cannot reproduce ``jax.random``,
so the reference's masks (and its rolling offsets) are injected into the
port.  Tolerance: the deterministic masks are equal exactly; rounds are
float32, atol 1e-5 and rtol 1e-5 on params and per-client losses -- the
frameworks' matmuls sum in different orders, a few ulp each, and 6 SGD
steps at lr 0.1 carry that into the weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as ref_api  # noqa: E402
from repro.configs.base import SubmodelConfig as RefSubmodelConfig  # noqa
from repro.configs.base import get_reduced_config as ref_reduced  # noqa: E402
from repro.core.fedavg import dense_client_masks as ref_masks  # noqa: E402
from repro.core.masking import collect_axis_dims as ref_dims  # noqa: E402
from repro.core.masking import make_scheme as ref_make_scheme  # noqa: E402
from repro.data.synthetic import lm_batches as ref_lm_batches  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch.configs.base import (SubmodelConfig,  # noqa: E402
                                      get_reduced_config)
from repro_torch.core.fedavg import dense_client_masks  # noqa: E402
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ATOL = RTOL = 1e-5
ROUNDS, S, C = 3, 32, 4
BASE = dict(capacity=0.5, local_steps=2, clients_per_round=C, client_lr=0.1,
            axes=("d_ff", "heads", "kv_heads"))
HETERO = [1.0, 0.5, 0.25, 0.125]
RUNS = {"bernoulli": (dict(scheme="bernoulli"), [0.5] * C),
        "rolling_hetero": (dict(scheme="rolling"), HETERO)}


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


@pytest.fixture(scope="module")
def ref_model():
    return ref_build(ref_reduced("tinyllama_1_1b"), remat=False)


@pytest.fixture(scope="module")
def port_model():
    return build_model(get_reduced_config("tinyllama_1_1b"))


def _ref_masks(model, scfg, caps, r, key=None):
    return _np(ref_masks(key, model.abstract_params(), model.axes(), scfg,
                         jnp.asarray(caps, jnp.float32), r))


@pytest.fixture(scope="module")
def reference_runs(ref_model):
    """Three reference mask rounds per case of ``RUNS``, with the masks each
    round drew, shared by the tests of this module."""
    model = ref_model
    params0 = _np(model.init(jax.random.PRNGKey(0)))
    it = ref_lm_batches(model.cfg.vocab, (2, C, 2), S, seed=0)
    batches = [next(it) for _ in range(ROUNDS)]
    out = {}
    for name, (over, caps) in RUNS.items():
        scfg = RefSubmodelConfig(**BASE, **over)
        fed = ref_api.fed_round(model, scfg, mode="mask",
                                capacities=np.asarray(caps, np.float32),
                                kernel_backend="jnp")
        step = jax.jit(fed.round)
        key = jax.random.PRNGKey(1)
        params = jax.tree_util.tree_map(jnp.asarray, params0)
        masks, client_loss = [], []
        for r in range(ROUNDS):
            key, sub = jax.random.split(key)
            masks.append(_ref_masks(model, scfg, caps, r, sub))
            params, metrics = step(
                params, {k: jnp.asarray(v) for k, v in batches[r].items()},
                r, sub)
            client_loss.append(np.asarray(metrics["client_loss"]))
        out[name] = dict(masks=masks, params=_np(params),
                         client_loss=client_loss)
    return dict(params0=params0, batches=batches, runs=out)


def _port_masks(port_model, scfg, caps, r, **kw):
    return dense_client_masks(None, port_model.abstract_params(),
                              port_model.axes(), scfg, caps, r,
                              torch.device("cpu"), **kw)


@pytest.mark.parametrize("case", [
    ("full", dict(scheme="full"), [0.5] * C, 0),
    ("static", dict(scheme="static"), HETERO, 0),
    ("rolling", dict(scheme="rolling"), [0.5] * C, 3),
    ("stagger", dict(scheme="rolling", stagger=True), [0.5] * C, 5),
    ("wrap", dict(scheme="rolling", stagger=True, wrap=True), HETERO, 2),
    ("hetero", dict(scheme="rolling", align=2), HETERO, 1),
], ids=lambda c: c[0])
def test_dense_masks_equal_reference(ref_model, port_model, case):
    _, over, caps, r = case
    ref_scfg = RefSubmodelConfig(**{**BASE, **over})
    want = _ref_masks(ref_model, ref_scfg, caps, r)
    kw = {}
    if over["scheme"] == "rolling":     # the reference's jax.random order
        plan = ref_make_scheme(ref_scfg, ref_dims(ref_model.abstract_params(),
                                                  ref_model.axes()))
        kw["offsets"] = {k: [int(o) for o in np.asarray(v)] for k, v in
                         plan.offsets(None, r, C).items()}
    got = _port_masks(port_model, SubmodelConfig(**{**BASE, **over}), caps,
                      r, **kw)
    got = dict(jax.tree_util.tree_leaves_with_path(
        convert.to_reference(got, lead=1)))
    for path, m in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_array_equal(got[path], m, err_msg=str(path))


def test_bernoulli_masks_follow_capacities_and_seed(port_model):
    scfg = SubmodelConfig(scheme="bernoulli", **BASE)

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return dense_client_masks(g, port_model.abstract_params(),
                                  port_model.axes(), scfg, HETERO, 0,
                                  torch.device("cpu"))

    masks = draw(7)
    n = sum(m[0].numel() for m in masks.values())
    ones = sum(m.reshape(C, -1).sum(1) for m in masks.values())
    for c, p in enumerate(HETERO):       # within 6 binomial sigmas
        assert abs(float(ones[c]) / n - p) <= 6 * np.sqrt(p * (1 - p) / n)
    assert all(set(m.unique().tolist()) <= {0.0, 1.0} for m in masks.values())
    again, other = draw(7), draw(8)
    assert all(torch.equal(masks[k], again[k]) for k in masks)
    assert not all(torch.equal(masks[k], other[k]) for k in masks)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_three_mask_rounds_match_reference(reference_runs, port_model, name):
    ref = reference_runs
    run = ref["runs"][name]
    over, caps = RUNS[name]
    fed = api.fed_round(port_model, SubmodelConfig(**BASE, **over),
                        mode="mask", capacities=caps, device="cpu")
    trainer = api.Trainer(fed, convert.from_reference(ref["params0"], "cpu"))
    trainer.run(((b, {"masks": convert.from_reference(m, "cpu", lead=1)})
                 for b, m in zip(ref["batches"], run["masks"])), ROUNDS)
    for r, h in enumerate(trainer.history):
        np.testing.assert_allclose(h["client_loss"].numpy(),
                                   run["client_loss"][r], atol=ATOL,
                                   rtol=RTOL)
    got = dict(jax.tree_util.tree_leaves_with_path(
        convert.to_reference(trainer.params)))
    for path, want in jax.tree_util.tree_leaves_with_path(run["params"]):
        np.testing.assert_allclose(got[path], want, atol=ATOL, rtol=RTOL,
                                   err_msg=str(path))


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_client_phase_shortcut_is_literal_to_the_bit(reference_runs,
                                                     port_model):
    """Plain SGD: running the model on ``w_c`` instead of ``m * w_c`` gives
    the literal ``m * grad f(m * w_c)`` update bit for bit (signed zeros
    included), K steps, losses and every client leaf."""
    ref = reference_runs
    fed = api.fed_round(port_model, SubmodelConfig(scheme="bernoulli",
                                                   **BASE), device="cpu")
    params = convert.from_reference(ref["params0"], "cpu")
    masks = convert.from_reference(ref["runs"]["bernoulli"]["masks"][0],
                                   "cpu", lead=1)
    batch = {"tokens": torch.as_tensor(ref["batches"][0]["tokens"]).long()}
    fast, l_fast = fed.client_phase(params, batch, masks)
    lit, l_lit = fed.client_phase(params, batch, masks, literal=True)
    assert torch.equal(_bits(l_fast), _bits(l_lit))
    for k in fast:
        assert torch.equal(_bits(fast[k]), _bits(lit[k])), k


def test_trainer_trains_on_its_own_masks(port_model):
    """No injected masks: the Trainer's own generator draws them; the loss
    falls over a few rounds, and the seed reproduces the run."""
    fed = api.fed_round(port_model, SubmodelConfig(scheme="bernoulli",
                                                   **BASE), device="cpu")
    losses = []
    for _ in range(2):
        trainer = api.Trainer(fed, port_model.init(0, device="cpu"), rng=5)
        trainer.run(lm_batches(512, (2, C, 2), S, seed=0), 6)
        losses.append(trainer.losses)
    assert all(np.isfinite(losses[0]))
    assert losses[0][-1] < losses[0][0]
    assert losses[0] == losses[1]


def test_per_round_capacities_ride_in_the_round_kwargs(port_model):
    """The paper's protocol passes each round's participants' capacities:
    clients at capacity 1 move (nearly) every coordinate of ``w_up``; at
    the default 0.5 the shared rolling window leaves half its columns
    exactly as they were."""
    scfg = SubmodelConfig(scheme="rolling", **BASE)
    fed = api.fed_round(port_model, scfg, mode="mask", device="cpu")
    batch = next(lm_batches(512, (2, C, 2), S, seed=0))
    w = "layers/0/mlp/w_up"
    moved = {}
    for caps in ([1.0] * C, None):
        params = port_model.init(0, device="cpu")
        before = params[w].clone()
        trainer = api.Trainer(fed, params)
        trainer.run(iter([(batch, {"capacities": caps})]), 1)
        moved[caps is None] = float((trainer.params[w] != before).float()
                                    .mean())
    assert moved[False] > 0.9 and moved[True] <= 0.5
    with pytest.raises(ValueError, match="capacities"):
        trainer.step(batch, {"capacities": [1.0] * (C - 1)})


def test_trainer_keeps_float_batch_leaves():
    seen = {}

    class Fed:
        device = torch.device("cpu")

        def round(self, params, batch, round_idx, generator=None):
            seen.update(batch)
            return params, {"loss": torch.zeros(())}

    api.Trainer(Fed(), {}).step({"tokens": np.zeros((1, 2), np.int32),
                                 "scaler": np.ones((1, 2), np.float32)})
    assert seen["tokens"].dtype == torch.long
    assert seen["scaler"].dtype == torch.float32


def test_mask_entry_points_raise_without_a_card(monkeypatch, port_model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for scheme, mode in (("bernoulli", "auto"), ("rolling", "mask")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            api.fed_round(port_model, SubmodelConfig(scheme=scheme, **BASE),
                          mode=mode)


@pytest.mark.parametrize("kw", [
    dict(mode="window"), dict(spmd_axis="clients"), dict(mesh=object()),
    dict(fused_forward="on"), dict(uplink_compression="bf16"),
    dict(capacities=[0.5] * (C + 1)), dict(mode="tiles")])
def test_mask_mode_rejects_what_the_reference_rejects(port_model, kw):
    with pytest.raises(ValueError):
        api.fed_round(port_model, SubmodelConfig(scheme="bernoulli", **BASE),
                      device="cpu", **kw)


def test_importance_masks_and_server_opt_raise(port_model):
    fed = api.fed_round(port_model, SubmodelConfig(scheme="importance",
                                                   **BASE),
                        mode="mask", device="cpu")
    batch = next(lm_batches(512, (2, C, 2), S, seed=0))
    with pytest.raises(ValueError, match="importance"):
        api.Trainer(fed, port_model.init(0, device="cpu")).step(batch)
    with pytest.raises(ValueError, match="no server optimizer"):
        fed.round_with_server_opt(port_model.init(0, device="cpu"), None,
                                  batch, 0)
