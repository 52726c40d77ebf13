"""The port's shared-window federated round against the JAX reference.

Three rounds of ``repro_torch.api.fed_round`` + ``Trainer`` on the CPU
against ``repro.api`` with ``kernel_backend="jnp"``, from the same params
(converted through numpy), the same tokens and the same window offsets:
the reference draws its rolling order with ``jax.random``, so its
``WindowScheme.offsets`` are injected into the port's round.  Tolerance:
float32, atol 1e-5 and rtol 1e-5 on params and per-client losses -- the
frameworks' summation orders differ by a few ulp per matmul, and 6 SGD
steps at lr 0.1 carry that into the weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as ref_api  # noqa: E402
from repro.configs.base import SubmodelConfig as RefSubmodelConfig  # noqa
from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.configs.base import get_reduced_config as ref_reduced  # noqa: E402
from repro.core.masking import collect_axis_dims as ref_dims  # noqa: E402
from repro.core.masking import make_scheme as ref_make_scheme  # noqa: E402
from repro.data.synthetic import lm_batches as ref_lm_batches  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch.configs.base import (SubmodelConfig, get_config,  # noqa
                                      get_reduced_config)
from repro_torch.core.masking import collect_axis_dims, make_scheme  # noqa
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ATOL = RTOL = 1e-5
ROUNDS, S = 3, 32
SCFG = dict(scheme="rolling", capacity=0.5, local_steps=2,
            clients_per_round=4, client_lr=0.1,
            axes=("d_ff", "heads", "kv_heads"))


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
def reference_run():
    """One 3-round reference run, shared by the tests of this module."""
    cfg = ref_reduced("tinyllama_1_1b")
    model = ref_build(cfg, remat=False)
    params0 = _np(model.init(jax.random.PRNGKey(0)))
    fed = ref_api.fed_round(model, RefSubmodelConfig(**SCFG),
                            kernel_backend="jnp")
    assert fed.use_fused and fed.shared_window
    it = ref_lm_batches(cfg.vocab, (2, 4, 2), S, seed=0)
    batches = [next(it) for _ in range(ROUNDS)]
    offsets = [{k: [int(o) for o in np.asarray(v)] for k, v in
                fed.scheme.offsets(None, r, 4).items()}
               for r in range(ROUNDS)]
    trainer = ref_api.Trainer(fed, jax.tree_util.tree_map(jnp.asarray,
                                                          params0), rng=1)
    params, history = trainer.run(
        ({k: jnp.asarray(v) for k, v in b.items()} for b in batches), ROUNDS)
    return dict(params0=params0, batches=batches, offsets=offsets,
                params=_np(params),
                client_loss=[np.asarray(h["client_loss"]) for h in history],
                fed=fed)


def _port_fed(device="cpu"):
    model = build_model(get_reduced_config("tinyllama_1_1b"))
    return model, api.fed_round(model, SubmodelConfig(**SCFG), device=device)


def test_scheme_plan_matches_reference():
    """Sizes, rolling grids, GQA derivation and alignment certificates."""
    for get, ref_get in ((get_reduced_config, ref_reduced),
                         (get_config, ref_config)):
        model = build_model(get("tinyllama_1_1b"))
        ours = make_scheme(SubmodelConfig(**SCFG), collect_axis_dims(
            model.abstract_params(), model.axes()))
        ref_model = ref_build(ref_get("tinyllama_1_1b"))
        theirs = ref_make_scheme(RefSubmodelConfig(**SCFG), ref_dims(
            ref_model.abstract_params(), ref_model.axes()))
        assert ours.sizes == theirs.sizes
        assert ours.derived == theirs.derived
        assert ours.n_windows == theirs.n_windows
        assert {k: list(v) for k, v in ours.grids.items()} == \
            {k: [int(o) for o in np.asarray(v)]
             for k, v in theirs.grids.items()}
        for k in ours.sizes:
            assert ours.grid_multiple(k) == theirs.grid_multiple(k)


def test_three_rounds_match_reference(reference_run):
    ref = reference_run
    _, fed = _port_fed()
    params = convert.from_reference(ref["params0"], device="cpu")
    trainer = api.Trainer(fed, params)
    trainer.run(((b, {"offsets": o}) for b, o in
                 zip(ref["batches"], ref["offsets"])), ROUNDS)
    for r, h in enumerate(trainer.history):
        np.testing.assert_allclose(h["client_loss"].numpy(),
                                   ref["client_loss"][r], atol=ATOL,
                                   rtol=RTOL)
    got = dict(jax.tree_util.tree_leaves_with_path(
        convert.to_reference(trainer.params)))
    for path, want in jax.tree_util.tree_leaves_with_path(ref["params"]):
        np.testing.assert_allclose(got[path], want, atol=ATOL, rtol=RTOL,
                                   err_msg=str(path))


def test_round_moves_only_the_window(reference_run):
    """Outside the round's shared window the server params stay bit-exact
    (the fused client phase gives them exactly zero gradient)."""
    ref = reference_run
    _, fed = _port_fed()
    params = convert.from_reference(ref["params0"], device="cpu")
    before = {k: v.clone() for k, v in params.items()}
    batch = {"tokens": torch.tensor(ref["batches"][0]["tokens"],
                                     dtype=torch.long)}
    offs = ref["offsets"][0]
    fed.round(params, batch, 0, offsets=offs)
    d_ff = get_reduced_config("tinyllama_1_1b").d_ff
    lo = offs[("d_ff", d_ff)][0]
    w_new, w_old = params["layers/0/mlp/w_up"], before["layers/0/mlp/w_up"]
    assert torch.equal(w_new[:, :lo], w_old[:, :lo])
    assert torch.equal(w_new[:, lo + d_ff // 2:], w_old[:, lo + d_ff // 2:])
    assert not torch.equal(w_new[:, lo:lo + d_ff // 2],
                           w_old[:, lo:lo + d_ff // 2])


@pytest.mark.parametrize("capacity", [0.25, 0.5, 0.75])
def test_rolling_schedule_visits_every_window_once_per_epoch(capacity):
    cfg = get_reduced_config("tinyllama_1_1b")
    model = build_model(cfg)
    scheme = make_scheme(
        SubmodelConfig(**{**SCFG, "capacity": capacity}),
        collect_axis_dims(model.abstract_params(), model.axes()))
    R = scheme.n_windows
    assert R > 1
    for epoch in range(3):
        seen = {k: [] for k in scheme.sizes}
        for r in range(epoch * R, (epoch + 1) * R):
            offs = scheme.offsets(r, 4)
            for k, v in offs.items():
                assert len(set(v)) == 1          # one shared window
                seen[k].append(v[0])
        for k in scheme.grids:
            assert sorted(seen[k]) == sorted(scheme.grids[k])
        kv = next(k for k in scheme.sizes if k[0] == "kv_heads")
        (heads, (src, group)), = scheme.derived.items()
        assert src == kv
        assert seen[heads] == [o * group for o in seen[kv]]


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_reduced_config("tinyllama_1_1b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.fed_round(model, SubmodelConfig(**SCFG))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.from_reference({"w": np.zeros(2, np.float32)})


def test_window_capacities_run_a_hetero_round():
    """Window-mode capacities build the width buckets and train: one round
    of reduced TinyLlama with a full-width, two half-width and a
    quarter-width client, each client on its bucket's window."""
    model = build_model(get_reduced_config("tinyllama_1_1b"))
    fed = api.fed_round(model, SubmodelConfig(**SCFG), device="cpu",
                        capacities=[1.0, 0.5, 0.5, 0.25])
    assert [(b.beta, b.idx) for b in fed.hetero] == \
        [(1.0, (0,)), (0.5, (1, 2)), (0.25, (3,))]
    assert [b.fed.use_fused for b in fed.hetero] == [False, True, True]
    params = model.init(0, device="cpu")
    before = {k: v.clone() for k, v in params.items()}
    tokens = next(lm_batches(512, (2, 4, 2), S, seed=0))["tokens"]
    _, metrics = fed.round(params, {"tokens": torch.as_tensor(
        tokens, dtype=torch.long)}, 0)
    assert metrics["client_loss"].shape == (2, 4)
    assert torch.isfinite(metrics["client_loss"]).all()
    assert all(not torch.equal(params[k], before[k]) for k in params)


@pytest.mark.parametrize("over", [
    dict(stagger=True), dict(scheme="random"), dict(shared_window=False),
    dict(scheme="random", axes=("d_model",))])
def test_per_client_schemes_run_a_round(over):
    """Per-client windows build and train (the last through the extract
    phase: ``d_model`` has no fused forward), each client on its own
    window where the scheme says so."""
    model = build_model(get_reduced_config("tinyllama_1_1b"))
    fed = api.fed_round(model, SubmodelConfig(**{**SCFG, **over}),
                        device="cpu")
    assert not fed.shared_window
    assert fed.use_fused == ("d_model" not in fed.scfg.axes)
    params = model.init(0, device="cpu")
    before = {k: v.clone() for k, v in params.items()}
    tokens = next(lm_batches(512, (2, 4, 2), S, seed=0))["tokens"]
    _, metrics = fed.round(params, {"tokens": torch.as_tensor(
        tokens, dtype=torch.long)}, 0)
    assert torch.isfinite(metrics["client_loss"]).all()
    assert any(not torch.equal(params[k], before[k]) for k in params)


def test_port_trainer_trains_on_its_own_schedule():
    """No injected offsets: the port's own rolling schedule; the loss
    falls over a few rounds of the port's own data."""
    model, fed = _port_fed()
    trainer = api.Trainer(fed, model.init(0, device="cpu"))
    trainer.run(lm_batches(512, (2, 4, 2), S, seed=0), 6)
    assert all(np.isfinite(trainer.losses))
    assert trainer.losses[-1] < trainer.losses[0]
