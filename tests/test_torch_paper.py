"""The port's paper protocol (§5) against the JAX reference.

On the CPU, on ``reduced()`` ResNet (3 stages of 1 block, width 8, 16 x
16 images; stages 1 and 2 open with stride-2 convolutions).  The data
(``SyntheticCIFAR``, the partitions, ``FederatedDataset.round_batches``)
is numpy in both packages and equal bit for bit.  The ResNet forward and
loss, and 3 rounds of ``PaperExperiment`` per scheme, start from the
reference's params (converted through numpy); ``static`` and ``full``
draw no random masks, and ``rolling`` and ``random`` get the reference's
masks injected from its ``Trainer`` rng chain (torch cannot reproduce
``jax.random``) by wrapping the experiment's batch iterator.  Tolerance:
float32, atol 1e-5 and rtol 1e-5 on losses, accuracies and the
generalization gap (the two frameworks' convolutions and reductions sum
in different orders, a few ulp each); the bound formulas and the
quadratic problem's numpy constants are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.resnet18_cifar import CONFIG as REF_CONFIG  # noqa: E402
from repro.configs.resnet18_cifar import reduced as ref_reduced  # noqa: E402
from repro.core import paper_protocol as ref_pp  # noqa: E402
from repro.core import stability as ref_stab  # noqa: E402
from repro.core import theory as ref_theory  # noqa: E402
from repro.core.fedavg import dense_client_masks as ref_masks  # noqa: E402
from repro.data import federated as ref_fd  # noqa: E402
from repro.data.synthetic import SyntheticCIFAR as RefCIFAR  # noqa: E402
from repro.launch import experiment as ref_exp  # noqa: E402
from repro.models import resnet as ref_resnet  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.resnet18_cifar import (CAPACITY_BETAS,  # noqa: E402
                                                CONFIG, reduced)
from repro_torch.core import paper_protocol as pp  # noqa: E402
from repro_torch.core import stability as stab  # noqa: E402
from repro_torch.core import theory  # noqa: E402
from repro_torch.data import federated as fd  # noqa: E402
from repro_torch.data.synthetic import SyntheticCIFAR  # noqa: E402
from repro_torch.launch import experiment  # noqa: E402
from repro_torch.models import resnet  # noqa: E402

ATOL = RTOL = 1e-5
ROUNDS = 3
EXP = dict(n_clients=6, participate=3, n_train=240, n_test=48, mb=4)


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


def _ref_params(cfg, shapes_only=False):
    """The reference's params for seed 0 (numpy, built in one jit; or
    only their shapes) and its axis tags."""
    axes = {}

    def build(key):
        params, a = ref_resnet.build_resnet_params(cfg, key)
        axes.update(a)
        return params

    key = jax.random.PRNGKey(0)
    if shapes_only:
        return jax.eval_shape(build, key), axes
    return _np(jax.jit(build)(key)), axes


@pytest.fixture(scope="module")
def ref_params():
    return _ref_params(ref_reduced())


# -- data ----------------------------------------------------------------------


def test_synthetic_cifar_equals_reference():
    a = SyntheticCIFAR(10, 16, 50, 20, seed=3)
    b = RefCIFAR(10, 16, 50, 20, seed=3)
    np.testing.assert_array_equal(a.protos, b.protos)
    for split in ("train", "test"):
        for k in ("images", "labels"):
            got, want = getattr(a, split)[k], getattr(b, split)[k]
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("partition", fd.PARTITIONS)
def test_partitions_and_round_batches_equal_reference(partition):
    data = SyntheticCIFAR(10, 8, 300, 10, seed=1).train
    kw = dict(partition=partition, labels_per_client=2, alpha=0.1, seed=4)
    ours = fd.FederatedDataset.from_labels(data, data["labels"], 12, **kw)
    theirs = ref_fd.FederatedDataset.from_labels(data, data["labels"], 12,
                                                 **kw)
    assert fd.PARTITIONS == ref_fd.PARTITIONS
    for a, b in zip(ours.parts, theirs.parts, strict=True):
        np.testing.assert_array_equal(a, b)
    ia, ib = ours.round_batches(5, 2, 3), theirs.round_batches(5, 2, 3)
    for _ in range(4):       # crosses an epoch of the client permutation
        (ba, ca), (bb, cb) = next(ia), next(ib)
        np.testing.assert_array_equal(ca, cb)
        for k in bb:
            np.testing.assert_array_equal(ba[k], bb[k])
    np.testing.assert_array_equal(ours.sample_clients(4, replace=True),
                                  theirs.sample_clients(4, replace=True))


# -- the model -----------------------------------------------------------------


@pytest.mark.parametrize("cfg", [CONFIG, reduced()], ids=["full", "reduced"])
def test_params_shapes_and_axes_match_reference(cfg):
    ref_cfg = REF_CONFIG if cfg == CONFIG else ref_reduced()
    want, want_axes = _ref_params(ref_cfg, shapes_only=True)
    params, axes = resnet.build_resnet_params(cfg, 0, "meta")
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: v.shape for k, v in convert._flatten(want)}
    assert axes == dict(convert._flatten(want_axes))
    if cfg == CONFIG:   # 1 stem, 8 x 6 block leaves, 3 proj, 2 bn, 2 fc
        assert len(params) == 56
        assert 11.1e6 < sum(v.numel() for v in params.values()) < 11.3e6


def test_same_padding_is_xla_s():
    """XLA's "SAME" pads a stride-2 3x3 convolution 0 before and 1 after
    on an even input; torch's padding=1 would pad both sides."""
    assert resnet._same_pad(32, 3, 2) == (0, 1)
    assert resnet._same_pad(32, 3, 1) == (1, 1)
    assert resnet._same_pad(32, 1, 2) == (0, 0)
    assert resnet._same_pad(15, 3, 2) == (1, 1)


def test_convert_carries_the_resnet_tree_both_ways(ref_params):
    params, _ = ref_params
    flat = convert.from_reference(params, "cpu")
    assert "stage1/block0/proj" in flat and "fc/w" in flat
    back = convert.to_reference(flat)
    for path, v in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(
            dict(jax.tree_util.tree_leaves_with_path(back))[path], v)


@pytest.mark.parametrize("scaler", [None, 2.0])
def test_one_model_forward_and_loss_match_reference(ref_params, scaler):
    cfg = reduced()
    params, _ = ref_params
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, 6).astype(np.int32)
    batch = {"images": x, "labels": y}
    if scaler is not None:
        batch["scaler"] = np.float32(scaler)
    want_logits = ref_resnet.resnet_forward(
        params, ref_reduced(), jnp.asarray(x),
        1.0 if scaler is None else scaler)
    want_loss, want_aux = ref_resnet.resnet_loss(params, ref_reduced(),
                                                 batch)
    tp = convert.from_reference(params, "cpu")
    got_logits = resnet.resnet_forward(tp, cfg, torch.tensor(x), scaler)
    got_loss, got_aux = resnet.resnet_loss(
        tp, cfg, {**{k: torch.as_tensor(v) for k, v in batch.items()},
                  "labels": torch.tensor(y).long()})
    np.testing.assert_allclose(got_logits.numpy(), want_logits, atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(float(got_loss), float(want_loss), atol=ATOL,
                               rtol=RTOL)
    assert float(got_aux["acc"]) == float(want_aux["acc"])


def test_client_form_matches_reference_per_client(ref_params):
    """C clients with their own params, images and scalers: one grouped
    convolution per layer, each client's loss the reference's (vmapped)."""
    cfg, C = reduced(), 3
    params, _ = ref_params
    stacked = jax.tree_util.tree_map(
        lambda v: np.stack([v * (1 + 0.1 * i) for i in range(C)]), params)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((C, 4, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, (C, 4)).astype(np.int32)
    s = np.array([1.0, 2.0, 16.0], np.float32)
    want_loss, want_aux = jax.vmap(lambda p, xx, yy, ss: ref_resnet
                                   .resnet_loss(p, ref_reduced(), {
                                       "images": xx, "labels": yy,
                                       "scaler": ss}))(
        jax.tree_util.tree_map(jnp.asarray, stacked), jnp.asarray(x),
        jnp.asarray(y), jnp.asarray(s))
    got_loss, got_aux = resnet.resnet_loss(
        convert.from_reference(stacked, "cpu", lead=1), cfg,
        {"images": torch.tensor(x), "labels": torch.tensor(y).long(),
         "scaler": torch.tensor(s)})
    assert got_loss.shape == (C,)
    np.testing.assert_allclose(got_loss.numpy(), want_loss, atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_array_equal(got_aux["acc"].numpy(), want_aux["acc"])


# -- PaperExperiment -----------------------------------------------------------


def _inject_reference_masks(exp, ref, params, axes):
    """Wrap ``exp``'s batch iterator so that each round also carries the
    masks the reference's Trainer draws for it (its rng chain: split the
    key each round, ``dense_client_masks`` at the round's capacities)."""
    orig = exp._round_batches
    abstract = jax.tree_util.tree_map(
        lambda v: jax.ShapeDtypeStruct(v.shape, v.dtype), params)

    def wrapped(scheme, uniform_cap):
        scfg = ref.make_fed(scheme, uniform_cap).scfg
        draw = jax.jit(lambda key, caps, r: ref_masks(key, abstract, axes,
                                                      scfg, caps, r))
        key = jax.random.PRNGKey(ref.seed + 1)
        for r, (batch, kw) in enumerate(orig(scheme, uniform_cap)):
            key, sub = jax.random.split(key)
            masks = _np(draw(sub, jnp.asarray(kw["capacities"]), r))
            yield batch, {**kw, "masks": convert.from_reference(
                masks, "cpu", lead=1)}

    exp._round_batches = wrapped


@pytest.fixture(scope="module")
def reference_results():
    # a fresh experiment per scheme: its data stream is stateful
    return {s: ref_pp.PaperExperiment(**EXP).run(s, rounds=ROUNDS,
                                                 eval_every=1)
            for s in pp.SCHEME_MAP}


@pytest.mark.parametrize("scheme", ["static", "full", "rolling", "random"])
def test_paper_experiment_matches_reference(reference_results, ref_params,
                                           scheme):
    ref = ref_pp.PaperExperiment(**EXP)
    exp = pp.PaperExperiment(**EXP, device="cpu")
    np.testing.assert_array_equal(exp.client_caps, ref.client_caps)
    params, axes = ref_params          # the reference's init_params()
    exp.init_params = lambda: (convert.from_reference(params, "cpu"),
                               dict(convert._flatten(axes)))
    if scheme in ("rolling", "random"):
        _inject_reference_masks(exp, ref, params, axes)
    got, want = exp.run(scheme, rounds=ROUNDS, eval_every=1), \
        reference_results[scheme]
    assert len(got["curve"]) == len(want["curve"]) == ROUNDS
    for a, b in zip(got["curve"], want["curve"]):
        assert a["round"] == b["round"]
        for k in ("train_loss", "test_loss", "test_acc"):
            np.testing.assert_allclose(a[k], b[k], atol=ATOL, rtol=RTOL,
                                       err_msg=f"round {a['round']} {k}")
    for k, v in want["gap"].items():
        np.testing.assert_allclose(got["gap"][k], v, atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def test_paper_experiment_runs_every_scheme_on_its_own_draws():
    exp = pp.PaperExperiment(n_clients=6, participate=2, n_train=120,
                             n_test=24, mb=4, device="cpu")
    assert exp.capacities == CAPACITY_BETAS
    for scheme in pp.SCHEME_MAP:
        r = exp.run(scheme, rounds=2, eval_every=2)
        assert np.isfinite(r["final"]["test_loss"]), scheme
        assert "loss_gap" in r["gap"]


# -- stability and theory ------------------------------------------------------


def test_stability_helpers_match_reference():
    data = {"images": np.zeros((10, 4, 4, 3), np.float32),
            "labels": np.arange(10) % 3}
    parts = [np.array([0, 1, 2]), np.array([3, 4])]
    got = stab.perturb_one_sample(parts, data, client=0, index=1)
    want = ref_stab.perturb_one_sample(parts, data, client=0, index=1)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    a, b = {"w": torch.zeros(4), "v": torch.ones(2)}, \
        {"w": torch.ones(4), "v": torch.zeros(2)}
    want = ref_stab.pairwise_distance({k: jnp.asarray(v.numpy())
                                       for k, v in a.items()},
                                      {k: jnp.asarray(v.numpy())
                                       for k, v in b.items()})
    assert stab.pairwise_distance(a, b) == pytest.approx(want, rel=1e-6)


def test_generalization_gap_matches_reference(ref_params):
    params, _ = ref_params
    data = SyntheticCIFAR(10, 16, 8, 8, seed=2)
    want = ref_stab.generalization_gap(
        lambda p, b: ref_resnet.resnet_loss(p, ref_reduced(), b), params,
        data.train, data.test)
    on = {s: {"images": torch.tensor(getattr(data, s)["images"]),
              "labels": torch.tensor(getattr(data, s)["labels"]).long()}
          for s in ("train", "test")}
    got = stab.generalization_gap(
        lambda p, b: resnet.resnet_loss(p, reduced(), b),
        convert.from_reference(params, "cpu"), on["train"], on["test"])
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def test_static_stability_track_matches_reference():
    """The static scheme's masks are deterministic, so the whole twin-run
    estimate is the reference's."""
    want = ref_exp.run_stability(["static"], 2, 0, 1)
    got = experiment.run_stability(["static"], 2, 0, 1, device="cpu")
    np.testing.assert_allclose(got["static"], want["static"], atol=ATOL,
                               rtol=RTOL)


def test_theorem_formulas_equal_reference():
    kw = dict(L=2.0, mu=0.5, G=1.0, W=2.0, d=10, probs=np.full(4, 0.6))
    assert theory.thm1_residual(**kw) == ref_theory.thm1_residual(**kw)
    rate = dict(kw, K=4, R=10, w0_dist=1.0, sigma_star=0.1, delta=0.1, N=4)
    assert theory.thm1_rate(**rate) == ref_theory.thm1_rate(**rate)
    st = dict(eps=0.1, G=1.0, L=2.0, w_norm=1.0, d=10, probs=np.full(4, 0.5))
    assert theory.stationarity_translation(**st) == \
        ref_theory.stationarity_translation(**st)
    t5 = dict(G=1.0, L=2.0, delta=0.1, D_max=0.2, sigma_star=0.1,
              probs=np.full(4, 0.5), N=4, n=100)
    assert theory.thm5_stability(**t5) == ref_theory.thm5_stability(**t5)


def test_quadratic_problem_matches_reference():
    ours = theory.QuadraticProblem.make(3, 32, 8, hetero=0.3, seed=1,
                                        device="cpu")
    theirs = ref_theory.QuadraticProblem.make(3, 32, 8, hetero=0.3, seed=1)
    np.testing.assert_array_equal(ours.A.numpy(), np.asarray(theirs.A))
    np.testing.assert_array_equal(ours.b.numpy(), np.asarray(theirs.b))
    assert ours.constants() == theirs.constants()
    np.testing.assert_array_equal(ours.w_star(), theirs.w_star())
    probs = np.full(3, 0.5)
    np.testing.assert_array_equal(ours.w_star_masked(probs),
                                  theirs.w_star_masked(probs))
    w = np.linspace(-1, 1, 8).astype(np.float32)
    assert ours.global_loss(torch.tensor(w)) == pytest.approx(
        theirs.global_loss(jnp.asarray(w)), rel=1e-6)
    idx = np.array([0, 3, 5])
    got = ours.loss_fn(1)({"w": torch.tensor(w)}, torch.tensor(idx))[0]
    want = theirs.loss_fn(1)({"w": jnp.asarray(w)}, jnp.asarray(idx))[0]
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert ours.axes() == theirs.axes()
    assert ours.params()["w"].shape == (8,)


# -- the CLI -------------------------------------------------------------------


def test_metric_names_equal_reference():
    assert experiment.metric_names() == ref_exp.metric_names()
    for s, p in ((("shuffled",), ("label",)), (("random", "static"),
                                               ("iid", "dirichlet"))):
        assert experiment.metric_names(s, p) == ref_exp.metric_names(s, p)


def test_cli_runs_one_round_on_the_cpu(tmp_path):
    out = tmp_path / "results.json"
    rec = experiment.main(["--rounds", "1", "--device", "cpu", "--out",
                           str(out)])
    assert sorted(rec) == sorted(experiment.metric_names())
    assert rec["stability_finite"] == 1 and rec["thm1_bound_holds"] == 1
    assert out.exists()


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: pp.PaperExperiment(**EXP),
                 lambda: resnet.build_resnet_params(reduced()),
                 lambda: theory.QuadraticProblem.make(2, 4, 3),
                 lambda: experiment.main(["--rounds", "1", "--out",
                                          str(tmp_path / "x.json")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    pp.PaperExperiment(**EXP, device="cpu")
