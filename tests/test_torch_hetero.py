"""Heterogeneous window capacities in the port's window round.

Inside the port, bit for bit on the CPU: a ``fed_round(..., capacities=)``
round equals the bucket-ordered composition of independently built
homogeneous port rounds (the reference's ``_compose_delta_sum`` contract,
``tests/test_hetero.py``), on the extract arm (the reference's MLP triple,
whose loss has no ``window=``) and on the fused arm (a tiny TinyLlama:
2 layers, d_model 64, d_ff 128, 4 / 2 heads of 16), for rolling,
staggered rolling and static windows; and the fused round equals the
extract round.  Uniform capacities keep the plain round, and the
construction errors are the reference's, word for word.

Against the reference (``kernel_backend="jnp"``, its **extract** arm: its
own fused hetero pin fails on jax 0.9, ROADMAP.md §C), from the same
params (through numpy) and batches, with the reference's union offsets
injected (torch cannot reproduce ``jax.random``): 3 rounds of reduced
TinyLlama (2 layers, S = 32, windows on d_ff / heads / kv_heads), plain
and with server ``sgd``, and 3 rounds of the MLP triple with server
``momentum``, within atol 1e-5 and rtol 1e-5 on params and per-client
losses (the frameworks' products sum in other orders, a few ulp each,
carried through 6 local steps; the largest differences seen are 3e-7 and
3e-6).  The tiny TinyLlama is not used here: its vocabulary of 64 makes
it sensitive enough that even the homogeneous round drifts past 1e-5 by
round 3 in both directions.  Server Adam on the MLP triple
each round from the reference's params and state, every param within
``1e-5 + 2 lr dd / (sqrt(v_hat) + eps)`` (``dd`` the mean deltas'
difference, itself within 1e-5: Adam's step is a step function near 0,
ROADMAP.md §C3, as in ``tests/test_torch_server_opt.py``).

The card's twin of this file's round (a reduced hetero round on the card
against the CPU) is in ``tests/test_torch_fleet.py``, which imports no JAX
at collection.
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
from repro_torch.core import submodel as sm  # noqa: E402
from repro_torch.core.masking import capacity_size  # noqa: E402
from repro_torch.core.trainer import _to_device  # noqa: E402
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ATOL = RTOL = 1e-5
ADAM_LR, ADAM_B1, ADAM_B2, ADAM_EPS = 0.1, 0.9, 0.99, 1e-6
D_IN, D_H, C, K, MB = 6, 8, 4, 2, 3
ROUNDS, S = 3, 16
CAPS = (1.0, 0.5, 0.5, 0.25)
TINY = dict(n_layers=2, vocab=64, d_model=64, d_ff=128, n_heads=4,
            n_kv_heads=2, head_dim=16)
AXES = {"w1": ("d_model", "d_ff"), "b1": ("d_ff",), "w2": ("d_ff",)}
LM_AXES = ("d_ff", "heads", "kv_heads")
SCHEMES = {"rolling": {}, "stagger": {"stagger": True},
           "static": {"scheme": "static"}}


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


def _scfg(ref=False, **kw):
    base = dict(scheme="rolling", capacity=0.5, local_steps=K,
                clients_per_round=C, client_lr=0.1)
    base.update(kw)
    return (RefSubmodelConfig if ref else SubmodelConfig)(**base)


# -- the MLP triple: shape-agnostic losses, so every bucket takes the extract
# phase at its own width

def ref_mlp_loss(w, b):
    h = jnp.tanh(b["x"] @ w["w1"] + w["b1"])
    r = h @ w["w2"] - b["y"]
    return 0.5 * jnp.mean(r * r), {}


def port_mlp_loss(w, b):
    """All clients' losses ``[C]``: params and batch leaves ``[C, ...]``."""
    h = torch.tanh(torch.bmm(b["x"], w["w1"]) + w["b1"][:, None])
    r = torch.bmm(h, w["w2"][..., None])[..., 0] - b["y"]
    return 0.5 * (r * r).mean(-1), {}


def _mlp_params():
    rng = np.random.default_rng(1)
    return {"w1": (rng.standard_normal((D_IN, D_H)) * 0.3).astype(np.float32),
            "b1": np.zeros(D_H, np.float32),
            "w2": (rng.standard_normal(D_H) * 0.3).astype(np.float32)}


def _port_mlp():
    return (port_mlp_loss,
            {k: torch.Size(v.shape) for k, v in _mlp_params().items()}, AXES)


def _ref_mlp():
    return (ref_mlp_loss,
            {k: jax.ShapeDtypeStruct(v.shape, jnp.float32)
             for k, v in _mlp_params().items()}, AXES)


def _mlp_batches(n=ROUNDS, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((K, C, MB, D_IN)).astype(np.float32),
             "y": rng.standard_normal((K, C, MB)).astype(np.float32)}
            for _ in range(n)]


def _tiny_port():
    return build_model(dataclasses.replace(
        get_reduced_config("tinyllama_1_1b"), **TINY))


def _batch(b):
    return {k: _to_device(v, "cpu") for k, v in b.items()}


def _bits(t):
    return t.contiguous().view(torch.int32)


def _bit_equal(a, b):
    return set(a) == set(b) and all(torch.equal(_bits(a[k]), _bits(b[k]))
                                    for k in a)


def _compose(model, scfg, buckets, params, batch, round_idx, **fed_kw):
    """The bucket composition: per width class a homogeneous round built
    from scratch (``api.fed_round``, not the hetero round's own clones)
    runs its client phase on its lanes, and its float32 change sum is added
    in descending-beta order; then the per-client arm's update."""
    acc = {k: torch.zeros(v.shape) for k, v in params.items()}
    for b in buckets:
        bscfg = dataclasses.replace(scfg, capacity=b.beta,
                                    clients_per_round=len(b.idx),
                                    shared_window=False)
        kw = dict(fed_kw) if b.beta < 1.0 else {}
        ref = api.fed_round(model, bscfg, device="cpu", **kw)
        bb = {k: v[:, list(b.idx)] for k, v in batch.items()}
        boff = ref._client_offsets(round_idx, params)
        fused = ref.use_fused and bool(boff)
        phase = ref._client_phase_fused if fused else ref._client_phase
        delta, _ = phase(params, bb, boff)
        for k, p in ref._local_delta_sum(delta, boff, fused).items():
            acc[k] += p
    new = {k: (w.float() + scfg.server_lr * acc[k] / C).to(w.dtype)
           for k, w in params.items()}
    return sm.project_l2(new, scfg.proj_radius)


def _clone(p):
    return {k: v.clone() for k, v in p.items()}


# -- the bitwise composition pin and fused == extract, inside the port --------


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_hetero_composes_from_homogeneous_rounds_bitwise(scheme):
    """Extract arm (the MLP triple): the heterogeneous round is the
    per-bucket homogeneous composition, 0 ulp, losses in client order."""
    scfg = _scfg(**SCHEMES[scheme])
    fed = api.fed_round(_port_mlp(), scfg, capacities=CAPS, device="cpu")
    assert [(b.beta, list(b.idx)) for b in fed.hetero] == \
        [(1.0, [0]), (0.5, [1, 2]), (0.25, [3])]
    assert not fed.use_fused and not fed.shared_window
    params = convert.from_reference(_mlp_params(), "cpu")
    batch = _batch(_mlp_batches(1)[0])
    want = _compose(_port_mlp(), scfg, fed.hetero, params, batch, 0)
    new, info = fed.round(_clone(params), batch, 0)
    assert _bit_equal(new, want)
    assert info["client_loss"].shape == (K, C)
    assert torch.isfinite(info["client_loss"]).all()
    # each lane's loss is its own client's: the first step's loss on the
    # full-width client equals the full model's on its data
    full_loss, _ = port_mlp_loss({k: v[None] for k, v in params.items()},
                                 {k: v[0, :1] for k, v in batch.items()})
    assert torch.equal(info["client_loss"][0, 0], full_loss[0])


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_hetero_fused_arm_composes_bitwise(scheme):
    """Fused arm (tiny TinyLlama, the window-aware forward): the same pin,
    the full-width bucket on the extract phase's full replica."""
    model = _tiny_port()
    scfg = _scfg(client_lr=0.05, **SCHEMES[scheme])
    fed = api.fed_round(model, scfg, capacities=CAPS, device="cpu")
    assert [b.fed.use_fused for b in fed.hetero] == [False, True, True]
    params = model.init(0, device="cpu")
    batch = _batch(next(lm_batches(64, (K, C, 2), S, seed=0)))
    want = _compose(model, scfg, fed.hetero, params, batch, 0)
    new, _ = fed.round(_clone(params), batch, 0)
    assert _bit_equal(new, want)


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_hetero_fused_equals_extract_bitwise(scheme):
    """Per bucket the port's fused phase equals its extract phase to the
    bit, so the bucket loop keeps it on a heterogeneous cohort (with a
    full-width bucket): 3 rounds, losses and every param."""
    model = _tiny_port()
    it = lm_batches(64, (K, C, 2), S, seed=0)
    batches = [next(it) for _ in range(ROUNDS)]
    out = {}
    for ff in ("on", "off"):
        fed = api.fed_round(model, _scfg(client_lr=0.05, **SCHEMES[scheme]),
                            capacities=CAPS, fused_forward=ff, device="cpu")
        assert [b.fed.use_fused for b in fed.hetero] == \
            [False, ff == "on", ff == "on"]
        trainer = api.Trainer(fed, model.init(0, device="cpu"))
        trainer.run(iter(batches), ROUNDS)
        out[ff] = trainer
    if scheme == "stagger":
        d_ff = fed._client_offsets(1)[("d_ff", 128)]
        assert d_ff[1] != d_ff[2], d_ff      # the half-width pair differs
    for a, b in zip(out["on"].history, out["off"].history):
        assert torch.equal(_bits(a["client_loss"]), _bits(b["client_loss"]))
    assert _bit_equal(out["on"].params, out["off"].params)


def test_hetero_server_opt_round_composes_bitwise():
    """The server-optimizer arm: the composed change sum over C through
    ``server_opt.update``, 0 ulp."""
    scfg = _scfg()
    fed = api.fed_round(_port_mlp(), scfg, server_opt="adam",
                        capacities=CAPS, device="cpu")
    params = convert.from_reference(_mlp_params(), "cpu")
    batch = _batch(_mlp_batches(1)[0])
    opt = fed.server_opt
    new, st, info = fed.round_with_server_opt(_clone(params),
                                              opt.init(params), batch, 0)
    acc = {k: torch.zeros(v.shape) for k, v in params.items()}
    for b in fed.hetero:
        bscfg = dataclasses.replace(scfg, capacity=b.beta,
                                    clients_per_round=len(b.idx),
                                    shared_window=False)
        ref = api.fed_round(_port_mlp(), bscfg, device="cpu")
        boff = ref._client_offsets(0)
        delta, _ = ref._client_phase(
            params, {k: v[:, list(b.idx)] for k, v in batch.items()}, boff)
        for k, p in ref._local_delta_sum(delta, boff, False).items():
            acc[k] += p
    want, _ = opt.update(_clone(params), {k: a / C for k, a in acc.items()},
                         opt.init(params))
    assert _bit_equal(new, sm.project_l2(want, scfg.proj_radius))
    assert st["t"] == 1 and info["client_loss"].shape == (K, C)


# -- the degenerate case, widths, offsets and the errors ----------------------


def test_uniform_capacities_keep_the_plain_round():
    """Capacities all at ``scfg.capacity``: no buckets, the shared window
    kept, and the round is the no-capacities round bit for bit."""
    model = _tiny_port()
    fed_u = api.fed_round(model, _scfg(), capacities=[0.5] * C, device="cpu")
    fed_p = api.fed_round(model, _scfg(), device="cpu")
    assert fed_u.hetero is None and fed_u.capacities == (0.5,) * C
    assert fed_u.shared_window and fed_u.use_fused
    batch = _batch(next(lm_batches(64, (K, C, 2), S, seed=0)))
    p_u, _ = fed_u.round(model.init(0, device="cpu"), batch, 0)
    p_p, _ = fed_p.round(model.init(0, device="cpu"), batch, 0)
    assert _bit_equal(p_u, p_p)


def test_bucket_widths_and_union_offsets():
    """Bucket windows come from ``capacity_size`` (beta = 1.0 windows
    nothing); the union offsets hold each lane's bucket draw, 0 where its
    bucket windows nothing, and injected union offsets are checked lane by
    lane against the lane's own bucket."""
    fed = api.fed_round(_port_mlp(), _scfg(stagger=True), capacities=CAPS,
                        device="cpu")
    key = ("d_ff", D_H)
    for b in fed.hetero:
        want = {} if b.beta == 1.0 else {key: capacity_size(b.beta, D_H, 1)}
        assert b.fed.scheme.sizes == want
    for r in range(4):
        union = fed._client_offsets(r)
        assert union[key][0] == 0
        for b in fed.hetero[1:]:
            assert [union[key][i] for i in b.idx] == \
                b.fed._client_offsets(r)[key]
    assert fed._check_offsets({key: [0, 4, 0, 6]}) == {key: [0, 4, 0, 6]}
    for bad in ([1, 4, 0, 6],      # the full-width lane must stay 0
                [0, 5, 0, 6],      # 5 + 4 > 8 on a half-width lane
                [0, 4, 0, 7],      # 7 + 2 > 8 on the quarter-width lane
                [0, 4, 0]):
        with pytest.raises(ValueError, match="in-range window starts"):
            fed._check_offsets({key: bad})


def _errors(make):
    try:
        make()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("case", ["length", "zero", "above_one", "full",
                                  "shared_window"])
def test_hetero_errors_are_the_reference_s(case):
    caps, over = {"length": ([0.5, 0.5], {}),
                  "zero": ([1.0, 0.5, 0.5, 0.0], {}),
                  "above_one": ([1.0, 0.5, 0.5, 1.5], {}),
                  "full": (CAPS, {"scheme": "full"}),
                  "shared_window": (CAPS, {"shared_window": True})}[case]
    want = _errors(lambda: ref_api.fed_round(
        _ref_mlp(), _scfg(ref=True, **over), capacities=caps))
    got = _errors(lambda: api.fed_round(_port_mlp(), _scfg(**over),
                                        capacities=caps, device="cpu"))
    assert got == want


def test_capacities_with_a_mesh_raise_the_reference_s_error():
    """The round object refuses the pair, in both packages (``fed_round``
    checks a mesh's axes first, which ``object()`` lacks; tests/
    test_torch_mesh.py goes through ``fed_round`` with a mesh)."""
    fed = ref_api.fed_round(_ref_mlp(), _scfg(ref=True))
    want = _errors(lambda: dataclasses.replace(fed, mesh=object(),
                                               capacities=CAPS))
    ours = api.fed_round(_port_mlp(), _scfg(), device="cpu")
    got = _errors(lambda: dataclasses.replace(ours, mesh=object(),
                                              capacities=CAPS))
    assert got == want


# -- against the reference's extract arm --------------------------------------


def _host(tree):
    return {k: [int(o) for o in np.asarray(v)] for k, v in tree.items()}


@pytest.fixture(scope="module")
def reduced_reference():
    """3 reference rounds of reduced TinyLlama (extract arm), plain and
    with server sgd, with the union offsets each round took."""
    model = ref_build(ref_reduced("tinyllama_1_1b"), remat=False)
    params0 = jax.tree_util.tree_map(np.asarray,
                                     model.init(jax.random.PRNGKey(0)))
    it = ref_lm_batches(model.cfg.vocab, (K, C, 2), 2 * S, seed=0)
    batches = [next(it) for _ in range(ROUNDS)]
    runs = {}
    for so in ("none", "sgd"):
        fed = ref_api.fed_round(model, _scfg(ref=True, axes=LM_AXES),
                                kernel_backend="jnp", fused_forward="off",
                                capacities=CAPS, server_opt=so)
        assert [b.fed.use_fused for b in fed.hetero] == [False] * 3
        trainer = ref_api.Trainer(fed, jax.tree_util.tree_map(
            jnp.asarray, params0), rng=1)
        offsets = []
        for b in batches:
            offsets.append(_host(fed._client_offsets(
                trainer.params, trainer.round_idx, None)))
            trainer.run(iter([{k: jnp.asarray(v) for k, v in b.items()}]), 1)
        runs[so] = dict(params=jax.tree_util.tree_map(np.asarray,
                                                      trainer.params),
                        offsets=offsets,
                        client_loss=[np.asarray(h["client_loss"])
                                     for h in trainer.history])
    return dict(params0=params0, batches=batches, runs=runs)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _close(trainer, run, what):
    for r, h in enumerate(trainer.history):
        np.testing.assert_allclose(h["client_loss"].numpy(),
                                   run["client_loss"][r], atol=ATOL,
                                   rtol=RTOL, err_msg=f"{what} round {r}")
    got = _leaves(convert.to_reference(trainer.params))
    for path, want in _leaves(run["params"]).items():
        np.testing.assert_allclose(got[path], want, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("so,ff", [("none", "on"), ("none", "off"),
                                   ("sgd", "on")],
                         ids=["plain_fused", "plain_extract", "server_sgd"])
def test_three_hetero_rounds_match_reference_extract_arm(reduced_reference,
                                                         so, ff):
    """The port's hetero rounds (fused or extract buckets) with the
    reference's union offsets injected, against the reference's extract
    arm."""
    ref = reduced_reference
    run = ref["runs"][so]
    fed = api.fed_round(build_model(get_reduced_config("tinyllama_1_1b")),
                        _scfg(axes=LM_AXES), capacities=CAPS,
                        fused_forward=ff, server_opt=so, device="cpu")
    assert [b.fed.use_fused for b in fed.hetero] == [False] + [ff == "on"] * 2
    trainer = api.Trainer(fed, convert.from_reference(ref["params0"], "cpu"))
    trainer.run(((b, {"offsets": o}) for b, o in
                 zip(ref["batches"], run["offsets"])), ROUNDS)
    _close(trainer, run, f"{so}/{ff}")


@pytest.fixture(scope="module")
def mlp_reference():
    """3 reference rounds of the MLP triple with server momentum and with
    server Adam, one at a time, with the params and state before each."""
    batches = _mlp_batches()
    runs = {}
    for so in ("momentum", "adam"):
        fed = ref_api.fed_round(_ref_mlp(), _scfg(ref=True, stagger=True),
                                kernel_backend="jnp", capacities=CAPS,
                                server_opt=so)
        trainer = ref_api.Trainer(fed, {k: jnp.asarray(v) for k, v in
                                        _mlp_params().items()}, rng=1)
        offsets, before = [], []
        for b in batches:
            offsets.append(_host(fed._client_offsets(
                trainer.params, trainer.round_idx, None)))
            before.append(jax.tree_util.tree_map(
                np.asarray, (trainer.params, trainer.opt_state)))
            trainer.run(iter([{k: jnp.asarray(v) for k, v in b.items()}]), 1)
        before.append(jax.tree_util.tree_map(
            np.asarray, (trainer.params, trainer.opt_state)))
        runs[so] = dict(offsets=offsets, before=before,
                        params=before[-1][0],
                        client_loss=[np.asarray(h["client_loss"])
                                     for h in trainer.history])
    return dict(batches=batches, runs=runs)


def test_hetero_server_momentum_matches_reference(mlp_reference):
    run = mlp_reference["runs"]["momentum"]
    fed = api.fed_round(_port_mlp(), _scfg(stagger=True), capacities=CAPS,
                        server_opt="momentum", device="cpu")
    trainer = api.Trainer(fed, convert.from_reference(_mlp_params(), "cpu"))
    trainer.run(((b, {"offsets": o}) for b, o in
                 zip(mlp_reference["batches"], run["offsets"])), ROUNDS)
    _close(trainer, run, "momentum")


def test_hetero_server_adam_each_round_within_its_bound(mlp_reference):
    """Each hetero Adam round from the reference's params and state: the
    mean delta (read back from the first moment) within 1e-5, every param
    within ``1e-5 + 2 lr dd / (sqrt(v_hat) + eps)``."""
    run = mlp_reference["runs"]["adam"]
    fed = api.fed_round(_port_mlp(), _scfg(stagger=True), capacities=CAPS,
                        server_opt="adam", device="cpu")
    for r in range(ROUNDS):
        (p0, s0), (p1, s1) = run["before"][r], run["before"][r + 1]
        state = {"m": convert.from_reference(s0["m"], "cpu"),
                 "v": convert.from_reference(s0["v"], "cpu"),
                 "t": int(s0["t"])}
        params, state, metrics = fed.round_with_server_opt(
            convert.from_reference(p0, "cpu"), state,
            _batch(mlp_reference["batches"][r]), r,
            offsets=run["offsets"][r])
        np.testing.assert_allclose(metrics["client_loss"].numpy(),
                                   run["client_loss"][r], atol=ATOL,
                                   rtol=RTOL)
        for k, got in params.items():
            dd = np.abs((state["m"][k].numpy() - s1["m"][k]) / (1 - ADAM_B1))
            assert dd.max() <= ATOL, (r, k, float(dd.max()))
            v_hat = s1["v"][k] / (1 - ADAM_B2 ** (r + 1))
            bound = ATOL + 2 * ADAM_LR * dd / (np.sqrt(v_hat) + ADAM_EPS)
            assert (np.abs(got.numpy() - p1[k]) <= bound).all(), (r, k)
