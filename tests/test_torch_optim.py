"""The port's client and server optimizers and the bf16 uplink against the
JAX reference.

Reduced TinyLlama (2 layers), S = 32, C = 4, K = 2, on the CPU, from the
same params (converted through numpy) and tokens; the reference runs
``kernel_backend="jnp"``, with its rolling offsets and Bernoulli masks
injected into the port (torch cannot reproduce ``jax.random``).

Tolerances, float32 throughout:

* Rounds (client SGD, momentum and proximal; the exact uplink): atol 1e-5
  and rtol 1e-5 on params and per-client losses, as
  ``tests/test_torch_round.py``: the frameworks' matmuls sum in different
  orders and XLA fuses ``beta * v + g`` and ``p - lr * g`` into one FMA
  where the port rounds twice; 6 steps at lr 0.1 carry a few ulp into the
  weights.
* One optimizer update alone on identical inputs: atol 1e-6 (a few ulp).
* The bf16 uplink: one bfloat16 ulp of the clients' changes on top of
  1e-5, derived in ``test_bf16_uplink_matches_reference_fused_arm``.

The server optimizers' rounds are in ``tests/test_torch_server_opt.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as ref_api  # noqa: E402
from repro.configs.base import SubmodelConfig as RefSubmodelConfig  # noqa
from repro.configs.base import get_reduced_config as ref_reduced  # noqa: E402
from repro.core import server_opt as ref_server_opt  # noqa: E402
from repro.core.fedavg import dense_client_masks as ref_masks  # noqa: E402
from repro.data.synthetic import lm_batches as ref_lm_batches  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.optim import client as ref_client  # noqa: E402
from repro.optim import optimizers as ref_optimizers  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch.configs.base import (SubmodelConfig,  # noqa: E402
                                      get_reduced_config)
from repro_torch.core import server_opt  # noqa: E402
from repro_torch.core.trainer import _to_device  # noqa: E402
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import client, optimizers  # noqa: E402

ATOL = RTOL = 1e-5
ALONE_ATOL = 1e-6
ROUNDS, S, C = 3, 32, 4
SCFG = dict(scheme="rolling", capacity=0.5, local_steps=2,
            clients_per_round=C, client_lr=0.1,
            axes=("d_ff", "heads", "kv_heads"))
# name -> (mode, SubmodelConfig overrides, fed_round keywords); the
# reference's window rounds run its fused arm unless fused_forward says so
CASES = {
    "client_momentum_window": ("window", {}, dict(client_opt="momentum")),
    "client_proximal_window": ("window", {}, dict(client_opt="proximal")),
    "client_momentum_mask": ("mask", dict(scheme="bernoulli"),
                             dict(client_opt="momentum")),
    "client_proximal_mask": ("mask", dict(scheme="bernoulli"),
                             dict(client_opt="proximal")),
    "uplink_shared": ("window", {}, dict(uplink_compression="bf16")),
    "uplink_stagger": ("window", dict(stagger=True),
                       dict(uplink_compression="bf16")),
    "uplink_extract": ("window", {}, dict(uplink_compression="bf16",
                                          fused_forward="off")),
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


@pytest.fixture(scope="module")
def ref_model():
    return ref_build(ref_reduced("tinyllama_1_1b"), remat=False)


@pytest.fixture(scope="module")
def port_model():
    return build_model(get_reduced_config("tinyllama_1_1b"))


def _scfg(over, ref=False):
    return (RefSubmodelConfig if ref else SubmodelConfig)(**{**SCFG, **over})


@pytest.fixture(scope="module")
def reference_runs(ref_model):
    """Three reference rounds per case of ``CASES``, one at a time through
    its Trainer (``rng=1``), with the params before and after each round
    and the offsets or masks each round took."""
    model = ref_model
    params0 = _np(model.init(jax.random.PRNGKey(0)))
    it = ref_lm_batches(model.cfg.vocab, (2, C, 2), S, seed=0)
    batches = [next(it) for _ in range(ROUNDS)]
    runs = {}
    for name, (mode, over, kw) in CASES.items():
        scfg = _scfg(over, ref=True)
        fed = ref_api.fed_round(model, scfg, mode=mode, kernel_backend="jnp",
                                **kw)
        trainer = ref_api.Trainer(fed, jax.tree_util.tree_map(
            jnp.asarray, params0), rng=1)
        key, injected = jax.random.PRNGKey(1), []
        for r in range(ROUNDS):
            key, sub = jax.random.split(key)   # the Trainer's own split
            if mode == "mask":
                injected.append({"masks": _np(ref_masks(
                    sub, model.abstract_params(), model.axes(), scfg,
                    fed.capacities, r))})
            else:
                injected.append({"offsets": {
                    k: [int(o) for o in np.asarray(v)] for k, v in
                    fed.scheme.offsets(None, r, C).items()}})
        before = []
        for b in batches:
            before.append(_np(trainer.params))
            trainer.run(iter([{k: jnp.asarray(v) for k, v in b.items()}]), 1)
        runs[name] = dict(params=_np(trainer.params), injected=injected,
                          before=before + [_np(trainer.params)],
                          client_loss=[np.asarray(h["client_loss"])
                                       for h in trainer.history])
    return dict(params0=params0, batches=batches, runs=runs)


def _port_trainer(port_model, ref, name):
    mode, over, kw = CASES[name]
    fed = api.fed_round(port_model, _scfg(over), mode=mode, device="cpu",
                        **kw)
    trainer = api.Trainer(fed, convert.from_reference(ref["params0"], "cpu"))
    items = []
    for b, inj in zip(ref["batches"], ref["runs"][name]["injected"]):
        if "masks" in inj:
            inj = {"masks": convert.from_reference(inj["masks"], "cpu",
                                                   lead=1)}
        items.append((b, inj))
    trainer.run(iter(items), ROUNDS)
    return fed, trainer


def _hold(trainer, run, atol=ATOL, rtol=RTOL, loss_atol=ATOL, what=""):
    for r, h in enumerate(trainer.history):
        np.testing.assert_allclose(h["client_loss"].numpy(),
                                   run["client_loss"][r], atol=loss_atol,
                                   rtol=RTOL, err_msg=f"{what} round {r}")
    got = _leaves(convert.to_reference(trainer.params))
    for path, want in _leaves(run["params"]).items():
        np.testing.assert_allclose(got[path], want, atol=atol, rtol=rtol,
                                   err_msg=f"{what} {path}")
    return got


# -- (a) client optimizers ----------------------------------------------------


@pytest.mark.parametrize("name", ["client_momentum_window",
                                  "client_proximal_window",
                                  "client_momentum_mask",
                                  "client_proximal_mask"])
def test_client_optimizer_rounds_match_reference(reference_runs, port_model,
                                                 name):
    fed, trainer = _port_trainer(port_model, reference_runs, name)
    assert fed.client_opt.name == CASES[name][2]["client_opt"]
    _hold(trainer, reference_runs["runs"][name], what=name)


def test_client_optimizer_steps_match_reference_alone():
    """One momentum and one proximal update on identical ``[C, ...]``
    params, grads and state, unmasked and masked, against the reference's
    ``ClientOpt.update``."""
    rng = np.random.default_rng(3)
    w0, w, g, v = (rng.standard_normal((C, 6, 5)).astype(np.float32)
                   for _ in range(4))
    m = (rng.random((C, 6, 5)) < 0.5).astype(np.float32)
    for name in ("momentum", "proximal"):
        for masks in (None, m):
            ref = ref_client.CLIENT_OPTS[name]()
            mine = client.CLIENT_OPTS[name]()
            rstate = ref.init({"w": jnp.asarray(w0)})
            state = mine.init({"w": torch.from_numpy(w0.copy())})
            if name == "momentum":
                rstate, state = {"w": jnp.asarray(v)}, {
                    "w": torch.from_numpy(v.copy())}
            kw = {} if masks is None else {"masks": {"w": jnp.asarray(m)}}
            want, _ = ref.update({"w": jnp.asarray(w)}, {"w": jnp.asarray(g)},
                                 rstate, 0.1, backend="jnp", **kw)
            got, _ = mine.update(
                {"w": torch.from_numpy(w.copy())}, {"w": torch.from_numpy(g)},
                state, 0.1, masks=None if masks is None else {
                    "w": torch.from_numpy(m)})
            np.testing.assert_allclose(got["w"].numpy(), want["w"],
                                       atol=ALONE_ATOL, err_msg=name)


# -- (b) server optimizers ----------------------------------------------------


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_server_optimizers_alone_match_reference(name):
    """Three steps of each server optimizer on identical params and deltas
    (deltas around eps included), state carried, at 1e-6."""
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 9), "b": (11,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    deltas = [{k: (rng.standard_normal(s)
                   * 10.0 ** rng.integers(-8, 0, s)).astype(np.float32)
               for k, s in shapes.items()} for _ in range(3)]
    kw = {} if name == "adam" else dict(lr=0.7)
    ref, mine = ref_server_opt.SERVER_OPTS[name](**kw), \
        server_opt.SERVER_OPTS[name](**kw)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    rs = ref.init(rp)
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = mine.init(p)
    for d in deltas:
        rp, rs = ref.update(rp, {k: jnp.asarray(v) for k, v in d.items()}, rs)
        p, st = mine.update(p, {k: torch.from_numpy(v) for k, v in d.items()},
                            st)
        for k in params:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(rp[k]),
                                       atol=ALONE_ATOL, err_msg=f"{name} {k}")
    if name == "adam":
        assert st["t"] == 3 and int(rs["t"]) == 3
        for k in params:
            np.testing.assert_allclose(st["m"][k].numpy(),
                                       np.asarray(rs["m"][k]), atol=1e-7)
            np.testing.assert_allclose(st["v"][k].numpy(),
                                       np.asarray(rs["v"][k]), rtol=1e-6)


# -- (c) the uplink -----------------------------------------------------------


@pytest.mark.parametrize("name", ["uplink_shared", "uplink_stagger"])
def test_bf16_uplink_matches_reference_fused_arm(reference_runs, port_model,
                                                 name):
    """The bf16 uplink in the shared-window and the per-client fused arms.
    Rounding to bfloat16 is a step function: where a client's float32
    change lies within the frameworks' few-ulp difference of a rounding
    midpoint, the two round it to neighbouring bfloat16 values, one
    bfloat16 ulp (at most ``2^-7 |d_c|``) apart.  So each round, from the
    reference's params before it, holds every param within ``1e-5 +
    server_lr * 2^-7 * max_c |d_c|``, with the clients' changes ``d_c``
    from the port's client phase on the same params, and its client losses
    within 1e-5; three chained rounds (``Trainer``) hold every param
    within the sum of the rounds' largest such bounds."""
    ref, run = reference_runs, reference_runs["runs"][name]
    mode, over, kw = CASES[name]
    fed = api.fed_round(port_model, _scfg(over), mode=mode, device="cpu",
                        **kw)
    assert fed.use_fused and fed.uplink_compression == "bf16"
    total = 0.0
    for r in range(ROUNDS):
        params = convert.from_reference(run["before"][r], "cpu")
        batch = {k: _to_device(v, fed.device)
                 for k, v in ref["batches"][r].items()}
        offsets = run["injected"][r]["offsets"]
        full_k, _ = fed._client_phase_fused(params, batch, offsets)
        bound = {k: ATOL + fed.scfg.server_lr * 2.0 ** -7
                 * (full_k[k] - params[k][None]).abs().amax(0)
                 for k in params}
        del full_k
        _, metrics = fed.round(params, batch, r, offsets=offsets)
        np.testing.assert_allclose(metrics["client_loss"].numpy(),
                                   run["client_loss"][r], atol=ATOL,
                                   rtol=RTOL, err_msg=f"{name} round {r}")
        got = _leaves(convert.to_reference(params))
        bound = _leaves(convert.to_reference(bound))
        for path, want in _leaves(run["before"][r + 1]).items():
            over_bound = np.abs(got[path] - want) - bound[path]
            assert over_bound.max() <= 0, (name, r, path, over_bound.max())
        total += max(float(b.max()) for b in bound.values())
    fed, trainer = _port_trainer(port_model, ref, name)
    got = _leaves(convert.to_reference(trainer.params))
    worst = max(float(np.abs(got[p] - w).max())
                for p, w in _leaves(run["params"]).items())
    assert worst <= total, (name, worst, total)
    np.testing.assert_allclose(trainer.history[0]["client_loss"].numpy(),
                               run["client_loss"][0], atol=ATOL, rtol=RTOL)
    assert all(np.isfinite(trainer.losses))


def test_bf16_uplink_is_a_no_op_in_the_extract_arms(reference_runs,
                                                    port_model):
    """The reference applies the uplink only in its fused arms (a caveat
    the port keeps): under ``fused_forward="off"`` a bf16 uplink round is
    the exact-uplink round, bit for bit inside the port and within the
    tolerance against the reference's extract arm with the uplink set."""
    ref = reference_runs
    out = {}
    for kw in ({}, dict(uplink_compression="bf16")):
        fed = api.fed_round(port_model, _scfg({}), fused_forward="off",
                            device="cpu", **kw)
        trainer = api.Trainer(fed, convert.from_reference(ref["params0"],
                                                          "cpu"))
        trainer.run(((b, i) for b, i in zip(
            ref["batches"], ref["runs"]["uplink_extract"]["injected"])),
                    ROUNDS)
        out[bool(kw)] = trainer
    for k in out[True].params:
        assert torch.equal(out[True].params[k], out[False].params[k]), k
    _hold(out[True], ref["runs"]["uplink_extract"], what="uplink_extract")
    # and the uplink does move the fused round
    fused = ref["runs"]["uplink_shared"]["params"]
    extract = ref["runs"]["uplink_extract"]["params"]
    assert any(not np.array_equal(a, b) for a, b in zip(
        _leaves(fused).values(), _leaves(extract).values()))


def test_uplink_rounds_each_change_once_to_bf16(port_model):
    fed = api.fed_round(port_model, _scfg({}), device="cpu",
                        uplink_compression="bf16")
    d = torch.tensor([1.0 + 2 ** -10, 3.0, -1e-3])
    assert torch.equal(fed._uplink(d), d.to(torch.bfloat16).float())
    exact = api.fed_round(port_model, _scfg({}), device="cpu")
    assert exact._uplink(d) is d
    with pytest.raises(ValueError, match="uplink_compression"):
        api.fed_round(port_model, _scfg({}), device="cpu",
                      uplink_compression="int8")


# -- (d) the plain optimizers -------------------------------------------------


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
def test_plain_optimizers_match_reference(name):
    """``optim/optimizers.py`` against ``repro.optim.optimizers``: five
    steps on identical params and grads, a schedule as the lr for sgd;
    and each descends a quadratic, as ``tests/test_substrate.py`` holds
    the reference's."""
    lr = (ref_optimizers.cosine_schedule(0.1, 2, 10), optimizers
          .cosine_schedule(0.1, 2, 10)) if name == "sgd" else (0.05, 0.05)
    ref = getattr(ref_optimizers, name)(lr[0])
    mine = getattr(optimizers, name)(lr[1])
    rng = np.random.default_rng(9)
    w = {"w": rng.standard_normal((5, 3)).astype(np.float32)}
    rp, rs = {"w": jnp.asarray(w["w"])}, None
    p = {"w": torch.from_numpy(w["w"].copy())}
    rs, st = ref.init(rp), mine.init(p)
    for step in range(5):
        g = rng.standard_normal((5, 3)).astype(np.float32)
        rp, rs = ref.update({"w": jnp.asarray(g)}, rs, rp, step)
        p, st = mine.update({"w": torch.from_numpy(g)}, st, p, step)
        np.testing.assert_allclose(p["w"].numpy(), np.asarray(rp["w"]),
                                   atol=ALONE_ATOL, err_msg=f"{name} {step}")
    q = {"w": torch.tensor([3.0, -2.0])}
    opt = getattr(optimizers, name)(0.1 if name == "sgd" else 0.05)
    st = opt.init(q)
    for _ in range(60):
        q, st = opt.update({"w": 2 * q["w"]}, st, q)
    assert float((q["w"] ** 2).sum()) < 0.05


def test_cosine_schedule_and_theory_eta_match_reference():
    ref = ref_optimizers.cosine_schedule(1.0, warmup=10, total=100)
    mine = optimizers.cosine_schedule(1.0, warmup=10, total=100)
    for t in (0, 3, 10, 55, 100, 130):
        np.testing.assert_allclose(float(mine(t)), float(ref(t)), atol=1e-7)
    assert float(mine(0)) == 0.0 and float(mine(100)) < 1e-6
    for args in ((0.5, 2, 30), (1.0, 1, 1)):
        assert optimizers.theory_eta(*args) == \
            ref_optimizers.theory_eta(*args)


# -- (e) the registries -------------------------------------------------------


def test_registries_match_and_refuse_unknown_names(ref_model, port_model):
    assert sorted(client.CLIENT_OPTS) == sorted(ref_client.CLIENT_OPTS)
    assert sorted(server_opt.SERVER_OPTS) == \
        sorted(ref_server_opt.SERVER_OPTS)
    for name in client.CLIENT_OPTS:
        assert client.resolve_client_opt(name).name == name
    assert client.resolve_client_opt(None).name == "sgd"
    with pytest.raises(ValueError, match="unknown client optimizer"):
        ref_client.resolve_client_opt("adamw")
    with pytest.raises(ValueError, match="unknown client optimizer"):
        client.resolve_client_opt("adamw")
    for mode in ("window", "mask"):
        scheme = {"mask": dict(scheme="bernoulli")}.get(mode, {})
        with pytest.raises(ValueError, match="unknown server optimizer"):
            ref_api.fed_round(ref_model, _scfg(scheme, ref=True), mode=mode,
                              server_opt="lamb")
        with pytest.raises(ValueError, match="unknown server optimizer"):
            api.fed_round(port_model, _scfg(scheme), mode=mode,
                          server_opt="lamb", device="cpu")
        for none in (None, "none", ""):
            assert api.fed_round(port_model, _scfg(scheme), mode=mode,
                                 server_opt=none,
                                 device="cpu").server_opt is None
    fed = api.fed_round(port_model, _scfg({}), device="cpu")
    with pytest.raises(ValueError, match="no server optimizer"):
        fed.round_with_server_opt({}, None, {}, 0)
