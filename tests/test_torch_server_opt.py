"""The port's server-optimizer rounds (``round_with_server_opt``, stepped by
``Trainer``) against the JAX reference.

Reduced TinyLlama (2 layers), S = 32, C = 4, K = 2, on the CPU, from the
same params (converted through numpy) and tokens; the reference runs
``kernel_backend="jnp"`` through its ``Trainer`` (``rng=1``), with its
rolling offsets and Bernoulli masks injected into the port (torch cannot
reproduce ``jax.random``).  Window mode through the shared-window and the
per-client fused arms and the per-client extract arm; mask mode with
client momentum.

Tolerances, float32 throughout:

* Server ``sgd`` and ``momentum``: atol 1e-5 and rtol 1e-5 on params and
  per-client losses, as ``tests/test_torch_round.py`` (the frameworks'
  matmuls sum in different orders, a few ulp each).
* Server Adam (``lr = 0.1, b1 = 0.9, b2 = 0.99, eps = 1e-6``, the
  reference's defaults).  Its step ``lr * m_hat / (sqrt(v_hat) + eps)``
  turns a difference ``dd`` in a coordinate's mean delta into a step
  difference of at most ``2 lr dd / (sqrt(v_hat) + eps)`` for ``t <= 3``
  (``v_hat`` the bias-corrected second moment after the step): up to ``lr
  / eps = 1e5`` times ``dd`` where the coordinate has seen only deltas
  near 0.  The mean deltas themselves agree across frameworks to the SGD
  paths' 1e-5 (the server ``sgd`` round adds them to the params); near 0
  they are differences of larger gradient terms, so their relative
  difference there can be large.  Each Adam round, from the reference's
  params and state before it, is held so: the mean delta (read back from
  the first moment, ``d = (m_t - b1 m_{t-1}) / (1 - b1)``, in both
  packages) within 1e-5, and every param within ``1e-5 + 2 lr dd /
  (sqrt(v_hat) + eps)`` with the measured ``dd``.  Chained, the
  differences grow: Adam moves every coordinate by up to about ``lr`` a
  round whatever its delta's size, so a difference in one round's params
  becomes one of up to ``2 lr`` in the next round's steps; three chained
  rounds are held at the first round's largest difference plus ``2 lr r``
  after round ``r``, and the first round's client losses (no server step
  before them) at 1e-5.
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
from repro.data.synthetic import lm_batches as ref_lm_batches  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch.configs.base import (SubmodelConfig,  # noqa: E402
                                      get_reduced_config)
from repro_torch.core import server_opt  # noqa: E402
from repro_torch.core.trainer import _to_device  # noqa: E402
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ATOL = RTOL = 1e-5
ADAM_LR, ADAM_B1, ADAM_B2, ADAM_EPS = 0.1, 0.9, 0.99, 1e-6
ROUNDS, S, C = 3, 32, 4
SCFG = dict(scheme="rolling", capacity=0.5, local_steps=2,
            clients_per_round=C, client_lr=0.1,
            axes=("d_ff", "heads", "kv_heads"))
# name -> (mode, SubmodelConfig overrides, fed_round keywords)
CASES = {
    "sgd": ("window", {}, dict(server_opt="sgd")),
    "momentum_stagger": ("window", dict(stagger=True),
                         dict(server_opt="momentum")),
    "sgd_stagger_extract": ("window", dict(stagger=True),
                            dict(server_opt="sgd", fused_forward="off")),
    "adam": ("window", {}, dict(server_opt="adam")),
    "adam_mask": ("mask", dict(scheme="bernoulli"),
                  dict(client_opt="momentum", server_opt="adam")),
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


def _scfg(over, ref=False):
    return (RefSubmodelConfig if ref else SubmodelConfig)(**{**SCFG, **over})


@pytest.fixture(scope="module")
def ref_model():
    return ref_build(ref_reduced("tinyllama_1_1b"), remat=False)


@pytest.fixture(scope="module")
def port_model():
    return build_model(get_reduced_config("tinyllama_1_1b"))


@pytest.fixture(scope="module")
def reference_runs(ref_model):
    """Three reference rounds per case of ``CASES``, one at a time through
    its Trainer, with the params and server state before each round and
    the offsets or masks each round took."""
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
        key, injected, before = jax.random.PRNGKey(1), [], []
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
            before.append((_np(trainer.params), _np(trainer.opt_state)))
            trainer.run(iter([{k: jnp.asarray(v) for k, v in
                               batches[r].items()}]), 1)
        before.append((_np(trainer.params), _np(trainer.opt_state)))
        runs[name] = dict(params=[b[0] for b in before[1:]], before=before,
                          injected=injected,
                          client_loss=[np.asarray(h["client_loss"])
                                       for h in trainer.history])
    return dict(params0=params0, batches=batches, runs=runs)


def _port_fed(port_model, name):
    mode, over, kw = CASES[name]
    return api.fed_round(port_model, _scfg(over), mode=mode, device="cpu",
                         **kw)


def _inject(inj):
    if "masks" in inj:
        return {"masks": convert.from_reference(inj["masks"], "cpu", lead=1)}
    return inj


def _port_state(state):
    """The reference's server state in the port's form."""
    if state == ():
        return ()
    if "t" in state:
        return {"m": convert.from_reference(state["m"], "cpu"),
                "v": convert.from_reference(state["v"], "cpu"),
                "t": int(state["t"])}
    return convert.from_reference(state, "cpu")


def _diffs(params, want):
    got = _leaves(convert.to_reference(params))
    return {path: np.abs(got[path] - w) for path, w in _leaves(want).items()}


@pytest.mark.parametrize("name", ["sgd", "momentum_stagger",
                                  "sgd_stagger_extract"])
def test_round_with_server_opt_matches_reference(reference_runs, port_model,
                                                 name):
    """``Trainer`` on a round built with ``server_opt=`` steps
    ``round_with_server_opt``: the shared-window fused arm, the per-client
    fused arm and the per-client extract arm against the reference's."""
    ref, run = reference_runs, reference_runs["runs"][name]
    fed = _port_fed(port_model, name)
    trainer = api.Trainer(fed, convert.from_reference(ref["params0"], "cpu"))
    assert trainer.server_opt is fed.server_opt is not None
    trainer.run(((b, _inject(i)) for b, i in
                 zip(ref["batches"], run["injected"])), ROUNDS)
    for r, h in enumerate(trainer.history):
        np.testing.assert_allclose(h["client_loss"].numpy(),
                                   run["client_loss"][r], atol=ATOL,
                                   rtol=RTOL, err_msg=f"{name} round {r}")
    got = _leaves(convert.to_reference(trainer.params))
    for path, want in _leaves(run["params"][-1]).items():
        np.testing.assert_allclose(got[path], want, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{name} {path}")


def _mean_delta(m_after, m_before):
    """The round's mean delta, read back from Adam's first moment."""
    return (m_after - ADAM_B1 * m_before) / (1 - ADAM_B1)


@pytest.mark.parametrize("name", ["adam", "adam_mask"])
def test_server_adam_each_round_matches_reference(reference_runs, port_model,
                                                  name):
    """Each Adam round from the reference's params and state before it (in
    mask mode with client momentum): the mean delta within 1e-5, every
    param within ``1e-5 + 2 lr dd / (sqrt(v_hat) + eps)`` (module
    docstring), and the state's step count carried."""
    ref, run = reference_runs, reference_runs["runs"][name]
    fed = _port_fed(port_model, name)
    for r in range(ROUNDS):
        params0, state0 = run["before"][r]
        after = run["before"][r + 1][1]
        params = convert.from_reference(params0, "cpu")
        batch = {k: _to_device(v, fed.device)
                 for k, v in ref["batches"][r].items()}
        params, state, metrics = fed.round_with_server_opt(
            params, _port_state(state0), batch, r,
            **_inject(run["injected"][r]))
        assert state["t"] == r + 1
        np.testing.assert_allclose(metrics["client_loss"].numpy(),
                                   run["client_loss"][r], atol=ATOL,
                                   rtol=RTOL, err_msg=f"{name} round {r}")
        m_port = _leaves(convert.to_reference(state["m"]))
        m_ref, m_prev = _leaves(after["m"]), _leaves(state0["m"])
        v_ref = _leaves(after["v"])
        for path, dp in _diffs(params, run["params"][r]).items():
            dd = np.abs(_mean_delta(m_port[path], m_prev[path])
                        - _mean_delta(m_ref[path], m_prev[path]))
            assert dd.max() <= ATOL, (name, r, path, float(dd.max()))
            v_hat = v_ref[path] / (1 - ADAM_B2 ** (r + 1))
            bound = ATOL + 2 * ADAM_LR * dd / (np.sqrt(v_hat) + ADAM_EPS)
            assert (dp <= bound).all(), (name, r, path,
                                         float((dp - bound).max()))


@pytest.mark.parametrize("name", ["adam", "adam_mask"])
def test_server_adam_chained_rounds_within_bound(reference_runs, port_model,
                                                 name):
    """Three chained Adam rounds through ``Trainer``, which carries the
    state: after round ``r`` every param within the first round's largest
    difference plus ``2 lr r``, the first round's client losses within
    1e-5, every loss finite."""
    ref, run = reference_runs, reference_runs["runs"][name]
    trainer = api.Trainer(_port_fed(port_model, name),
                          convert.from_reference(ref["params0"], "cpu"))
    first = None
    for r in range(ROUNDS):
        trainer.run(iter([(ref["batches"][r], _inject(run["injected"][r]))]),
                    1)
        d = _diffs(trainer.params, run["params"][r])
        worst = max(float(v.max()) for v in d.values())
        first = worst if first is None else first
        assert worst <= first + 2 * ADAM_LR * r, (name, r, worst)
    assert first < ADAM_LR
    assert trainer.opt_state["t"] == ROUNDS
    np.testing.assert_allclose(trainer.history[0]["client_loss"].numpy(),
                               run["client_loss"][0], atol=ATOL, rtol=RTOL)
    assert all(np.isfinite(trainer.losses))


def test_server_sgd_round_is_the_plain_round(port_model):
    """``server_opt="sgd"`` steps ``lr = server_lr`` on the mean delta:
    the paper's update, so its rounds equal the plain rounds."""
    it = lm_batches(512, (2, C, 2), S, seed=0)
    batches = [next(it) for _ in range(ROUNDS)]
    out = []
    for kw in ({}, dict(server_opt="sgd")):
        fed = api.fed_round(port_model, _scfg({}), device="cpu", **kw)
        trainer = api.Trainer(fed, port_model.init(0, device="cpu"))
        trainer.run(iter(batches), ROUNDS)
        out.append(trainer.params)
    for k in out[0]:
        np.testing.assert_allclose(out[0][k], out[1][k], atol=1e-6,
                                   rtol=1e-6, err_msg=k)


def test_trainer_server_opt_overrides_the_rounds_and_carries_state(
        port_model):
    """``Trainer(server_opt=...)`` overrides the round's own, makes its
    state from the params once and carries it across ``run`` calls."""
    fed = api.fed_round(port_model, _scfg({}), device="cpu",
                        server_opt="momentum")
    adam = server_opt.server_adam()
    trainer = api.Trainer(fed, port_model.init(0, device="cpu"),
                          server_opt=adam)
    assert trainer.server_opt is adam and trainer.opt_state["t"] == 0
    assert set(trainer.opt_state["m"]) == set(trainer.params)
    batches = lm_batches(512, (2, C, 2), S, seed=0)
    trainer.run(batches, 2)
    m = trainer.opt_state["m"]
    trainer.run(batches, 1)
    assert trainer.opt_state["t"] == 3 and trainer.opt_state["m"] is m
    assert all(np.isfinite(trainer.losses))
