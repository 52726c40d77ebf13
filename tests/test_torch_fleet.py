"""The port's asynchronous fleet (``repro_torch.fleet``, ``api.AsyncTrainer``).

* **The M = N anchor**, bit for bit inside the port: with M = N (buffer =
  ``clients_per_round``), a zero-spread fleet and no dropouts the async
  round sequence equals the port's own sync ``api.Trainer``, params and
  per-round client losses, for rolling, rolling with server Adam,
  staggered, static and ``full`` rounds (the reference's MLP triple, whose
  loss has no ``window=``: the extract phase) and the fused phase (a tiny
  TinyLlama: 2 layers, d_model 64, d_ff 128, 4 / 2 heads of 16).
  Heterogeneous rounds sum their reports in arrival order, not bucket
  order, so their anchor is allclose (1e-5), as the reference's.
* **An async regime against the reference's ``AsyncTrainer``**
  (stragglers, jitter, dropouts, a timeout, M < N, the ``inv_sqrt``
  server-lr schedule; its rolling offsets injected per round tag, since
  torch cannot reproduce ``jax.random``): the virtual times, staleness
  and ``lr_mult`` of every aggregation equal, the params within atol 1e-5
  and rtol 1e-5 (float32; the frameworks' products sum in other orders).
* The buffer, sampler, simulator, staleness and schedule contracts, with
  the numpy draws equal to the reference's; resume in flight; a callable
  source gets the sampled ids; capacity pairing and validation; the
  rejections; the layering scan; every report owning its storage.
* The per-client aggregation arms divide by the round's C, as the
  reference's, when handed m < C client changes (the fleet's case).

The JAX reference is imported inside the ``ref`` fixture, never at
collection: the card's machine has no JAX and runs this file's ``gpu``
tests (the M = N anchor on the card, bit for bit, and a reduced hetero
round on the card against the CPU) with ``--noconftest``.
"""
import dataclasses
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api, convert  # noqa: E402
from repro_torch.configs.base import (SubmodelConfig,  # noqa: E402
                                      get_reduced_config)
from repro_torch.core.trainer import _to_device  # noqa: E402
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.fleet.buffer import (STALENESS_POLICIES,  # noqa: E402
                                      ClientReport, DeltaBuffer,
                                      resolve_staleness)
from repro_torch.fleet.sampler import (SERVER_LR_SCHEDULES,  # noqa: E402
                                       EpochPermutationSampler,
                                       resolve_server_lr_schedule)
from repro_torch.fleet.simulator import (FleetSimulator,  # noqa: E402
                                         LatencyModel)
from repro_torch.models import build_model  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ATOL = RTOL = 1e-5
D_IN, D_H, C, K, MB = 6, 8, 4, 2, 3
CAPS = (1.0, 0.5, 0.5, 0.25)
AXES = {"w1": ("d_model", "d_ff"), "b1": ("d_ff",), "w2": ("d_ff",)}
TINY = dict(n_layers=2, vocab=64, d_model=64, d_ff=128, n_heads=4,
            n_kv_heads=2, head_dim=16)


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


@pytest.fixture(scope="module")
def ref():
    """The JAX reference, imported here rather than at collection."""
    import jax
    import jax.numpy as jnp

    from repro import api as ref_api
    from repro.configs.base import SubmodelConfig as RefSubmodelConfig
    from repro.fleet import buffer, sampler, simulator

    def loss(w, b):
        h = jnp.tanh(b["x"] @ w["w1"] + w["b1"])
        r = h @ w["w2"] - b["y"]
        return 0.5 * jnp.mean(r * r), {}

    triple = (loss, {k: jax.ShapeDtypeStruct(v.shape, jnp.float32)
                     for k, v in _params().items()}, AXES)
    return SimpleNamespace(jax=jax, jnp=jnp, api=ref_api, triple=triple,
                           scfg=lambda **kw: _scfg(RefSubmodelConfig, **kw),
                           buffer=buffer, sampler=sampler,
                           simulator=simulator)


# -- the MLP triple (shape-agnostic: every scheme takes the extract phase)


def port_loss(w, b):
    """All clients' losses ``[C]``: params and batch leaves ``[C, ...]``."""
    h = torch.tanh(torch.bmm(b["x"], w["w1"]) + w["b1"][:, None])
    r = torch.bmm(h, w["w2"][..., None])[..., 0] - b["y"]
    return 0.5 * (r * r).mean(-1), {}


def _params():
    rng = np.random.default_rng(0)
    return {"w1": (rng.standard_normal((D_IN, D_H)) * 0.3).astype(np.float32),
            "b1": np.zeros(D_H, np.float32),
            "w2": (rng.standard_normal(D_H) * 0.3).astype(np.float32)}


def _triple():
    return (port_loss,
            {k: torch.Size(v.shape) for k, v in _params().items()}, AXES)


def _p0():
    return convert.from_reference(_params(), "cpu")


def _scfg(cls=SubmodelConfig, **kw):
    base = dict(scheme="rolling", capacity=0.5, local_steps=K,
                clients_per_round=C, client_lr=0.1)
    base.update(kw)
    return cls(**base)


def _items(n, clients=C, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((K, clients, MB, D_IN)).astype(
                np.float32),
             "y": rng.standard_normal((K, clients, MB)).astype(np.float32)}
            for _ in range(n)]


def _stream(clients=C, seed=0):
    """A fresh deterministic infinite batch stream."""
    rng = np.random.default_rng(seed)
    while True:
        yield {"x": rng.standard_normal((K, clients, MB, D_IN)).astype(
                   np.float32),
               "y": rng.standard_normal((K, clients, MB)).astype(np.float32)}


def _bits(t):
    return t.contiguous().view(torch.int32)


def _bit_equal(a, b):
    return set(a) == set(b) and all(torch.equal(_bits(a[k]), _bits(b[k]))
                                    for k in a)


def _maxdelta(a, b):
    return max((a[k] - b[k]).abs().max().item() for k in a)


def _tiny():
    return build_model(dataclasses.replace(
        get_reduced_config("tinyllama_1_1b"), **TINY))


# -- the M = N anchor ------------------------------------------------------------


@pytest.mark.parametrize("name,kw,sopt", [
    ("rolling", {}, "none"),
    ("rolling_adam", {}, "adam"),
    ("stagger", {"stagger": True}, "none"),
    ("static", {"scheme": "static"}, "none"),
    ("full", {"scheme": "full"}, "none"),
], ids=lambda v: v if isinstance(v, str) else "")
def test_async_m_equals_n_matches_sync_bitwise(name, kw, sopt):
    """M = N, a zero-spread fleet, no dropouts: the async rounds are the
    port's sync ``Trainer`` rounds bit for bit, params and client losses;
    every report fresh (staleness 0, lr_mult 1)."""
    fed = api.fed_round(_triple(), _scfg(**kw), server_opt=sopt,
                        device="cpu")
    n, items = 5, _items(5)
    tr = api.Trainer(fed, _p0(), rng=5)
    p_sync, h_sync = tr.run(iter(items), n)
    at = api.AsyncTrainer(fed, _p0(), rng=5)
    p_async, h_async = at.run(iter(items), n)
    assert _bit_equal(p_sync, p_async)
    assert len(h_async) == n and at.scatter_aggregations == 0
    for rs, ra in zip(h_sync, h_async):
        assert rs["round"] == ra["round"]
        assert torch.equal(_bits(rs["client_loss"]), _bits(ra["client_loss"]))
        assert ra["staleness"] == 0.0 and ra["lr_mult"] == 1.0
    assert [r["virtual_time"] for r in h_async] == [1.0, 2.0, 3.0, 4.0, 5.0]


def test_async_anchor_fused_transformer():
    """The anchor on the fused client phase (the window-aware forward)."""
    m = _tiny()
    fed = api.fed_round(m, _scfg(client_lr=0.05), fused_forward="on",
                        device="cpu")
    it = lm_batches(64, (K, C, 2), 16, seed=0)
    items = [next(it) for _ in range(2)]
    tr = api.Trainer(fed, m.init(0, device="cpu"))
    p_sync, h_sync = tr.run(iter(items), 2)
    at = api.AsyncTrainer(fed, m.init(0, device="cpu"))
    p_async, h_async = at.run(iter(items), 2)
    assert at._fused is True
    assert _bit_equal(p_sync, p_async)
    for rs, ra in zip(h_sync, h_async):
        assert torch.equal(_bits(rs["client_loss"]), _bits(ra["client_loss"]))


def test_async_hetero_m_equals_n_allclose():
    """Heterogeneous capacities, M = N: the reports are full-shaped
    (the fused arms aggregate them) and summed in arrival order, so the
    anchor holds to float32 rounding."""
    fed = api.fed_round(_triple(), _scfg(), capacities=CAPS, device="cpu")
    items = _items(4)
    tr = api.Trainer(fed, _p0())
    p_sync, h_sync = tr.run(iter(items), 4)
    at = api.AsyncTrainer(fed, _p0())
    p_async, h_async = at.run(iter(items), 4)
    assert at._fused is True
    assert _maxdelta(p_sync, p_async) < 1e-5
    for rs, ra in zip(h_sync, h_async):
        np.testing.assert_allclose(rs["client_loss"], ra["client_loss"],
                                   rtol=1e-6, atol=1e-6)


def test_async_hetero_straggler_fleet_runs():
    """A capacity-annotated fleet with stragglers and M < N over a hetero
    round: rank-paired dispatch, finite losses, the full history."""
    fed = api.fed_round(_triple(), _scfg(), capacities=CAPS, device="cpu")
    fleet = api.FleetSimulator(
        8, api.LatencyModel(jitter_sigma=0.3, straggler_frac=0.25, seed=1),
        capacities=[1.0, 0.9, 0.6, 0.5, 0.4, 0.3, 0.2, 0.1])
    at = api.AsyncTrainer(fed, _p0(), buffer_size=2, fleet=fleet)
    rng = np.random.default_rng(0)

    def source(ids):
        return {"x": rng.standard_normal((K, len(ids), MB, D_IN)).astype(
                    np.float32),
                "y": rng.standard_normal((K, len(ids), MB)).astype(
                    np.float32)}

    _, h = at.run(source, 6)
    assert len(h) == 6 and all(np.isfinite(float(r["loss"])) for r in h)
    assert any(r["staleness"] > 0 for r in h)


# -- an async regime against the reference ----------------------------------------


REGIME = dict(jitter_sigma=0.3, straggler_frac=0.25, dropout=0.2,
              timeout=5.0, seed=1)


@pytest.mark.parametrize("over,sopt", [({}, "none"),
                                       ({"stagger": True}, "momentum")],
                         ids=["rolling", "stagger_server_momentum"])
def test_async_regime_matches_reference(ref, over, sopt):
    """Stragglers, jitter, dropouts, a timeout, M = 2 < N = 4, the
    ``inv_sqrt`` schedule, 12 aggregations: the port against the
    reference's ``AsyncTrainer`` on the same batches, with the reference's
    offsets injected per round tag.  Equal virtual times, staleness and
    lr_mult; params within 1e-5; staleness happens, and the rolling run
    aggregates mixed windows through the per-client arm in both."""
    jnp = ref.jnp
    n = 12
    rfed = ref.api.fed_round(ref.triple, ref.scfg(**over), server_opt=sopt,
                             kernel_backend="jnp")
    rat = ref.api.AsyncTrainer(
        rfed, {k: jnp.asarray(v) for k, v in _params().items()},
        rng=ref.jax.random.PRNGKey(7), buffer_size=2,
        fleet=ref.api.FleetSimulator(16, ref.api.LatencyModel(**REGIME)),
        server_lr_schedule="inv_sqrt")
    p_ref, h_ref = rat.run(_stream(), n)

    fed = api.fed_round(_triple(), _scfg(**over), server_opt=sopt,
                        device="cpu")
    fed._client_offsets = lambda r, params=None: {
        k: [int(o) for o in np.asarray(v)]
        for k, v in rfed.scheme.offsets(None, r, C).items()}
    at = api.AsyncTrainer(
        fed, _p0(), rng=7, buffer_size=2,
        fleet=api.FleetSimulator(16, api.LatencyModel(**REGIME)),
        server_lr_schedule="inv_sqrt")
    p, h = at.run(_stream(), n)

    for key in ("round", "virtual_time", "staleness", "lr_mult"):
        assert [r[key] for r in h] == [float(x[key]) if key != "round"
                                       else x[key] for x in h_ref], key
    assert any(r["staleness"] > 0 for r in h)
    for r, rr in zip(h, h_ref):
        np.testing.assert_allclose(r["client_loss"].numpy(),
                                   np.asarray(rr["client_loss"]), atol=ATOL,
                                   rtol=RTOL)
    for k, v in p.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(p_ref[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    # the reference's per-client clone: a shared-window round's entry
    # taken off the shared arm
    ref_scatter = rfed.shared_window and any(not key[1]
                                             for key in rat._agg_cache)
    assert (at.scatter_aggregations > 0) == ref_scatter
    assert ref_scatter == (not over)


def test_async_regime_bit_identical_replay():
    """A full async regime is deterministic: two fresh servers over the
    same seeds give the same history and params bit for bit."""
    fed = api.fed_round(_triple(), _scfg(), device="cpu")

    def run_once():
        fleet = api.FleetSimulator(16, api.LatencyModel(**REGIME))
        at = api.AsyncTrainer(fed, _p0(), rng=7, buffer_size=2, fleet=fleet,
                              server_lr_schedule="inv_sqrt")
        return at.run(_stream(), 12)

    (p1, h1), (p2, h2) = run_once(), run_once()
    assert _bit_equal(p1, p2)
    assert [float(r["loss"]) for r in h1] == [float(r["loss"]) for r in h2]
    for r in h1:
        assert r["lr_mult"] == 1.0 / np.sqrt(1.0 + r["round"])
    vts = [r["virtual_time"] for r in h1]
    assert vts == sorted(vts)


def test_async_run_resumes_in_flight():
    """Two ``run`` calls equal one: in-flight work persists across calls."""
    fed = api.fed_round(_triple(), _scfg(), device="cpu")
    fleet = dict(fleet=api.FleetSimulator(8, api.LatencyModel(
        straggler_frac=0.25, jitter_sigma=0.5)), buffer_size=2)
    at1 = api.AsyncTrainer(fed, _p0(), **fleet)
    p_once, _ = at1.run(_stream(), 6)
    src = _stream()
    at2 = api.AsyncTrainer(fed, _p0(), **fleet)
    at2.run(src, 2)
    p_split, _ = at2.run(src, 4)
    assert _bit_equal(p_once, p_split) and at2.round_idx == 6


def test_async_callable_source_gets_sampled_ids():
    """A callable source gets the sampled client ids, distinct within a
    dispatch, the first 8 covering the fleet (epoch permutation)."""
    fed = api.fed_round(_triple(), _scfg(), device="cpu")
    seen = []
    rng = np.random.default_rng(0)

    def source(ids):
        seen.append(np.asarray(ids))
        return {"x": rng.standard_normal((K, len(ids), MB, D_IN)).astype(
                    np.float32),
                "y": rng.standard_normal((K, len(ids), MB)).astype(
                    np.float32)}

    at = api.AsyncTrainer(fed, _p0(), fleet=api.FleetSimulator(8))
    at.run(source, 4)
    assert seen and all(len(np.unique(s)) == len(s) for s in seen)
    assert sorted(np.concatenate(seen)[:8].tolist()) == list(range(8))


def test_every_report_owns_its_storage():
    """A report's leaves are copies of its row, not views of the cohort's
    stacked change: each storage holds exactly its own tensor."""
    fed = api.fed_round(_triple(), _scfg(stagger=True), device="cpu")
    at = api.AsyncTrainer(fed, _p0(), fleet=api.FleetSimulator(8))
    at._dispatch(_stream())
    reps = [e[3] for e in at._events]
    assert len(reps) == C and all(rep is not None for rep in reps)
    seen = set()
    for rep in reps:
        for t in [*rep.delta.values(), rep.losses]:
            assert t.shape[0 if t is not rep.losses else 1] == 1
            assert t._base is None
            st = t.untyped_storage()
            assert st.nbytes() == t.numel() * t.element_size()
            assert st.data_ptr() not in seen
            seen.add(st.data_ptr())


# -- the aggregation arms with m < C changes ------------------------------------


ARMS = ["apply_mean_delta", "mean_delta_full", "apply_mean_delta_fused",
        "mean_delta_full_fused"]


@pytest.mark.parametrize("arm", ARMS)
def test_per_client_arms_divide_by_the_round_s_c(ref, arm):
    """Two client changes of a C = 4 per-client (staggered) round, through
    each per-client aggregation arm, against the reference's arm on the
    same changes: both divide by ``clients_per_round``, not by the two
    changes handed in (the fleet aggregates m < C reports so)."""
    jnp = ref.jnp
    rfed = ref.api.fed_round(ref.triple, ref.scfg(stagger=True),
                             kernel_backend="jnp")
    fed = api.fed_round(_triple(), _scfg(stagger=True), device="cpu")
    assert not fed.shared_window and not rfed.shared_window
    key = ("d_ff", D_H)
    offsets = {key: [0, 4]}
    fused = arm.endswith("_fused")
    shapes = (fed.abstract if fused else
              {"w1": (D_IN, 4), "b1": (4,), "w2": (4,)})
    rng = np.random.default_rng(3)
    delta = {k: rng.standard_normal((2, *s)).astype(np.float32)
             for k, s in shapes.items()}
    params = _params()
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    rd = {k: jnp.asarray(v) for k, v in delta.items()}
    ro = {key: jnp.asarray(offsets[key], jnp.int32)}
    pd = {k: torch.from_numpy(v.copy()) for k, v in delta.items()}
    pp = convert.from_reference(params, "cpu")
    if arm == "apply_mean_delta":
        want = rfed._apply_mean_delta(rp, rd, ro)
        got = fed._apply_mean_delta(pp, pd, offsets)
    elif arm == "mean_delta_full":
        want = rfed._mean_delta_full(rp, rd, ro)
        got = fed._mean_delta_full(pp, pd, offsets)
    elif arm == "apply_mean_delta_fused":
        want = rfed._apply_mean_delta_fused(rp, rd, ro)
        got = fed._apply_mean_delta_fused(pp, pd, offsets)
    else:
        want = rfed._mean_delta_full_fused(rd)
        got = fed._mean_delta_full_fused(pd)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6, err_msg=f"{arm} {k}")


# -- staleness policies, schedules, sampler, buffer, simulator -------------------


@pytest.mark.parametrize("name", sorted(STALENESS_POLICIES))
def test_staleness_policy_contract(ref, name):
    w = STALENESS_POLICIES[name]
    assert w(0) == 1.0
    vals = [w(float(t)) for t in range(9)]
    assert all(a >= b for a, b in zip(vals, vals[1:]))
    assert all(v > 0 for v in vals)
    assert vals == [ref.buffer.STALENESS_POLICIES[name](float(t))
                    for t in range(9)]


def test_staleness_default_is_fedbuff_inverse_sqrt():
    w = resolve_staleness("inverse_sqrt")
    assert w(1.0) == 1.0 / np.sqrt(2.0) and w(3.0) == 0.5
    assert resolve_staleness(lambda t: 0.25)(7.0) == 0.25
    with pytest.raises(ValueError, match="staleness"):
        resolve_staleness("nope")


def test_server_lr_schedules(ref):
    assert resolve_server_lr_schedule(None)(0) == 1.0
    assert resolve_server_lr_schedule("constant")(123) == 1.0
    inv = resolve_server_lr_schedule("inv_sqrt")
    assert inv(0) == 1.0 and inv(3) == 0.5
    step = SERVER_LR_SCHEDULES["step"](gamma=0.5, every=2)
    assert [step(r) for r in range(5)] == [1.0, 1.0, 0.5, 0.5, 0.25]
    assert resolve_server_lr_schedule(lambda r: 2.0)(0) == 2.0
    with pytest.raises(ValueError, match="schedule"):
        resolve_server_lr_schedule("nope")
    assert sorted(SERVER_LR_SCHEDULES) == \
        sorted(ref.sampler.SERVER_LR_SCHEDULES)
    for name in SERVER_LR_SCHEDULES:
        mine = resolve_server_lr_schedule(name)
        theirs = ref.sampler.resolve_server_lr_schedule(name)
        assert [mine(r) for r in range(300)] == \
            [theirs(r) for r in range(300)]


def test_sampler_epoch_coverage_and_errors():
    s = EpochPermutationSampler(8, seed=0)
    a, b = s.sample(4), s.sample(4)
    assert sorted(np.concatenate([a, b]).tolist()) == list(range(8))
    assert s.epoch == 1
    for bad in (0, 9):
        with pytest.raises(ValueError):
            s.sample(bad)
    with pytest.raises(ValueError):
        EpochPermutationSampler(0)


def test_sampler_draws_equal_the_reference(ref):
    draws = [3, 5, 2, 7, 1, 6, 7, 4]
    for seed in (0, 4, 5):
        mine = EpochPermutationSampler(7, seed=seed)
        theirs = ref.sampler.EpochPermutationSampler(7, seed=seed)
        for n in draws:
            got = mine.sample(n)
            assert len(np.unique(got)) == n
            np.testing.assert_array_equal(got, theirs.sample(n))
        assert mine.epoch == theirs.epoch


def _rep(cid, tag):
    return ClientReport(client_id=cid, slot=0, round_tag=tag,
                        delta={"w": torch.zeros((1, 2))}, offsets={},
                        losses=torch.zeros((K, 1)))


def test_buffer_fifo_ready_and_staleness_weights():
    buf = DeltaBuffer(2, staleness="inverse_sqrt")
    assert len(buf) == 0 and not buf.ready()
    for cid, tag in ((7, 0), (3, 1), (9, 2)):
        buf.report(_rep(cid, tag))
    assert buf.ready() and len(buf) == 3
    reps, taus, weights = buf.take(server_round=2)
    assert [r.client_id for r in reps] == [7, 3]
    np.testing.assert_array_equal(taus, [2, 1])
    np.testing.assert_allclose(weights,
                               [1.0 / np.sqrt(3.0), 1.0 / np.sqrt(2.0)])
    assert len(buf) == 1 and not buf.ready()


def test_buffer_errors():
    with pytest.raises(ValueError, match="m must be"):
        DeltaBuffer(0)
    buf = DeltaBuffer(2)
    buf.report(_rep(0, 0))
    with pytest.raises(RuntimeError, match="1 of 2"):
        buf.take(0)
    buf.report(_rep(1, 5))
    with pytest.raises(RuntimeError, match="future"):
        buf.take(1)


LATENCIES = [dict(), dict(jitter_sigma=0.5, dropout=0.3, seed=2),
             dict(straggler_frac=0.25, straggler_mult=10.0, seed=3),
             dict(jitter_sigma=0.3, straggler_frac=0.5, dropout=0.2,
                  timeout=5.0, seed=1)]


@pytest.mark.parametrize("lm", range(len(LATENCIES)))
def test_simulator_draws_equal_the_reference(ref, lm):
    """Stragglers, every ``draw`` and ``completion`` and the sync barrier's
    virtual seconds equal the reference's, bit for bit."""
    kw = LATENCIES[lm]
    mine = FleetSimulator(16, LatencyModel(**kw))
    theirs = ref.simulator.FleetSimulator(16,
                                          ref.simulator.LatencyModel(**kw))
    assert mine.stragglers == theirs.stragglers
    for c in range(16):
        for s in range(4):
            assert mine.draw(c, s) == theirs.draw(c, s)
            assert mine.completion(c, s) == theirs.completion(c, s)
    assert mine.simulate_sync(EpochPermutationSampler(16), 5, cohort=4) == \
        theirs.simulate_sync(ref.sampler.EpochPermutationSampler(16), 5,
                             cohort=4)


def test_simulator_contracts():
    f = FleetSimulator(4)
    assert f.stragglers == frozenset()
    assert all(f.completion(c, seq=c) == (1.0, True) for c in range(4))
    small = FleetSimulator(16, LatencyModel(straggler_frac=0.25,
                                            seed=3)).stragglers
    big = FleetSimulator(16, LatencyModel(straggler_frac=0.5,
                                          seed=3)).stragglers
    assert len(small) == 4 and len(big) == 8 and small <= big
    f = FleetSimulator(4, LatencyModel(dropout=1.0, timeout=2.5, seed=0))
    assert f.completion(0, 0) == (2.5, False)
    f = FleetSimulator(4, LatencyModel(dropout=1.0, seed=0))
    assert f.completion(0, 0) == (1.0, False)
    f = FleetSimulator(4, LatencyModel(straggler_frac=1.0, straggler_mult=8.0,
                                       timeout=3.0, seed=0))
    assert f.completion(0, 0) == (3.0, False)
    assert FleetSimulator(8).simulate_sync(EpochPermutationSampler(8), 5,
                                           cohort=4) == 5.0
    fs = FleetSimulator(8, LatencyModel(straggler_frac=0.5,
                                        straggler_mult=10.0, seed=0))
    assert fs.simulate_sync(EpochPermutationSampler(8), 2, cohort=8) == 20.0


# -- capacities, validation and layering -------------------------------------------


def test_pair_capacities_rank_matches_clients_to_slots():
    """The most capable sampled client takes the widest slot; without a
    fleet capacity vector the ids pass through."""
    fed = api.fed_round(_triple(), _scfg(), capacities=CAPS, device="cpu")
    fleet = api.FleetSimulator(6, capacities=[0.1, 0.9, 0.5, 0.7, 0.3, 0.2])
    at = api.AsyncTrainer(fed, _p0(), fleet=fleet)
    paired = at._pair_capacities(np.array([0, 1, 2, 3]), [0, 1, 2, 3])
    assert paired.tolist() == [1, 3, 2, 0]
    ids = np.array([2, 0, 1, 3])
    np.testing.assert_array_equal(
        api.AsyncTrainer(fed, _p0())._pair_capacities(ids, [0, 1, 2, 3]),
        ids)


def test_fleet_capacity_validation():
    with pytest.raises(ValueError, match="n_clients"):
        api.FleetSimulator(4, capacities=[0.5, 0.5])
    with pytest.raises(ValueError, match=r"in \(0, 1\]"):
        api.FleetSimulator(2, capacities=[0.5, 2.0])


def test_async_trainer_rejects_mask_mode_and_an_undersized_fleet():
    fed = api.fed_round(_triple(), _scfg(scheme="bernoulli"), device="cpu")
    with pytest.raises(TypeError, match="window-mode"):
        api.AsyncTrainer(fed, _p0())
    fed = api.fed_round(_triple(), _scfg(), device="cpu")
    with pytest.raises(ValueError, match="fleet"):
        api.AsyncTrainer(fed, _p0(), fleet=api.FleetSimulator(C - 1))


def test_fleet_never_constructs_rounds():
    """``repro_torch.fleet`` drives the round object handed to it: it
    imports neither the facade nor the round module."""
    pats = [re.compile(r"^\s*(?:from|import)\s+repro_torch\.api\b", re.M),
            re.compile(r"^\s*from\s+repro_torch\s+import\b.*\bapi\b", re.M),
            re.compile(r"^\s*(?:from|import)\s+repro_torch\.core\.fedavg\b",
                       re.M),
            re.compile(r"^\s*from\s+repro_torch\.core\s+import\b.*\bfedavg\b",
                       re.M)]
    pkg = os.path.join(SRC, "repro_torch", "fleet")
    scanned, offenders = set(), []
    for f in sorted(os.listdir(pkg)):
        if f.endswith(".py"):
            scanned.add(f)
            with open(os.path.join(pkg, f)) as fh:
                if any(p.search(fh.read()) for p in pats):
                    offenders.append(f)
    assert not offenders, f"the fleet imports the round layer: {offenders}"
    assert {"__init__.py", "buffer.py", "sampler.py", "server.py",
            "simulator.py"} <= scanned


def test_api_re_exports_the_fleet():
    assert api.AsyncTrainer.__module__ == "repro_torch.fleet.server"
    assert api.FleetSimulator is FleetSimulator
    assert api.LatencyModel is LatencyModel
    assert api.EpochPermutationSampler is EpochPermutationSampler
    assert api.STALENESS_POLICIES is STALENESS_POLICIES
    assert api.SERVER_LR_SCHEDULES is SERVER_LR_SCHEDULES


# -- on the card ------------------------------------------------------------------


@pytest.mark.gpu
def test_gpu_async_anchor_on_the_card_is_bit_equal():
    """Reduced TinyLlama on the card: 2 rounds of ``AsyncTrainer`` with M
    = N against 2 of ``Trainer`` from the same params, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; none is present")
    model = build_model(get_reduced_config("tinyllama_1_1b"))
    fed = api.fed_round(model, _scfg(axes=("d_ff", "heads", "kv_heads")))
    it = lm_batches(512, (K, C, 2), 64, seed=0)
    items = [next(it) for _ in range(2)]
    tr = api.Trainer(fed, model.init(0))
    p_sync, h_sync = tr.run(iter(items), 2)
    at = api.AsyncTrainer(fed, model.init(0))
    p_async, h_async = at.run(iter(items), 2)
    assert at._fused is True and _bit_equal(p_sync, p_async)
    for rs, ra in zip(h_sync, h_async):
        assert torch.equal(_bits(rs["client_loss"]), _bits(ra["client_loss"]))


@pytest.mark.gpu
def test_gpu_hetero_round_on_the_card_matches_the_cpu():
    """A reduced hetero round (fused buckets through the windowed-product
    kernels at three widths) on the card against the same round on the
    CPU, from the same params, within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; none is present")
    from repro_torch.kernels import _build
    model = build_model(get_reduced_config("tinyllama_1_1b"))
    scfg = _scfg(axes=("d_ff", "heads", "kv_heads"))
    batch = next(lm_batches(512, (K, C, 2), 64, seed=0))
    out = {}
    for dev in ("cpu", "cuda"):
        fed = api.fed_round(model, scfg, capacities=(1.0, 0.5, 0.25, 0.125),
                            device=dev)
        params = {k: v.to(dev) for k, v in model.init(
            0, device="cpu").items()}
        _build.reset_launches()
        p, info = fed.round(params, {k: _to_device(v, dev) for k, v in
                                     batch.items()}, 0)
        out[dev] = ({k: v.cpu() for k, v in p.items()},
                    info["client_loss"].cpu(), dict(_build.LAUNCHES))
    (pc, lc, _), (pg, lg, launches) = out["cpu"], out["cuda"]
    assert (lg - lc).abs().max().item() <= 1e-4
    assert _maxdelta(pg, pc) <= 1e-4
    for name in ("rolling_mm_fwd<1>", "rolling_mm_dx<1>",
                 "rolling_mm_fwd<2>", "rolling_mm_dx<2>", "sgd_inplace"):
        assert launches.get(name, 0) > 0, name
