"""SSM training in the port against the JAX reference.

The differentiable chunked SSD (``repro_torch.models.ssm.ssd_chunked``):

- its output, final state and gradients (x, B, C, dt, A) against
  ``jax.grad`` of the reference's ``ssd_chunked`` at a chunk of 32,
  within 1e-5 relative, plus 1e-5 of each tensor's largest magnitude
  (f32, two frameworks' summation orders; a gradient sums 64 positions'
  terms, so a near-cancelled entry carries the larger entries' rounding);
- at a chunk of 256 with ``dt = 0.69`` and ``A = -1`` the reference's
  ``d(dt)`` is not finite: its intra-chunk decay takes ``exp`` of the
  positive exponents above the diagonal, which overflow, and ``where``'s
  zero cotangent meets ``inf`` (0 * inf).  That pins a reference caveat
  (ROADMAP.md §C), not a port fault.  The port masks the exponent first:
  its gradients are finite and agree with a float64 run of the same
  function within 1e-4 of each gradient's largest magnitude (f32 against
  f64 over 512 positions).

The federated round on reduced Mamba2-130M (2 layers, S = 64, two chunks
of 32, C = 4, K = 2, the default axes: ``ssm_heads`` 8 of 16), from the
reference's params converted through numpy, with the reference's offsets
and masks injected: 3 rounds of the port's fused and extract phases
against the reference's extract arm (its fused == extract pins fail on
jax 0.9, ROADMAP.md §C), within 1e-5 on the per-client losses and every
param; one staggered-rolling round and one Bernoulli mask round likewise.
On these batches the reference's fused arm equals its extract arm to the
bit, and the port lies within 2.4e-7 of both.  Inside the port, fused ==
extract to the bit over 3 rounds, and the inactive heads get exact zero
gradients.  ``launch/train.py --arch mamba2_130m`` trains 2 rounds.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as ref_api  # noqa: E402
from repro.configs.base import SubmodelConfig as RefSubmodelConfig  # noqa
from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.configs.base import get_reduced_config as ref_reduced  # noqa: E402
from repro.core.fedavg import dense_client_masks as ref_masks  # noqa: E402
from repro.data.synthetic import lm_batches as ref_lm_batches  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models.ssm import ssd_chunked as ref_ssd_chunked  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch.configs.base import (SubmodelConfig,  # noqa: E402
                                      get_config, get_reduced_config)
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import AxisWindow, WindowMap  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402

ATOL = RTOL = 1e-5
F64_RTOL = 1e-4
ARCH = "mamba2_130m"
ROUNDS, S, C = 3, 64, 4
SCFG = dict(scheme="rolling", capacity=0.5, local_steps=2,
            clients_per_round=C, client_lr=0.1)


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


# -- (a) the differentiable chunked SSD ----------------------------------------


def _ssd_inputs(B, S, nh, hd, N, seed, dt=None, A=None):
    """x, dt, A, B, C and two cotangent weights (for y and the final
    state) as numpy f32; dt a softplus and A negative unless given."""
    rng = np.random.default_rng(seed)
    f = (lambda *s: rng.standard_normal(s).astype(np.float32))  # noqa
    x, Bm, Cm = f(B, S, nh, hd), f(B, S, N), f(B, S, N)
    if dt is None:
        dt = np.log1p(np.exp(f(B, S, nh))).astype(np.float32)
    else:
        dt = np.full((B, S, nh), dt, np.float32)
    A = (-np.exp(0.5 * f(nh)) if A is None
         else np.full((nh,), A, np.float32)).astype(np.float32)
    return (x, dt, A, Bm, Cm), (f(B, S, nh, hd), f(B, nh, hd, N))


def _ref_grads(args, cot, Q):
    wy, wh = map(jnp.asarray, cot)

    def f(*a):
        y, h = ref_ssd_chunked(*a, Q)
        return jnp.sum(y * wy) + jnp.sum(h * wh), (y, h)

    (_, (y, h)), g = jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4),
                                        has_aux=True)(*map(jnp.asarray, args))
    return np.asarray(y), np.asarray(h), [np.asarray(t) for t in g]


def _port_grads(args, cot, Q, dtype=torch.float32):
    ts = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in args]
    y, h = ssd_chunked(*ts, Q)
    wy, wh = (torch.tensor(c, dtype=dtype) for c in cot)
    (torch.sum(y * wy) + torch.sum(h * wh)).backward()
    return y.detach(), h.detach(), [t.grad for t in ts]


def test_ssd_chunked_forward_and_gradients_match_reference():
    args, cot = _ssd_inputs(2, 64, 4, 8, 16, seed=0)
    y_r, h_r, g_r = _ref_grads(args, cot, 32)
    y, h, g = _port_grads(args, cot, 32)
    for name, a, b in zip(("y", "h", "dx", "d(dt)", "dA", "dB", "dC"),
                          [y, h, *g], [y_r, h_r, *g_r]):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL,
                                   atol=ATOL * np.abs(b).max(),
                                   err_msg=name)


def test_ssd_chunked_gradient_is_finite_at_a_chunk_of_256():
    """The reference's NaN gradient at Mamba2's chunk (its caveat), and
    the port's finite one, held against float64."""
    args, cot = _ssd_inputs(1, 512, 2, 4, 8, seed=1, dt=0.69, A=-1.0)
    y_r, _, g_r = _ref_grads(args, cot, 256)
    assert not np.isfinite(g_r[1]).all()             # the reference's d(dt)
    y, _, g = _port_grads(args, cot, 256)
    _, _, g64 = _port_grads(args, cot, 256, torch.float64)
    np.testing.assert_allclose(y.numpy(), y_r,
                               atol=F64_RTOL * np.abs(y_r).max())
    for name, a, b in zip(("x", "dt", "A", "B", "C"), g, g64):
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.double().numpy(), b.numpy(),
                                   atol=F64_RTOL * float(b.abs().max()),
                                   err_msg=f"d{name}")


def test_per_sequence_A_is_a_broadcast_of_one_row():
    """A ``[B, nh]`` (one row per client's sequences, as the round folds C
    into the batch) with equal rows gives the bits of A ``[nh]``."""
    args, _ = _ssd_inputs(3, 64, 4, 8, 16, seed=2)
    x, dt, A, Bm, Cm = (torch.tensor(a) for a in args)
    y, h = ssd_chunked(x, dt, A, Bm, Cm, 32)
    y2, h2 = ssd_chunked(x, dt, A.expand(3, 4), Bm, Cm, 32)
    assert torch.equal(y, y2) and torch.equal(h, h2)


# -- (b) which client phase the default axes take ------------------------------


@pytest.mark.parametrize("arch,reduced,windowed", [
    ("mamba2_130m", True, {"ssm_heads"}),
    ("hymba_1_5b", True, {"d_ff", "ssm_heads"}),
    ("hymba_1_5b", False, {"d_ff", "heads", "kv_heads", "ssm_heads"}),
], ids=["mamba2", "hymba_reduced", "hymba_full"])
def test_default_axes_take_the_fused_phase(arch, reduced, windowed):
    """The reference's ``test_resolve_fused_full_default_axes``: the fused
    phase covers every properly windowed axis (reduced Hymba's single kv
    head makes its heads windows improper), with the reference's keys."""
    cfg = (get_reduced_config if reduced else get_config)(arch)
    scfg = dict(scheme="rolling", capacity=0.5, local_steps=2,
                clients_per_round=4)
    fed = api.fed_round(build_model(cfg), SubmodelConfig(**scfg),
                        device="cpu")
    assert fed.use_fused
    assert {k[0] for k in fed._fused_keys} == windowed
    rcfg = (ref_reduced if reduced else ref_config)(arch)
    rfed = ref_api.fed_round(ref_build(rcfg, remat=False),
                             RefSubmodelConfig(**scfg))
    assert rfed.use_fused and fed._fused_keys == rfed._fused_keys


# -- (c) rounds against the reference ------------------------------------------


def _offsets(fed, r):
    return {k: [int(o) for o in np.asarray(v)] for k, v in
            fed.scheme.offsets(None, r, C).items()}


@pytest.fixture(scope="module")
def ref_model():
    return ref_build(ref_reduced(ARCH), remat=False)


@pytest.fixture(scope="module")
def port_model():
    return build_model(get_reduced_config(ARCH))


@pytest.fixture(scope="module")
def reference_runs(ref_model):
    """The reference's rounds, shared by this module's tests: 3 rounds of
    each window arm (extract and fused), one staggered-rolling extract
    round and one Bernoulli mask round, with the offsets and masks each
    drew."""
    params0 = _np(ref_model.init(jax.random.PRNGKey(0)))
    it = ref_lm_batches(ref_model.cfg.vocab, (2, C, 2), S, seed=0)
    batches = [next(it) for _ in range(ROUNDS)]
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    runs = {}
    for name, over, ff, n in (("extract", {}, "off", ROUNDS),
                              ("fused", {}, "on", ROUNDS),
                              ("stagger", dict(stagger=True), "off", 1)):
        fed = ref_api.fed_round(ref_model, RefSubmodelConfig(**SCFG, **{
            k: v for k, v in over.items()}), kernel_backend="jnp",
            fused_forward=ff)
        trainer = ref_api.Trainer(fed, jax.tree_util.tree_map(
            jnp.asarray, params0), rng=1)
        params, history = trainer.run(iter(jb[:n]), n)
        runs[name] = dict(
            params=_np(params), offsets=[_offsets(fed, r) for r in range(n)],
            client_loss=[np.asarray(h["client_loss"]) for h in history])
    scfg = RefSubmodelConfig(**{**SCFG, "scheme": "bernoulli"})
    caps = jnp.full((C,), 0.5, jnp.float32)
    fed = ref_api.fed_round(ref_model, scfg, mode="mask",
                            kernel_backend="jnp")
    key = jax.random.PRNGKey(7)
    masks = _np(ref_masks(key, ref_model.abstract_params(), ref_model.axes(),
                          scfg, caps, 0))
    params, metrics = jax.jit(fed.round)(
        jax.tree_util.tree_map(jnp.asarray, params0), jb[0], 0, key)
    runs["bernoulli"] = dict(params=_np(params), masks=masks,
                             client_loss=[np.asarray(metrics["client_loss"])])
    return dict(params0=params0, batches=batches, runs=runs)


def _check_run(trainer, run):
    for r, h in enumerate(trainer.history):
        np.testing.assert_allclose(h["client_loss"].numpy(),
                                   run["client_loss"][r], atol=ATOL,
                                   rtol=RTOL)
    got = _leaves(convert.to_reference(trainer.params))
    for path, want in _leaves(run["params"]).items():
        np.testing.assert_allclose(got[path], want, atol=ATOL, rtol=RTOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("ff", ["auto", "off"], ids=["fused", "extract"])
def test_three_rounds_match_reference_extract_arm(reference_runs, port_model,
                                                  ff):
    ref = reference_runs
    run = ref["runs"]["extract"]
    fed = api.fed_round(port_model, SubmodelConfig(**SCFG), fused_forward=ff,
                        device="cpu")
    assert fed.use_fused == (ff == "auto")
    trainer = api.Trainer(fed, convert.from_reference(ref["params0"], "cpu"))
    trainer.run(((b, {"offsets": o}) for b, o in
                 zip(ref["batches"], run["offsets"])), ROUNDS)
    _check_run(trainer, run)
    # the reference's fused arm, on these batches: the port holds to it too
    _check_run(trainer, ref["runs"]["fused"])


def test_staggered_round_matches_reference(reference_runs, port_model):
    ref = reference_runs
    run = ref["runs"]["stagger"]
    assert len(set(run["offsets"][0][("ssm_heads", 16)])) > 1
    fed = api.fed_round(port_model, SubmodelConfig(**SCFG, stagger=True),
                        device="cpu")
    assert fed.use_fused and not fed.shared_window
    trainer = api.Trainer(fed, convert.from_reference(ref["params0"], "cpu"))
    trainer.run(iter([(ref["batches"][0], {"offsets": run["offsets"][0]})]),
                1)
    _check_run(trainer, run)


def test_bernoulli_mask_round_matches_reference(reference_runs, port_model):
    ref = reference_runs
    run = ref["runs"]["bernoulli"]
    fed = api.fed_round(port_model, SubmodelConfig(**{**SCFG,
                                                      "scheme": "bernoulli"}),
                        device="cpu")
    assert isinstance(fed, api.MaskFedAvg)
    trainer = api.Trainer(fed, convert.from_reference(ref["params0"], "cpu"))
    trainer.run(iter([(ref["batches"][0], {"masks": convert.from_reference(
        run["masks"], "cpu", lead=1)})]), 1)
    _check_run(trainer, run)


# -- (d) inside the port ----------------------------------------------------------


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_fused_equals_extract_to_the_bit(port_model):
    cfg = port_model.cfg
    batches = lm_batches(cfg.vocab, (2, C, 2), S, seed=0)
    batches = [next(batches) for _ in range(ROUNDS)]
    out = {}
    for ff in ("on", "off"):
        fed = api.fed_round(port_model, SubmodelConfig(**SCFG),
                            fused_forward=ff, device="cpu")
        trainer = api.Trainer(fed, port_model.init(0, device="cpu"))
        trainer.run(iter(batches), ROUNDS)
        out[ff] = trainer
    fused, extract = out["on"], out["off"]
    for a, b in zip(fused.history, extract.history):
        assert torch.equal(_bits(a["client_loss"]), _bits(b["client_loss"]))
    for k in fused.params:
        assert torch.equal(_bits(fused.params[k]),
                           _bits(extract.params[k])), k


# (leaf, the dim of its [C, ...] form that ssm_heads tags)
HEAD_DIMS = {"w_z": 2, "w_x": 2, "w_dt": 2, "dt_bias": 1, "A_log": 1,
             "D_skip": 1, "conv_x": 2, "y_norm": 1, "w_out": 1}


@pytest.mark.parametrize("offsets", [[4, 4], [0, 8]],
                         ids=["shared", "per_client"])
def test_inactive_heads_get_exact_zero_gradients(port_model, offsets):
    """Every ``ssm_heads`` leaf's gradient is exactly 0 outside each
    client's window of 8 of 16 heads, and not 0 inside it."""
    cfg = port_model.cfg
    params = {k: torch.stack([v, v]).requires_grad_() for k, v in
              port_model.init(0, device="cpu").items()}
    window = WindowMap({("ssm_heads", 16): AxisWindow(offsets, 8)})
    tokens = torch.randint(0, cfg.vocab, (2, 2, S),
                           generator=torch.Generator().manual_seed(0))
    loss, _ = port_model.loss(params, {"tokens": tokens}, window=window)
    grads = dict(zip(params, torch.autograd.grad(loss.sum(),
                                                 list(params.values()))))
    for path, g in grads.items():
        name = path.rsplit("/", 1)[-1]
        if "/ssm/" not in path or name not in HEAD_DIMS:
            continue
        d = HEAD_DIMS[name]
        for c, o in enumerate(offsets):
            inside = g[c].narrow(d - 1, o, 8)
            assert torch.count_nonzero(inside) > 0, path
            assert torch.count_nonzero(g[c]) == torch.count_nonzero(
                inside), path


def test_train_cli_trains_mamba2(capsys):
    out = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--rounds", "2", "--seq", str(S), "--log-every", "1",
                      "--lr", "0.1"])
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    assert len(re.findall(r"round +\d+ loss", capsys.readouterr().out)) == 2
