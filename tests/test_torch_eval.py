"""One model's evaluation path in the port against the JAX reference.

- The scalar-offset window products (the reference's ``rolling_matmul``,
  ``rolling_matmul_multi``, ``rolling_matmul_dx`` and
  ``rolling_matmul_dx_multi``; C = 1 launches of the port's kernels on the
  card, their plain versions here) against the reference's Pallas kernels
  in interpret mode at a block-aligned offset, and against the reference's
  oracle (``repro.kernels.ref.rolling_matmul_ref``, ``jax.vjp`` of
  ``dispatch.rolling_matmul_multi``) at a misaligned one.
- ``Model.loss`` of one model (params without a client dimension, tokens
  ``[B, S]``) on a 2-layer reduced TinyLlama at S = 128 against the
  reference's ``model.loss``, with ``REPRO_USE_FLASH`` and without (the
  reference's switch is its module global ``_USE_FLASH``, monkeypatched),
  and with a window, value and gradient.
- ``Trainer``'s eval, logging, callbacks and ``start_round`` against the
  reference's ``Trainer`` with the same offsets injected, and checkpoints
  that load in the other package.

Tolerance: float32, atol 1e-5 and rtol 1e-5 -- two frameworks, two
summation orders through two layers of matmuls, softmax and a 512-way
cross-entropy (the round tests' tolerance, ``test_torch_round.py``).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as ref_api  # noqa: E402
from repro.checkpoint import checkpoint as ref_ckpt  # noqa: E402
from repro.configs.base import SubmodelConfig as RefSubmodelConfig  # noqa
from repro.configs.base import get_reduced_config as ref_reduced  # noqa: E402
from repro.data.synthetic import lm_batches as ref_lm_batches  # noqa: E402
from repro.kernels import dispatch as ref_dispatch  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402
from repro.kernels import rolling_matmul as ref_rmm  # noqa: E402
from repro.kernels import rolling_matmul_bwd as ref_rmm_bwd  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch.checkpoint import checkpoint  # noqa: E402
from repro_torch.configs.base import (SubmodelConfig,  # noqa: E402
                                      get_reduced_config)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rolling_matmul import rolling_matmul  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ATOL = RTOL = 1e-5
S = 128
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


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                               rtol=RTOL)


# -- the scalar-offset window products (TPU rows 1-4) --------------------------

M, K, N, WIN, BLK = 64, 96, 256, 64, 32


def _mm_data(T, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            [rng.standard_normal((K, N)).astype(np.float32)
             for _ in range(T)],
            [rng.standard_normal((M, WIN)).astype(np.float32)
             for _ in range(T)])


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("T", [1, 2])
def test_scalar_products_match_pallas_kernels_at_aligned_offset(T):
    """Rows 1-4 in interpret mode, offset 3 blocks in: the forward of each
    weight and the (summed) input gradient, through the autograd
    function."""
    x, ws, dys = _mm_data(T)
    off = 3 * BLK
    blocks = dict(bm=BLK, bn=BLK, bk=BLK, interpret=True)
    if T == 1:
        want_y = [ref_rmm.rolling_matmul(x, ws[0], off, WIN, **blocks)]
        want_dx = ref_rmm_bwd.rolling_matmul_dx(dys[0], ws[0], off, WIN,
                                                **blocks)
    else:
        want_y = ref_rmm.rolling_matmul_multi(x, jnp.stack(ws), off, WIN,
                                              **blocks)
        want_dx = ref_rmm_bwd.rolling_matmul_dx_multi(
            jnp.stack(dys), jnp.stack(ws), off, WIN, **blocks)
    xt = _t(x).requires_grad_()
    got_y = rolling_matmul(xt, [_t(w) for w in ws], off, WIN)
    assert len(got_y) == T
    for a, b in zip(got_y, want_y):
        _close(a.detach(), b)
    (got_dx,) = torch.autograd.grad(got_y, [xt], [_t(d) for d in dys])
    _close(got_dx, want_dx)


@pytest.mark.parametrize("T", [1, 2])
def test_scalar_products_and_vjp_match_oracle_at_misaligned_offset(T):
    """A misaligned offset (the TPU kernels need block-aligned ones; the
    port's take any): values against ``rolling_matmul_ref`` and the whole
    VJP -- dx through the kernel, dW as a window write -- against
    ``jax.vjp`` of the reference's jnp arm."""
    x, ws, dys = _mm_data(T, seed=1)
    off = 37
    for a, w in zip(rolling_matmul(_t(x), [_t(w) for w in ws], off, WIN),
                    ws):
        _close(a, ref_oracles.rolling_matmul_ref(x, w, off, WIN))
    xt = _t(x).requires_grad_()
    wt = [_t(w).requires_grad_() for w in ws]
    ys = rolling_matmul(xt, wt, off, WIN)
    got = torch.autograd.grad(ys, [xt, *wt], [_t(d) for d in dys])
    _, vjp = jax.vjp(lambda x_, *w_: ref_dispatch.rolling_matmul_multi(
        x_, w_, off, WIN, backend="jnp"), x, *ws)
    want = vjp(tuple(jnp.asarray(d) for d in dys))
    for a, b in zip(got, want):
        _close(a, b)
    for w in got[1:]:
        assert torch.count_nonzero(w[:, :off]) == 0
        assert torch.count_nonzero(w[:, off + WIN:]) == 0


def test_scalar_window_refuses_several_clients():
    """One model's window (a scalar offset) on two clients' weights."""
    from repro_torch.models.layers import AxisWindow, head_proj
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal((2, 3, 8)).astype(np.float32))
    w = _t(rng.standard_normal((2, 8, 4, 2)).astype(np.float32))
    with pytest.raises(ValueError, match="client count"):
        head_proj(x, w, AxisWindow(1, 2))


# -- one model's loss -----------------------------------------------------------


@pytest.fixture(scope="module")
def one_model():
    cfg = ref_reduced("tinyllama_1_1b")
    model = ref_build(cfg, remat=False)
    params = model.init(jax.random.PRNGKey(0))
    tokens = next(ref_lm_batches(cfg.vocab, (2,), S, seed=9))["tokens"]
    port_model = build_model(get_reduced_config("tinyllama_1_1b"))
    port_params = convert.from_reference(_np(params), device="cpu")
    return cfg, model, params, tokens, port_model, port_params


def _window(cfg):
    """A shared window of every axis at misaligned offsets, in the
    reference's dict form and (``(offset, win)`` pairs) the port's."""
    G = cfg.n_heads // cfg.n_kv_heads
    kv = 1
    return {("kv_heads", cfg.n_kv_heads): (kv, cfg.n_kv_heads // 2),
            ("heads", cfg.n_heads): (kv * G, cfg.n_heads // 2),
            ("d_ff", cfg.d_ff): (37, cfg.d_ff // 2)}


@pytest.mark.parametrize("flash", [False, True], ids=["blockwise", "flash"])
def test_one_model_loss_matches_reference(one_model, flash, monkeypatch):
    cfg, model, params, tokens, port_model, port_params = one_model
    monkeypatch.setattr(ref_attention, "_USE_FLASH", flash)
    if flash:
        monkeypatch.setenv("REPRO_USE_FLASH", "1")
    else:
        monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    want, want_m = model.loss(params, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got, got_m = port_model.loss(port_params, {"tokens": _t(tokens).long()})
    assert got.shape == () and set(got_m) == set(want_m)
    _close(got, want)
    for k in want_m:
        _close(got_m[k], want_m[k])


def test_one_model_windowed_loss_and_grad_match_reference(one_model,
                                                          monkeypatch):
    cfg, model, params, tokens, port_model, port_params = one_model
    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    win = _window(cfg)
    (want, _), want_g = jax.value_and_grad(
        lambda p: model.loss(p, {"tokens": jnp.asarray(tokens)}, window=win),
        has_aux=True)(params)
    p = {k: v.clone().requires_grad_() for k, v in port_params.items()}
    n = dict(_build.LAUNCHES)
    got, _ = port_model.loss(p, {"tokens": _t(tokens).long()}, window=win)
    grads = torch.autograd.grad(got, list(p.values()))
    assert dict(_build.LAUNCHES) == n      # plain versions on the CPU
    _close(got.detach(), want)
    got_g = dict(jax.tree_util.tree_leaves_with_path(convert.to_reference(
        dict(zip(p, grads)))))
    for path, g in jax.tree_util.tree_leaves_with_path(_np(want_g)):
        np.testing.assert_allclose(got_g[path], g, atol=ATOL, rtol=RTOL,
                                   err_msg=str(path))


def test_windowed_flash_eval_equals_blockwise_eval(one_model, monkeypatch):
    """The windowed sub-model's loss through flash (the port's eval path)
    against the same loss through blockwise attention."""
    cfg, _, _, tokens, port_model, port_params = one_model
    batch = {"tokens": _t(tokens).long()}
    with torch.no_grad():
        monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
        want, _ = port_model.loss(port_params, batch, window=_window(cfg))
        monkeypatch.setenv("REPRO_USE_FLASH", "1")
        got, _ = port_model.loss(port_params, batch, window=_window(cfg))
    _close(got, want)


def test_flash_switch_refuses_autograd(one_model, monkeypatch):
    cfg, _, _, tokens, port_model, port_params = one_model
    monkeypatch.setenv("REPRO_USE_FLASH", "1")
    p = {k: v.clone().requires_grad_() for k, v in port_params.items()}
    with pytest.raises(NotImplementedError, match="flash attention backward"):
        port_model.loss(p, {"tokens": _t(tokens).long()})


def test_one_model_takes_every_window_form(one_model):
    """``(offset, win)`` pairs, ``AxisWindow`` s and a ``WindowMap`` give the
    same loss; the legacy bare pair means a ``d_ff`` window."""
    from repro_torch.models.layers import AxisWindow, WindowMap
    cfg, _, _, tokens, port_model, port_params = one_model
    batch = {"tokens": _t(tokens[:1, :32]).long()}
    win = _window(cfg)
    with torch.no_grad():
        a, _ = port_model.loss(port_params, batch, window=win)
        b, _ = port_model.loss(port_params, batch, window=WindowMap(
            {k: AxisWindow(o, w) for k, (o, w) in win.items()}))
        c, _ = port_model.loss(port_params, batch,
                               window=win[("d_ff", cfg.d_ff)])
        d, _ = port_model.loss(port_params, batch, window={
            ("d_ff", cfg.d_ff): AxisWindow([37], cfg.d_ff // 2)})
    assert torch.equal(a, b) and torch.equal(c, d)


# -- Trainer: eval, logging, callbacks, resume ---------------------------------


def _rounds(n, start):
    """The reference's window offsets for rounds start .. start + n - 1."""
    model = ref_build(ref_reduced("tinyllama_1_1b"), remat=False)
    fed = ref_api.fed_round(model, RefSubmodelConfig(**SCFG),
                            kernel_backend="jnp")
    return [{k: [int(o) for o in np.asarray(v)] for k, v in
             fed.scheme.offsets(None, r, 4).items()}
            for r in range(start, start + n)]


def test_trainer_eval_log_and_callbacks_match_reference():
    cfg = ref_reduced("tinyllama_1_1b")
    model = ref_build(cfg, remat=False)
    params0 = _np(model.init(jax.random.PRNGKey(0)))
    it = ref_lm_batches(cfg.vocab, (2, 4, 2), 32, seed=0)
    batches = [next(it) for _ in range(3)]
    eval_tokens = next(ref_lm_batches(cfg.vocab, (4,), 32, seed=999))[
        "tokens"]
    start, n = 1, 3
    runs = {}
    for side in ("ref", "port"):
        lines, seen = [], []
        kw = dict(eval_every=2, log_every=2, log_fn=lines.append,
                  start_round=start,
                  callbacks=[lambda r, p, rec: seen.append(
                      (r, sorted(rec)))])
        if side == "ref":
            fed = ref_api.fed_round(model, RefSubmodelConfig(**SCFG),
                                    kernel_backend="jnp")
            batch = {"tokens": jnp.asarray(eval_tokens)}
            trainer = ref_api.Trainer(
                fed, jax.tree_util.tree_map(jnp.asarray, params0), rng=1,
                eval_fn=lambda p: {"eval": float(model.loss(p, batch)[0])},
                **kw)
            trainer.run(({k: jnp.asarray(v) for k, v in b.items()}
                         for b in batches), n)
        else:
            port_model = build_model(get_reduced_config("tinyllama_1_1b"))
            fed = api.fed_round(port_model, SubmodelConfig(**SCFG),
                                device="cpu")
            batch = {"tokens": _t(eval_tokens).long()}
            trainer = api.Trainer(
                fed, convert.from_reference(params0, device="cpu"),
                eval_fn=lambda p: {"eval": port_model.loss(p, batch)[0]},
                **kw)
            trainer.run(((b, {"offsets": o}) for b, o in
                         zip(batches, _rounds(n, start))), n)
        runs[side] = (trainer, lines, seen)
    (rt, r_lines, r_seen), (pt, p_lines, p_seen) = runs["ref"], runs["port"]
    assert pt.round_idx == rt.round_idx == start + n
    assert p_seen == r_seen == [(1, ["client_loss", "loss", "round"]),
                                (2, ["client_loss", "eval", "loss", "round"]),
                                (3, ["client_loss", "eval", "loss", "round"])]
    for a, b in zip(pt.history, rt.history):
        assert a["round"] == b["round"]
        _close(a["client_loss"], b["client_loss"])
        if "eval" in b:
            _close(a["eval"], b["eval"])
    num = re.compile(r"-?\d+\.\d{4}")
    assert len(p_lines) == len(r_lines) == 2
    for a, b in zip(p_lines, r_lines):
        assert num.sub("#", a) == num.sub("#", b)
        assert a.startswith("round    2 loss") or a.startswith("round    3")
        np.testing.assert_allclose([float(x) for x in num.findall(a)],
                                   [float(x) for x in num.findall(b)],
                                   atol=2e-4)


def test_trainer_steps_a_server_optimizer():
    """A ``ServerOpt`` handed to the Trainer is stepped through
    ``round_with_server_opt``, its state carried (server ``sgd`` is the
    paper's update, so the params equal the plain round's)."""
    from repro_torch.core.server_opt import server_sgd
    model = build_model(get_reduced_config("tinyllama_1_1b"))
    fed = api.fed_round(model, SubmodelConfig(**SCFG), device="cpu")
    batch = {"tokens": np.random.default_rng(0).integers(
        0, 512, (2, 4, 2, 32))}
    out = []
    for opt in (None, server_sgd()):
        trainer = api.Trainer(fed, model.init(0, device="cpu"),
                              server_opt=opt)
        assert (trainer.opt_state is None) == (opt is None)
        trainer.run(iter([batch]), 1)
        out.append(trainer.params)
    for k in out[0]:
        torch.testing.assert_close(out[0][k], out[1][k], atol=1e-6,
                                   rtol=1e-6)


# -- checkpoints -----------------------------------------------------------------


def _bits_equal_trees(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert len(la) == len(lb)
    for path, x in la:
        y = np.asarray(lb[path])
        x = np.asarray(x)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert np.array_equal(x.view(np.uint32), y.view(np.uint32)), path


def test_checkpoints_load_in_the_other_package(tmp_path):
    model = ref_build(ref_reduced("tinyllama_1_1b"), remat=False)
    ref_params = _np(model.init(jax.random.PRNGKey(4)))
    port_params = build_model(get_reduced_config("tinyllama_1_1b")).init(
        5, device="cpu")
    # the port writes, the reference reads
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, port_params, {"round": 7})
    tree, meta = ref_ckpt.load(path)
    assert meta["round"] == 7 and "layers/mlp/w_gate" in meta["dtypes"]
    _bits_equal_trees(convert.to_reference(port_params), tree)
    # the reference writes, the port reads
    path = str(tmp_path / "ref.npz")
    ref_ckpt.save(path, ref_params, {"round": 3})
    params, meta = checkpoint.load(path, device="cpu")
    assert meta["round"] == 3 and set(params) == set(port_params)
    _bits_equal_trees(ref_params, convert.to_reference(params))


def test_checkpoint_callback_round_trip(tmp_path):
    model = build_model(get_reduced_config("tinyllama_1_1b"))
    fed = api.fed_round(model, SubmodelConfig(**SCFG), device="cpu")
    path = str(tmp_path / "ckpt.npz")
    trainer = api.Trainer(fed, model.init(0, device="cpu"),
                          callbacks=[api.checkpoint_callback(path, every=2)])
    it = ref_lm_batches(512, (2, 4, 2), 16, seed=0)
    trainer.run(it, 2)
    params, meta = checkpoint.load(path, device="cpu")
    # every=2 saves round 0 only; round 1's params moved on since
    assert meta["round"] == 1 and len(meta["history"]) == 1
    trainer2 = api.Trainer(fed, params, start_round=meta["round"])
    assert trainer2.round_idx == 1
    checkpoint.save(path, trainer.params, {"round": trainer.round_idx})
    params, meta = checkpoint.load(path, device="cpu")
    assert meta["round"] == 2 and set(params) == set(trainer.params)
    for k, v in trainer.params.items():
        assert torch.equal(params[k].view(torch.int32), v.view(torch.int32))
