"""bf16 parameters in the port, held against the JAX reference at bf16.

Reduced TinyLlama (2 layers) built with ``param_dtype`` bfloat16 in both
packages, S = 32, C = 4, K = 2, on the CPU; the port starts from the
reference's bf16 params (carried bit for bit by ``convert``), with the
reference's rolling offsets and Bernoulli masks injected.  The rule in
both: bf16 storage, every product and update computed in float32 and
rounded once to bf16; client deltas, the server's mean delta, the server
optimizer's state and client momentum in float32.

Tolerances, each stated where it is used, none looser than the
reference's own bf16 tolerance (``tests/test_kernels.py:18``, rtol = atol
= 2e-2):

* The plain versions of the update kernels (TPU rows 9-11) against the
  Pallas bodies in interpret mode: one bf16 ulp, plus 1e-6 of the largest
  magnitude (where the result cancels to about 0).  Both round one
  float32 result, but XLA contracts ``p - lr * m * g`` and ``w + scale *
  acc`` into a fused multiply-add (ROADMAP.md §C, "FMA contraction"),
  which moves the f32 result by an ulp of f32 and now and then across a
  bf16 rounding boundary.
* The plain versions of the windowed products (rows 1-8): one bf16 ulp of
  the reference's value plus 1e-6 of its largest magnitude, for the same
  reason (float32 sums in other orders, one rounding each).
* Attention: one bf16 ulp against the reference's ``blockwise_attention``
  and ``decode_attention`` (which sum QK^T and P V in float32).
* ``Model.loss``: 5e-3 on losses near 6.7.  Gradients and logits: 2e-2
  of each tensor's largest magnitude plus 2e-2 of each element's (bf16
  activations round at different points in the two frameworks: XLA fuses
  elementwise chains in float32, torch rounds each op's bf16 result).
  Client losses of the rounds: 2e-2 absolute (measured: at most 0.0165,
  by round 3 of the window rounds).
* Params after rounds, held by their change from the starting params
  (:func:`_delta_gaps`): ``|port - ref| / |ref - p0|`` in the Euclidean
  norm, over all leaves together within 0.15 and for each leaf that the
  reference moved in 1000 elements or more within 0.4; a state that did
  not move reads 1 (checked in each test).  A round changes most weights
  by a few bf16 ulp, so the two frameworks' ulp-level rounding differences
  stay in the weights: measured 0.037-0.059 over all leaves and at most
  0.20 for a leaf (element by element at most 4e-3 on weights up to 1).
  The norm weights, which a round moves in a handful of elements by one
  ulp each, count in the first only.
* Server Adam: per coordinate at its step function's bound (as
  ``tests/test_torch_server_opt.py``), plus one bf16 ulp of the param for
  the final rounding.  At bf16 the mean deltas it steps on differ by bf16
  ulps of the client weights, and, by round 3 at lr 0.1, by as much as
  the delta itself at the odd embedding coordinate that the clients'
  steps from Adam-moved weights carry apart; the bound takes each
  coordinate's measured difference.
* Inside the port: the fused and the extract client phases agree to the
  bit at bf16, as at f32; ``convert`` and the checkpoints carry bf16 bit
  for bit.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as ref_api  # noqa: E402
from repro.checkpoint import checkpoint as ref_ckpt  # noqa: E402
from repro.configs.base import SubmodelConfig as RefSubmodelConfig  # noqa
from repro.configs.base import get_reduced_config as ref_reduced  # noqa: E402
from repro.core.fedavg import dense_client_masks as ref_masks  # noqa: E402
from repro.data.synthetic import lm_batches as ref_lm_batches  # noqa: E402
from repro.kernels import dispatch as ref_dispatch  # noqa: E402
from repro.kernels import masked_update as ref_pallas  # noqa: E402
from repro.kernels.rolling_matmul import (  # noqa: E402
    rolling_matmul as ref_rmm, rolling_matmul_multi as ref_rmm_multi)
from repro.kernels.rolling_matmul_batched import (  # noqa: E402
    rolling_matmul_batched as ref_rmm_b,
    rolling_matmul_batched_dx as ref_rmm_b_dx,
    rolling_matmul_batched_dx_multi as ref_rmm_b_dx_multi,
    rolling_matmul_batched_multi as ref_rmm_b_multi)
from repro.kernels.rolling_matmul_bwd import (  # noqa: E402
    rolling_matmul_dx as ref_rmm_dx,
    rolling_matmul_dx_multi as ref_rmm_dx_multi)
from repro.models import build_model as ref_build  # noqa: E402
from repro.models.attention import \
    blockwise_attention as ref_blockwise  # noqa: E402
from repro.models.attention import \
    decode_attention as ref_decode_attention  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch.checkpoint import checkpoint  # noqa: E402
from repro_torch.configs.base import (SubmodelConfig,  # noqa: E402
                                      get_config, get_reduced_config,
                                      list_archs)
from repro_torch.core.trainer import _to_device  # noqa: E402
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.kernels.masked_update import (fillin_agg_,  # noqa: E402
                                               masked_sgd_, sgd_)
from repro_torch.kernels.rolling_matmul import (make_offsets,  # noqa: E402
                                                rolling_matmul,
                                                rolling_mm_dx, rolling_mm_fwd)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import build_params  # noqa: E402
from repro_torch.models.attention import (blockwise_attention,  # noqa: E402
                                          decode_attention)

BF = torch.bfloat16
ROUNDS, S, C = 3, 32, 4
SCFG = dict(scheme="rolling", capacity=0.5, local_steps=2,
            clients_per_round=C, client_lr=0.1,
            axes=("d_ff", "heads", "kv_heads"))
ADAM_LR, ADAM_B1, ADAM_B2, ADAM_EPS = 0.1, 0.9, 0.99, 1e-6
LOSS_ATOL = 5e-3
CAP = 2e-2          # the reference's bf16 rtol and atol
# rounds: the params' change against the reference's (_delta_gaps)
DELTA_ALL, DELTA_LEAF, LEAF_MOVED = 0.15, 0.4, 1000


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


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _ulp(b):
    """One bf16 ulp of each element of ``b`` (float32 numpy): 2^-7 of the
    power of two at or below its magnitude; 0 at 0."""
    m, e = np.frexp(b)
    return np.where(m == 0, 0.0, np.ldexp(1.0, e - 8)).astype(np.float32)


def _within_ulp(got, want, slack=0.0):
    got, want = _f32(got), _f32(want)
    d = np.abs(got - want)
    bound = _ulp(want) + slack * np.abs(want).max()
    assert (d <= bound).all(), float((d - bound).max())


def _close_to_max(got, want, what=""):
    """Within 2e-2 of the tensor's largest magnitude plus 2e-2 of each
    element's."""
    got, want = _f32(got), _f32(want)
    bound = CAP * np.abs(want).max() + CAP * np.abs(want)
    assert (np.abs(got - want) <= bound).all(), (
        what, float((np.abs(got - want) - bound).max()))


def _bits16(t):
    return t.contiguous().view(torch.int16)


# -- the plain versions of rows 9-11 against the Pallas bodies ----------------


def _update_data(seed, shape=(16, 1024), clients=4):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    m = (rng.random(shape) < 0.5).astype(np.float32)
    wc = (w[None] + 0.1 * rng.standard_normal((clients, *shape))).astype(
        np.float32)
    mc = (rng.random((clients, *shape)) < 0.5).astype(np.float32)
    b = [jnp.asarray(a, jnp.bfloat16) for a in (w, g, m, wc, mc)]
    return b, [convert.as_torch(np.asarray(a)) for a in b]


@pytest.mark.parametrize("kind", ["sgd", "masked_sgd", "fillin_c3",
                                  "fillin_c4"])
def test_plain_updates_match_pallas_bodies_at_bf16(kind):
    """Rows 9-11 at bf16: the port's plain versions (what the bf16 CUDA
    arms are held to bit for bit on the card) against the reference's
    Pallas bodies in interpret mode, within one bf16 ulp."""
    # (the module docstring: plus 1e-6 of the largest magnitude)
    clients = 3 if kind == "fillin_c3" else 4
    (w, g, m, wc, mc), (tw, tg, tm, twc, tmc) = _update_data(
        len(kind), clients=clients)
    lr = 0.05
    if kind == "sgd":
        want = ref_pallas.sgd_2d(w, g, lr, interpret=True)
        got = sgd_(tw.clone(), tg, lr)
    elif kind == "masked_sgd":
        want = ref_pallas.masked_sgd_2d(w, m, g, lr, interpret=True)
        got = masked_sgd_(tw.clone(), tm, tg, lr)
    else:
        want = ref_pallas.fillin_agg_2d(w, wc, mc, 0.5 / clients,
                                        interpret=True)
        got = fillin_agg_(tw.clone(), twc, tmc, 0.5)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    _within_ulp(got, want, 1e-6)


# -- the plain versions of rows 1-8 --------------------------------------------


def _mm_data(shape, T, seed=0):
    c, m, k, n, win = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c, m, k)).astype(np.float32)
    ws = rng.standard_normal((T, c, k, n)).astype(np.float32)
    dys = rng.standard_normal((T, c, m, win)).astype(np.float32)
    b = [jnp.asarray(a, jnp.bfloat16) for a in (x, ws, dys)]
    return b, [convert.as_torch(np.asarray(a)) for a in b]


@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("form", ["scalar", "batched"])
@pytest.mark.parametrize("kind", ["fwd", "dx"])
def test_plain_products_match_pallas_kernels_at_bf16(kind, form, T):
    """Rows 1-8 at bf16 against the reference's Pallas kernels in
    interpret mode (block-aligned offsets, which the TPU kernels need):
    ``rolling_matmul``/``_multi``, ``rolling_matmul_dx``/``_dx_multi`` on
    one model, the ``rolling_matmul_batched`` family per client."""
    c, m, k, n, win = (1 if form == "scalar" else 3), 64, 96, 192, 64
    offs = [64] if form == "scalar" else [0, 64, 128]
    (x, ws, dys), (tx, tws, tdys) = _mm_data((c, m, k, n, win), T)
    blocks = dict(bm=32, bn=32, bk=32, interpret=True)
    o = make_offsets(offs, "cpu")
    if kind == "fwd":
        got = rolling_mm_fwd(tx, list(tws), o, win)
        if form == "scalar":
            want = ([ref_rmm(x[0], ws[0, 0], offs[0], win, **blocks)[None]]
                    if T == 1 else
                    list(ref_rmm_multi(x[0], ws[:, 0], offs[0], win,
                                       **blocks)[:, None]))
        else:
            oj = jnp.asarray(offs, jnp.int32)
            want = ([ref_rmm_b(x, ws[0], oj, win, **blocks)] if T == 1 else
                    list(jnp.moveaxis(ref_rmm_b_multi(x, ws, oj, win,
                                                      **blocks), 1, 0)))
    else:
        got = [rolling_mm_dx(list(tdys), list(tws), o, win)]
        if form == "scalar":
            want = [(ref_rmm_dx(dys[0, 0], ws[0, 0], offs[0], win, **blocks)
                     if T == 1 else
                     ref_rmm_dx_multi(dys[:, 0], ws[:, 0], offs[0], win,
                                      **blocks))[None]]
        else:
            oj = jnp.asarray(offs, jnp.int32)
            want = [ref_rmm_b_dx(dys[0], ws[0], oj, win, **blocks) if T == 1
                    else ref_rmm_b_dx_multi(jnp.moveaxis(dys, 0, 1), ws, oj,
                                            win, **blocks)]
    for a, b in zip(got, want):
        assert a.dtype == BF and b.dtype == jnp.bfloat16
        _within_ulp(a, b, 1e-6)


@pytest.mark.parametrize("offset", [64, 37], ids=["aligned", "odd"])
def test_plain_products_and_vjp_match_dispatch_jnp_arm_at_bf16(offset):
    """One model's windowed product at bf16 and its VJP (dx, and dW as a
    window of zeros) against ``dispatch.rolling_matmul``'s jnp arm, at an
    aligned and an odd offset (the port's kernels take any offset)."""
    m, k, n, win = 48, 80, 160, 56
    (x, ws, dys), (tx, tws, tdys) = _mm_data((1, m, k, n, win), 1, seed=5)
    xj, wj, dyj = x[0], ws[0, 0], dys[0, 0]
    y, vjp = jax.vjp(lambda a, b: ref_dispatch.rolling_matmul(
        a, b, offset, win, backend="jnp"), xj, wj)
    want_dx, want_dw = vjp(dyj)
    txl = tx[0].clone().requires_grad_()
    twl = tws[0, 0].clone().requires_grad_()
    (got,) = rolling_matmul(txl, [twl], offset, win)
    got_dx, got_dw = torch.autograd.grad(got, [txl, twl], tdys[0, 0])
    for a, b in ((got, y), (got_dx, want_dx), (got_dw, want_dw)):
        assert a.dtype == BF and b.dtype == jnp.bfloat16
        _within_ulp(a, b, 1e-6)
    assert not got_dw[:, :offset].any() and not got_dw[:, offset + win:].any()


def test_products_refuse_mixed_dtypes():
    (_, _, _), (tx, tws, tdys) = _mm_data((2, 8, 16, 32, 8), 2)
    o = make_offsets([0, 8], "cpu")
    with pytest.raises(TypeError, match="one dtype"):
        rolling_mm_fwd(tx, [tws[0].float()], o, 8)
    with pytest.raises(TypeError, match="one dtype"):
        rolling_mm_fwd(tx.float(), [tws[0], tws[1].float()], o, 8)
    with pytest.raises(ValueError):
        rolling_mm_dx([tdys[0], tdys[1].float()], list(tws), o, 8)
    with pytest.raises(TypeError, match="one dtype"):
        sgd_(torch.zeros(8, dtype=BF), torch.zeros(8), 0.1)
    with pytest.raises(TypeError, match="one dtype"):
        fillin_agg_(torch.zeros(8, dtype=BF), torch.zeros(2, 8, dtype=BF),
                    torch.zeros(2, 8), 1.0)


# -- the attention repair ------------------------------------------------------


def _attention_inputs(seed, B=2, Sq=128, Sk=128, H=4, KV=2, hd=64):
    """bf16 q, k, v whose scores reach about 20 in magnitude: rounded to
    bf16 (8 mantissa bits), a score moves by up to 0.06 and its softmax
    weight by 6%."""
    rng = np.random.default_rng(seed)
    q = (2.5 * rng.standard_normal((B, Sq, H, hd))).astype(np.float32)
    k = (2.5 * rng.standard_normal((B, Sk, KV, hd))).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    b = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    return b, [convert.as_torch(np.asarray(a)) for a in b]


def test_blockwise_attention_sums_in_f32_at_bf16():
    """QK^T and P V summed in float32 (the reference's
    ``preferred_element_type``): the port's bf16 attention is within one
    bf16 ulp of the reference's, over 2 query and 2 key chunks of 64.
    Rounding every score and every P V partial sum to bf16 first (the
    port before this repair) misses by many ulps."""
    (q, k, v), (tq, tk, tv) = _attention_inputs(0)
    want = ref_blockwise(q, k, v, causal=True, q_chunk=64, kv_chunk=64)
    got = blockwise_attention(tq, tk, tv, causal=True, q_chunk=64,
                              kv_chunk=64)
    assert got.dtype == BF
    _within_ulp(got, want)


def test_decode_attention_sums_in_f32_at_bf16():
    (q, k, v), (tq, tk, tv) = _attention_inputs(1, Sq=1)
    valid = np.arange(128)[None].repeat(2, 0) < np.array([[100], [128]])
    want = ref_decode_attention(q[:, 0], k, v, jnp.asarray(valid))
    got = decode_attention(tq[:, 0], tk, tv, torch.as_tensor(valid))
    assert got.dtype == torch.float32
    # both float32 here: the sums in another order, each P rounded to bf16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=1e-5)


# -- the model ---------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_model():
    return ref_build(ref_reduced("tinyllama_1_1b"), remat=False,
                     param_dtype=jnp.bfloat16)


@pytest.fixture(scope="module")
def port_model():
    return build_model(get_reduced_config("tinyllama_1_1b"),
                       param_dtype=BF)


@pytest.fixture(scope="module")
def params0(ref_model):
    return _np(ref_model.init(jax.random.PRNGKey(0)))


def _port_params(params0):
    params = convert.from_reference(params0, "cpu")
    assert {v.dtype for v in params.values()} == {BF}
    return params


def test_init_draws_f32_and_rounds_once(port_model):
    """``Model(param_dtype=bf16).init`` is the float32 model's draw rounded
    once to bf16, leaf for leaf; ``abstract_params`` keeps the shapes."""
    f32 = build_model(get_reduced_config("tinyllama_1_1b"))
    a, b = port_model.init(3, device="cpu"), f32.init(3, device="cpu")
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == BF and torch.equal(_bits16(a[k]),
                                                _bits16(b[k].to(BF))), k
    assert port_model.abstract_params() == f32.abstract_params()


def _tokens(vocab, B, Sq, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, Sq)).astype(
        np.int32)


@pytest.mark.parametrize("window", [None, "d_ff", "sub-model"])
def test_model_loss_matches_reference_at_bf16(ref_model, port_model,
                                              params0, window):
    """``Model.loss`` at bf16, whole and through windowed sub-models (a
    bare d_ff window; d_ff, heads and kv_heads together), within 5e-3."""
    cfg = ref_model.cfg
    toks = _tokens(cfg.vocab, 2, 64, 1)
    if window is None:
        win = None
    elif window == "d_ff":
        win = (64, cfg.d_ff // 2)
    else:
        win = {("d_ff", cfg.d_ff): (64, cfg.d_ff // 2),
               ("heads", cfg.n_heads): (2, cfg.n_heads // 2),
               ("kv_heads", cfg.n_kv_heads): (1, cfg.n_kv_heads // 2)}
    want, _ = ref_model.loss(jax.tree_util.tree_map(jnp.asarray, params0),
                             {"tokens": jnp.asarray(toks)}, window=win)
    with torch.no_grad():
        got, _ = port_model.loss(_port_params(params0), {
            "tokens": torch.as_tensor(toks, dtype=torch.long)}, window=win)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= LOSS_ATOL


def test_windowed_grad_matches_reference_at_bf16(ref_model, port_model,
                                                 params0):
    """The sub-model loss's gradient through the d_ff window (rows 1-4 on
    the card), bf16 leaves, against ``jax.grad``; exactly 0 outside the
    window's columns of ``w_gate``."""
    cfg = ref_model.cfg
    toks = _tokens(cfg.vocab, 2, 64, 2)
    win = (64, cfg.d_ff // 2)
    want = jax.grad(lambda p: ref_model.loss(
        p, {"tokens": jnp.asarray(toks)}, window=win)[0])(
        jax.tree_util.tree_map(jnp.asarray, params0))
    params = {k: v.requires_grad_() for k, v in
              _port_params(params0).items()}
    loss, _ = port_model.loss(params, {"tokens": torch.as_tensor(
        toks, dtype=torch.long)}, window=win)
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    assert {g.dtype for g in grads.values()} == {BF}
    got = _leaves(convert.to_reference(grads))
    for path, w in _leaves(_np(want)).items():
        _close_to_max(got[path], w, str(path))
    gw = grads["layers/0/mlp/w_gate"]
    assert not gw[:, :64].any() and not gw[:, 64 + cfg.d_ff // 2:].any()


def test_prefill_and_decode_match_reference_at_bf16(ref_model, port_model,
                                                    params0):
    """Prefill 48 tokens, then 4 teacher-forced decode steps on the bf16
    cache it returns, and a step from the default (bf16) ``init_cache``:
    bf16 logits, each within 2e-2 of the largest plus 2e-2 of its own."""
    cfg = ref_model.cfg
    toks = _tokens(cfg.vocab, 2, 52, 3)
    jp = jax.tree_util.tree_map(jnp.asarray, params0)
    params = _port_params(params0)
    want, rcache = jax.jit(ref_model.prefill, static_argnames=("max_len",))(
        jp, jnp.asarray(toks[:, :48]), max_len=52)
    decode = jax.jit(ref_model.decode_step)
    t = torch.as_tensor(toks, dtype=torch.long)
    with torch.no_grad():
        got, cache = port_model.prefill(params, t[:, :48], max_len=52)
        assert got.dtype == BF and want.dtype == jnp.bfloat16
        assert {v.dtype for v in cache.values()} == {BF}
        _close_to_max(got, want, "prefill")
        for pos in range(48, 52):
            want, rcache = decode(jp, jnp.asarray(toks[:, pos]), rcache, pos)
            got, cache = port_model.decode_step(params, t[:, pos], cache,
                                                pos)
            assert got.dtype == BF
            _close_to_max(got, want, f"decode {pos}")
        want, _ = decode(jp, jnp.asarray(toks[:, 0]),
                         ref_model.init_cache(2, 16), 0)
        got, _ = port_model.decode_step(
            params, t[:, 0], port_model.init_cache(2, 16, device="cpu"), 0)
        _close_to_max(got, want, "decode from init_cache")


@pytest.mark.parametrize("arch", list_archs())
def test_every_arch_builds_at_bf16(arch):
    """Every architecture of the zoo takes bf16 params: the reduced
    model's params drawn in bf16, shaped as its ``abstract_params``, as
    many elements as the reference's bf16 ``abstract_params``, every one
    of which is bf16; the full config's params on the ``meta`` device
    bf16 too."""
    model = build_model(get_reduced_config(arch), param_dtype=BF)
    params = model.init(0, device="cpu")
    assert {v.dtype for v in params.values()} == {BF}
    assert {k: v.shape for k, v in params.items()} == \
        model.abstract_params()
    want = jax.tree_util.tree_leaves(ref_build(
        ref_reduced(arch), param_dtype=jnp.bfloat16).abstract_params())
    assert {str(a.dtype) for a in want} == {"bfloat16"}
    assert sum(math.prod(a.shape) for a in want) == \
        sum(v.numel() for v in params.values())
    full, _ = build_params(get_config(arch), 0, "meta", BF)
    assert {v.dtype for v in full.values()} == {BF}


def test_param_dtype_takes_float32_or_bfloat16():
    cfg = get_reduced_config("tinyllama_1_1b")
    with pytest.raises(ValueError, match="param_dtype"):
        build_model(cfg, param_dtype=torch.float64)
    assert build_model(get_reduced_config("qwen3_14b"),
                       param_dtype=BF).param_dtype == BF


# -- rounds against the reference ------------------------------------------------


@pytest.fixture(scope="module")
def reference_runs(ref_model, params0):
    """The reference's bf16 rounds: 3 window rounds on its extract arm, 3
    Bernoulli mask rounds (plain and with client momentum), and 3 server
    Adam window rounds one at a time through its Trainer, with what the
    port must inject and (Adam) the params and state before each round."""
    model = ref_model
    it = ref_lm_batches(model.cfg.vocab, (2, C, 2), S, seed=0)
    batches = [next(it) for _ in range(ROUNDS)]
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    runs = {}
    fed = ref_api.fed_round(model, RefSubmodelConfig(**SCFG),
                            kernel_backend="jnp", fused_forward="off")
    trainer = ref_api.Trainer(fed, jax.tree_util.tree_map(jnp.asarray,
                                                          params0), rng=1)
    params, history = trainer.run(iter(jb), ROUNDS)
    runs["window"] = dict(
        params=_np(params),
        injected=[{"offsets": {k: [int(o) for o in np.asarray(v)] for k, v
                               in fed.scheme.offsets(None, r, C).items()}}
                  for r in range(ROUNDS)],
        client_loss=[np.asarray(h["client_loss"]) for h in history])
    for name, kw in (("mask", {}), ("mask_momentum",
                                    dict(client_opt="momentum"))):
        scfg = RefSubmodelConfig(**{**SCFG, "scheme": "bernoulli"})
        fed = ref_api.fed_round(model, scfg, mode="mask",
                                kernel_backend="jnp", **kw)
        step = jax.jit(fed.round)
        key = jax.random.PRNGKey(1)
        params = jax.tree_util.tree_map(jnp.asarray, params0)
        injected, losses = [], []
        for r in range(ROUNDS):
            key, sub = jax.random.split(key)
            injected.append({"masks": _np(ref_masks(
                sub, model.abstract_params(), model.axes(), scfg,
                fed.capacities, r))})
            params, metrics = step(params, jb[r], r, sub)
            losses.append(np.asarray(metrics["client_loss"]))
        runs[name] = dict(params=_np(params), injected=injected,
                          client_loss=losses)
    fed = ref_api.fed_round(model, RefSubmodelConfig(**SCFG),
                            kernel_backend="jnp", server_opt="adam")
    trainer = ref_api.Trainer(fed, jax.tree_util.tree_map(jnp.asarray,
                                                          params0), rng=1)
    before, injected = [], []
    for r in range(ROUNDS):
        injected.append({"offsets": {
            k: [int(o) for o in np.asarray(v)] for k, v in
            fed.scheme.offsets(None, r, C).items()}})
        before.append((_np(trainer.params), _np(trainer.opt_state)))
        trainer.run(iter([jb[r]]), 1)
    before.append((_np(trainer.params), _np(trainer.opt_state)))
    runs["adam"] = dict(before=before, injected=injected,
                        client_loss=[np.asarray(h["client_loss"])
                                     for h in trainer.history])
    return dict(batches=batches, runs=runs)


def _inject(inj):
    if "masks" in inj:
        return {"masks": convert.from_reference(inj["masks"], "cpu", lead=1)}
    return inj


def _delta_gaps(got, want, p0):
    """``|got - want| / |want - p0|`` (Euclidean norms, float32 numpy
    leaves by path) over all leaves together, and the largest over the
    leaves that ``want`` moved in LEAF_MOVED elements or more: how far
    ``got`` lies from ``want`` against how far ``want`` moved.  A ``got``
    that did not move from ``p0`` reads 1 in both."""
    num = den = 0.0
    leaf = 0.0
    for path, w in want.items():
        d2 = float(np.sum((got[path] - w) ** 2, dtype=np.float64))
        r2 = float(np.sum((w - p0[path]) ** 2, dtype=np.float64))
        num, den = num + d2, den + r2
        if np.count_nonzero(w != p0[path]) >= LEAF_MOVED:
            leaf = max(leaf, math.sqrt(d2 / r2))
    return math.sqrt(num / den), leaf


def _check_run(trainer, run, name, params0):
    for r, h in enumerate(trainer.history):
        np.testing.assert_allclose(h["client_loss"].numpy(),
                                   run["client_loss"][r], atol=CAP, rtol=0,
                                   err_msg=f"{name} round {r}")
        assert np.isfinite(h["client_loss"].numpy()).all()
    assert {v.dtype for v in trainer.params.values()} == {BF}
    got = _leaves(convert.to_reference(trainer.params))
    want = {k: _f32(v) for k, v in _leaves(run["params"]).items()}
    p0 = {k: _f32(v) for k, v in _leaves(params0).items()}
    every, leaf = _delta_gaps(got, want, p0)
    assert every <= DELTA_ALL and leaf <= DELTA_LEAF, (name, every, leaf)
    # the same check fails rounds that left the params where they were
    assert min(_delta_gaps(p0, want, p0)) > DELTA_LEAF


@pytest.mark.parametrize("case", [
    ("window", "window", dict(fused_forward="on")),
    ("window", "window", dict(fused_forward="off")),
    ("mask", "mask", {}),
    ("mask_momentum", "mask", dict(client_opt="momentum")),
], ids=["fused", "extract", "mask", "mask_momentum"])
def test_three_bf16_rounds_match_reference(reference_runs, port_model,
                                           params0, case):
    """Three rounds from the reference's bf16 params, on its offsets or
    masks: the fused and the extract window rounds against the
    reference's extract arm, the Bernoulli mask round plain and with
    client momentum (float32 velocity); params stay bf16, and their
    change from the start within DELTA_ALL and DELTA_LEAF of the
    reference's (:func:`_delta_gaps`)."""
    name, mode, kw = case
    run = reference_runs["runs"][name]
    scheme = "bernoulli" if mode == "mask" else "rolling"
    fed = api.fed_round(port_model, SubmodelConfig(**{**SCFG,
                                                      "scheme": scheme}),
                        mode=mode, device="cpu", **kw)
    if mode == "window":
        assert fed.use_fused == (kw["fused_forward"] == "on")
    trainer = api.Trainer(fed, _port_params(params0))
    trainer.run(((b, _inject(i)) for b, i in
                 zip(reference_runs["batches"], run["injected"])), ROUNDS)
    _check_run(trainer, run, name, params0)


def _mean_delta(m_after, m_before):
    return (m_after - ADAM_B1 * m_before) / (1 - ADAM_B1)


def test_server_adam_bf16_rounds_within_step_bound(reference_runs,
                                                   port_model):
    """Each server Adam round from the reference's bf16 params and float32
    state before it: the state stays float32 and the params bf16; the
    client losses within rtol = atol = 2e-2; every param within ``2 lr dd
    / (sqrt(v_hat) + eps)`` of the reference's, ``dd`` the measured
    difference of the mean delta (read back from the first moment), plus
    one bf16 ulp for the rounding into the param."""
    ref, run = reference_runs, reference_runs["runs"]["adam"]
    fed = api.fed_round(port_model, SubmodelConfig(**SCFG), device="cpu",
                        server_opt="adam")
    for r in range(ROUNDS):
        (p0, s0), (p1, s1) = run["before"][r], run["before"][r + 1]
        state = {"m": convert.from_reference(s0["m"], "cpu"),
                 "v": convert.from_reference(s0["v"], "cpu"),
                 "t": int(s0["t"])}
        batch = {k: _to_device(v, fed.device)
                 for k, v in ref["batches"][r].items()}
        params, state, metrics = fed.round_with_server_opt(
            convert.from_reference(p0, "cpu"), state, batch, r,
            **run["injected"][r])
        assert {v.dtype for v in params.values()} == {BF}
        assert {v.dtype for v in state["m"].values()} == {torch.float32}
        np.testing.assert_allclose(metrics["client_loss"].numpy(),
                                   run["client_loss"][r], atol=CAP,
                                   rtol=CAP)
        got = _leaves(convert.to_reference(params))
        m_port = _leaves(convert.to_reference(state["m"]))
        m_ref, m_prev, v_ref = (_leaves(s1["m"]), _leaves(s0["m"]),
                                _leaves(s1["v"]))
        for path, want in _leaves(p1).items():
            d_ref = _mean_delta(m_ref[path], m_prev[path])
            dd = np.abs(_mean_delta(m_port[path], m_prev[path]) - d_ref)
            v_hat = v_ref[path] / (1 - ADAM_B2 ** (r + 1))
            want = _f32(want)
            bound = (2 * ADAM_LR * dd / (np.sqrt(v_hat) + ADAM_EPS)
                     + _ulp(np.maximum(np.abs(want), np.abs(got[path]))))
            assert (np.abs(got[path] - want) <= bound).all(), (r, path)


@pytest.mark.parametrize("over", [{}, dict(d_ff=768, n_kv_heads=2)],
                         ids=["reduced", "d_ff768_kv2"])
def test_fused_equals_extract_to_the_bit_at_bf16(over):
    """At bf16 the fused client phase (full copies through the windowed
    products' plain versions) and the extract phase (compact copies
    through the model's ordinary products) agree bit for bit, 3 rolling
    rounds: both sum every product in float32 on widened operands and
    round once (``models.layers.bmm``)."""
    cfg = dataclasses.replace(get_reduced_config("tinyllama_1_1b"), **over)
    model = build_model(cfg, param_dtype=BF)
    it = lm_batches(cfg.vocab, (2, C, 2), S, seed=0)
    batches = [next(it) for _ in range(ROUNDS)]
    out = {}
    for ff in ("on", "off"):
        fed = api.fed_round(model, SubmodelConfig(**SCFG), fused_forward=ff,
                            device="cpu")
        trainer = api.Trainer(fed, model.init(0, device="cpu"))
        trainer.run(iter(batches), ROUNDS)
        out[ff] = trainer
    for a, b in zip(out["on"].history, out["off"].history):
        assert torch.equal(a["client_loss"], b["client_loss"])
    for k, v in out["on"].params.items():
        assert v.dtype == BF
        assert torch.equal(_bits16(v), _bits16(out["off"].params[k])), k


def test_tiny_lr_bf16_mask_round_moves_params():
    """The reference's ``test_bf16_tiny_lr_mask_round_moves_params`` on
    the port: at client lr 1e-3 the clients' changes are below a bf16 ulp
    of most weights, and the fill-in, which keeps the delta in float32
    and rounds once, still moves the params; finite and bf16."""
    g = torch.Generator().manual_seed(0)
    params = {"w1": (torch.randn(16, 32, generator=g) * 0.3).to(BF),
              "w2": (torch.randn(32, generator=g) * 0.3).to(BF)}
    axes = {"w1": ("d_model", "d_ff"), "w2": ("d_ff",)}

    def loss(w, b):
        h = torch.tanh(torch.bmm(b["x"], w["w1"].float()))
        r = torch.bmm(h, w["w2"].float()[..., None])[..., 0] - b["y"]
        return 0.5 * (r * r).mean(-1), {}

    rng = np.random.default_rng(0)
    batch = {"x": torch.as_tensor(rng.standard_normal((2, 4, 8, 16)),
                                  dtype=torch.float32),
             "y": torch.as_tensor(rng.standard_normal((2, 4, 8)),
                                  dtype=torch.float32)}
    scfg = SubmodelConfig(scheme="bernoulli", capacity=0.5, local_steps=2,
                          clients_per_round=4, client_lr=1e-3)
    fed = api.fed_round((loss, {k: v.shape for k, v in params.items()},
                         axes), scfg, mode="mask", device="cpu")
    before = {k: v.clone() for k, v in params.items()}
    new, metrics = fed.round(params, batch, 0,
                             generator=torch.Generator().manual_seed(7))
    assert np.isfinite(float(metrics["loss"]))
    assert all(v.dtype == BF and torch.isfinite(v.float()).all()
               for v in new.values())
    assert sum(int((new[k] != before[k]).sum()) for k in new) > 0


# -- convert and checkpoints -------------------------------------------------------


def test_convert_carries_bf16_bit_for_bit(params0):
    """Reference bf16 params -> the port (an int16 view of the bits) ->
    back (float32, exact), rounded again by ``jnp.bfloat16``: the same
    bits."""
    port = convert.from_reference(params0, "cpu")
    back = convert.to_reference(port)
    for path, want in _leaves(params0).items():
        got = _leaves(back)[path]
        assert got.dtype == np.float32
        np.testing.assert_array_equal(
            np.asarray(jnp.asarray(got, jnp.bfloat16)).view(np.uint16),
            want.view(np.uint16), err_msg=str(path))


def _ref_tree():
    """The reference's own round-trip tree
    (``tests/test_substrate.py::test_checkpoint_roundtrip``)."""
    return {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
            "b": {"c": jnp.ones((4,), jnp.bfloat16) * 1.2345,
                  "d": jnp.asarray(3, jnp.int32)},
            "opt": (jnp.zeros(2), jnp.ones(2))}


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
    assert a.tobytes() == b.tobytes()


def test_checkpoints_of_any_tree_load_in_the_other_package(tmp_path):
    """The reference's round-trip tree (a bf16 entry, an int32 scalar, a
    tuple of optimizer state) saved by each package loads in the other,
    bit for bit; the port holds it as flat dicts and tuples."""
    tree = _ref_tree()
    ref_ckpt.save(str(tmp_path / "ref.npz"), tree, {"round": 7})
    port, meta = checkpoint.load(str(tmp_path / "ref.npz"), device="cpu")
    assert meta["round"] == 7 and set(port) == {"a", "b/c", "b/d", "opt"}
    assert port["b/c"].dtype == BF and port["b/d"].dtype == torch.int32
    assert isinstance(port["opt"], tuple) and len(port["opt"]) == 2
    _same_bits(port["b/c"].view(torch.int16).numpy(),
               np.asarray(tree["b"]["c"]).view(np.uint16))
    checkpoint.save(str(tmp_path / "port.npz"), port, {"round": 8})
    back, meta = ref_ckpt.load(str(tmp_path / "port.npz"))
    assert meta["round"] == 8 and meta["dtypes"]["b/c"] == "bfloat16"
    assert back["b"]["c"].dtype.name == "bfloat16"
    for path, want in _leaves(tree).items():
        _same_bits(_leaves(back)[path], want)
    assert isinstance(back["opt"], tuple)


def test_bf16_params_and_adam_state_checkpoint_round_trip(tmp_path,
                                                          port_model):
    """A bf16 model's params beside float32 Adam state and a step count,
    through the port's save and the reference's load and back."""
    params = port_model.init(1, device="cpu")
    state = {"m": {k: torch.randn(v.shape) for k, v in params.items()},
             "t": torch.tensor(3, dtype=torch.int32)}
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, {"params": params, "opt": (state["m"],
                                                     state["t"])})
    tree, meta = ref_ckpt.load(path)
    assert tree["params"]["layers"]["mlp"]["w_gate"].dtype.name == \
        "bfloat16"
    port, _ = checkpoint.load(path, device="cpu")
    for k, v in params.items():
        assert torch.equal(_bits16(port[f"params/{k}"]), _bits16(v)), k
    m, t = port["opt"]
    assert int(t) == 3 and all(torch.equal(m[k], state["m"][k]) for k in m)
    # the port's params alone load back as its params
    checkpoint.save(path, params, {"round": 2})
    again, meta = checkpoint.load(path, device="cpu")
    assert meta["round"] == 2 and again.keys() == params.keys()
    assert all(torch.equal(_bits16(again[k]), _bits16(params[k]))
               for k in params)


def test_math_ulp_helper():
    """``_ulp`` is one bf16 ulp: 1.0 -> 2^-7, 1.5 -> 2^-7, 3.0 -> 2^-6."""
    got = _ulp(np.array([1.0, 1.5, 3.0, 0.0, -0.75], np.float32))
    np.testing.assert_array_equal(
        got, [2.0 ** -7, 2.0 ** -7, 2.0 ** -6, 0.0, 2.0 ** -8])
    assert math.isclose(float(_ulp(np.float32(1.0))), 2 ** -7)


# -- the other round arms at bf16 -------------------------------------------------


ARMS = {
    "stagger": (dict(stagger=True), {}),
    "random": (dict(scheme="random"), {}),
    "importance": (dict(scheme="importance"), {}),
    "hetero": ({}, dict(capacities=[1.0, 0.5, 0.25, 0.125])),
    "server_momentum": ({}, dict(server_opt="momentum")),
    "uplink_bf16": ({}, dict(uplink_compression="bf16")),
    "proximal": ({}, dict(client_opt="proximal")),
    "full": (dict(scheme="full"), {}),
    "mask_rolling_hetero": ({}, dict(mode="mask",
                                     capacities=[1.0, 0.5, 0.5, 0.25])),
    "mask_adam": (dict(scheme="bernoulli"), dict(server_opt="adam")),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_every_round_arm_keeps_bf16_params(port_model, arm):
    """Per-client windows, hetero buckets, the other optimizers, the bf16
    uplink, scheme ``full`` and the structured mask round, one round each
    on bf16 params: the params stay bf16 and move, the losses finite."""
    over, kw = ARMS[arm]
    fed = api.fed_round(port_model, SubmodelConfig(**{**SCFG, **over}),
                        device="cpu", **kw)
    params = port_model.init(0, device="cpu")
    before = {k: v.clone() for k, v in params.items()}
    batch = next(lm_batches(port_model.cfg.vocab, (2, C, 2), S, seed=1))
    trainer = api.Trainer(fed, params, rng=0)
    trainer.run(iter([batch]), 1)
    assert np.isfinite(trainer.losses).all()
    assert {v.dtype for v in trainer.params.values()} == {BF}
    assert any(not torch.equal(trainer.params[k], before[k]) for k in before)


@pytest.mark.parametrize("arm", ["stagger", "hetero"])
def test_per_client_fused_equals_extract_to_the_bit_at_bf16(port_model, arm):
    """Per-client windows and hetero buckets at bf16: the fused and the
    extract client phases give the same round bit for bit, as at f32."""
    over, kw = ARMS[arm]
    batch = next(lm_batches(port_model.cfg.vocab, (2, C, 2), S, seed=2))
    out = []
    for ff in ("on", "off"):
        fed = api.fed_round(port_model, SubmodelConfig(**{**SCFG, **over}),
                            device="cpu", fused_forward=ff, **kw)
        trainer = api.Trainer(fed, port_model.init(0, device="cpu"))
        trainer.run(iter([batch]), 1)
        out.append(trainer)
    assert torch.equal(out[0].history[0]["client_loss"],
                       out[1].history[0]["client_loss"])
    for k, v in out[0].params.items():
        assert torch.equal(_bits16(v), _bits16(out[1].params[k])), k
