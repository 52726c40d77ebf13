"""The port's kernels held against the JAX reference and against their
plain versions.

On the CPU every wrapper runs its plain PyTorch version (``kernels.ref``);
those are held against the reference's jnp arms (``repro.kernels.ref`` and
``repro.kernels.dispatch`` with ``backend="jnp"``), values and ``jax.vjp``
gradients.  Tolerance: float32, atol 1e-5 and rtol 1e-5 -- the two
frameworks sum the products of a matmul in different orders, which moves
results by a few ulp at these contraction lengths (<= 200).

The masked SGD step and the fill-in average round their product and
their sum separately (the Pallas bodies' ``p - lr * m * g`` and ``w +
scale * acc``), as the port's plain versions and CUDA kernels do.  XLA's
CPU backend contracts each of those into one fused multiply-add, so the
reference's interpret-mode Pallas bodies and jnp arms round once where
the port rounds twice; and the fill-in's jnp arm divides the client sum
by C where the Pallas body multiplies by ``server_lr / C``.  Tolerance
there: 2 ulp of the product term plus 1 ulp of the result
(:func:`_close_fma`); bit-exact where the product is exact (the fill-in
at C = 2^k, whose products are by 0, 1 and powers of two).

The ``gpu`` tests launch the CUDA kernels and hold them against the plain
versions on the card; they decide inside the test whether a card is
present and skip without one.  They need no JAX, so they also run where
JAX is not installed, without the repository's conftest (which imports
it)::

    PYTHONPATH=src python -m pytest --noconftest -m gpu \
        tests/test_torch_kernels.py
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.masked_update import (fillin_agg_,  # noqa: E402
                                               masked_sgd_, sgd_)
from repro_torch.kernels.ref import (fillin_agg_ref,  # noqa: E402
                                     masked_sgd_ref,
                                     rolling_matmul_batched_dx_ref,
                                     rolling_matmul_batched_ref, sgd_ref,
                                     window_columns)
from repro_torch.kernels.rolling_matmul import (block_tile,  # noqa: E402
                                                make_offsets,
                                                rolling_matmul,
                                                rolling_matmul_batched,
                                                rolling_mm_dx, rolling_mm_fwd)

ATOL = RTOL = 1e-5

C, M, K, N, WIN = 3, 24, 40, 96, 32
# per-client offsets: block-aligned, unaligned, and the exact tail N - WIN
OFFSETS = {"aligned": [0, 32, 64], "unaligned": [5, 37, 64]}


def _data(T, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, M, K)).astype(np.float32)
    ws = [rng.standard_normal((C, K, N)).astype(np.float32)
          for _ in range(T)]
    dys = [rng.standard_normal((C, M, WIN)).astype(np.float32)
           for _ in range(T)]
    return x, ws, dys


@pytest.fixture(scope="module")
def jx():
    """The JAX reference's oracles, imported at test time so that the
    ``gpu`` tests run where JAX is not installed."""
    jax = pytest.importorskip("jax")
    from repro.kernels import dispatch, masked_update, ref
    return SimpleNamespace(jax=jax, jnp=jax.numpy, dispatch=dispatch, ref=ref,
                           pallas=masked_update)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("kind", sorted(OFFSETS))
def test_rolling_fwd_matches_reference_oracle(jx, kind):
    x, (w,), _ = _data(1)
    offs = OFFSETS[kind]
    want = jx.jax.vmap(jx.ref.rolling_matmul_ref, in_axes=(0, 0, 0, None))(
        jx.jnp.asarray(x), jx.jnp.asarray(w),
        jx.jnp.asarray(offs, jx.jnp.int32), WIN)
    (got,) = rolling_matmul_batched_ref(torch.tensor(x), [torch.tensor(w)],
                                        offs, WIN)
    _close(got, want)


@pytest.mark.parametrize("kind", sorted(OFFSETS))
def test_rolling_batched_values_and_vjp_match_dispatch(jx, kind):
    """T = 1, per-client offsets: the autograd Function on the CPU against
    ``dispatch.rolling_matmul_batched`` and its custom VJP."""
    x, (w,), (dy,) = _data(1, seed=1)
    offs = OFFSETS[kind]
    jnp = jx.jnp

    def f(x_, w_):
        return jx.dispatch.rolling_matmul_batched(
            x_, w_, jnp.asarray(offs, jnp.int32), WIN, backend="jnp")

    y_ref, vjp = jx.jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    dx_ref, dw_ref = vjp(jnp.asarray(dy))

    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    (y,) = rolling_matmul_batched(xt, (wt,), make_offsets(offs, "cpu"), WIN)
    y.backward(torch.tensor(dy))
    _close(y.detach(), y_ref)
    _close(xt.grad, dx_ref)
    _close(wt.grad, dw_ref)
    # outside each client's window the weight gradient is exactly zero
    for c, o in enumerate(offs):
        outside = torch.cat([wt.grad[c, :, :o], wt.grad[c, :, o + WIN:]], 1)
        assert torch.count_nonzero(outside) == 0


@pytest.mark.parametrize("kind", sorted(OFFSETS))
def test_rolling_multi_values_and_vjp_match_dispatch(jx, kind):
    """T = 2 (the gate/up pair), one shared offset, per-client weights:
    against ``dispatch.rolling_matmul_multi`` under the client vmap."""
    x, ws, dys = _data(2, seed=2)
    off = OFFSETS[kind][1]
    jnp = jx.jnp

    def f(x_, w0, w1):
        return jx.jax.vmap(lambda a, b, c: jx.dispatch.rolling_matmul_multi(
            a, (b, c), off, WIN, backend="jnp"))(x_, w0, w1)

    ys_ref, vjp = jx.jax.vjp(f, jnp.asarray(x), *map(jnp.asarray, ws))
    dx_ref, dw0_ref, dw1_ref = vjp(tuple(map(jnp.asarray, dys)))

    xt = torch.tensor(x, requires_grad=True)
    wts = [torch.tensor(w, requires_grad=True) for w in ws]
    ys = rolling_matmul_batched(xt, wts, make_offsets([off] * C, "cpu"), WIN)
    torch.autograd.backward(ys, [torch.tensor(d) for d in dys])
    for y, yr in zip(ys, ys_ref):
        _close(y.detach(), yr)
    _close(xt.grad, dx_ref)
    _close(wts[0].grad, dw0_ref)
    _close(wts[1].grad, dw1_ref)


@pytest.mark.parametrize("T", [1, 2])
def test_rolling_dx_plain_matches_reference_transpose(jx, T):
    """The dx plain version against the reference's oracle dx: the sum over
    weights of ``dy @ W[:, window]^T``, per client."""
    _, ws, dys = _data(T, seed=3)
    offs = OFFSETS["unaligned"]
    jax, jnp = jx.jax, jx.jnp

    def one(d, w_, o):
        wsub = jax.lax.dynamic_slice_in_dim(w_, o, WIN, axis=1)
        return jax.lax.dot_general(d, wsub, (((1,), (1,)), ((), ())))

    want = 0
    for dy, w in zip(dys, ws):
        want = want + jax.vmap(one)(jnp.asarray(dy), jnp.asarray(w),
                                    jnp.asarray(offs, jnp.int32))
    got = rolling_matmul_batched_dx_ref([torch.tensor(d) for d in dys],
                                        [torch.tensor(w) for w in ws], offs,
                                        WIN)
    _close(got, want)


@pytest.mark.parametrize("shape", [(4, 33, 7), (1000,), (3, 1)])
def test_sgd_plain_matches_dispatch_sgd_step(jx, shape):
    rng = np.random.default_rng(4)
    p = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    want = jx.dispatch.sgd_step({"w": jx.jnp.asarray(p)},
                                {"w": jx.jnp.asarray(g)}, 0.1,
                                backend="jnp")["w"]
    w = torch.tensor(p)
    out = sgd_(w, torch.tensor(g), 0.1)
    assert out is w                          # in place
    _close(w, want)


def _masked_data(shape, C=None, seed=5):
    """w, a 0/1 mask and g (or, with C, the clients' w_c and m_c too), with
    negative values so that signed zeros occur."""
    rng = np.random.default_rng(seed)
    lead = () if C is None else (C,)
    w = rng.standard_normal(shape).astype(np.float32)
    m = (rng.random(lead + shape) < 0.5).astype(np.float32)
    g = rng.standard_normal(lead + shape).astype(np.float32)
    return w, m, g


def _close_fma(got, want, term):
    """``got`` (two roundings) against ``want`` (XLA's one fused
    multiply-add) for an update ``x + term``: within 2 ulp of ``term``
    plus 1 ulp of the result."""
    got, want = np.asarray(got), np.asarray(want)
    tol = 2 * np.spacing(np.abs(term)) + np.spacing(np.abs(want))
    assert np.all(np.abs(got - want) <= tol), np.max(np.abs(got - want))


def _bits_equal(got, want):
    np.testing.assert_array_equal(np.asarray(got).view(np.int32),
                                  np.asarray(want).view(np.int32))


@pytest.mark.parametrize("lr", [0.1, 0.037])
def test_masked_sgd_plain_matches_pallas_and_jnp_arms(jx, lr):
    """[R, 1024] (the Pallas layout) and the jnp arm on a ragged leaf."""
    for shape in ((16, 1024), (4, 33, 7)):
        w, m, g = _masked_data(shape)
        jw, jm, jg = map(jx.jnp.asarray, (w, m, g))
        want = (jx.pallas.masked_sgd_2d(jw, jm, jg, lr, interpret=True)
                if len(shape) == 2 and shape[1] == 1024 else
                jx.dispatch.masked_sgd({"w": jw}, {"w": jm}, {"w": jg}, lr,
                                       backend="jnp")["w"])
        w_t = torch.tensor(w)
        assert masked_sgd_(w_t, torch.tensor(m), torch.tensor(g), lr) is w_t
        _close_fma(w_t.numpy(), want, np.float32(lr) * m * g)


@pytest.mark.parametrize("server_lr", [1.0, 0.5])
@pytest.mark.parametrize("C", [3, 4])
def test_fillin_plain_matches_pallas_and_jnp_arms(jx, C, server_lr):
    jnp = jx.jnp
    for shape in ((16, 1024), (5, 3, 70)):
        w, m, wc = _masked_data(shape, C=C)
        if shape[-1] == 1024:
            want = jx.pallas.fillin_agg_2d(jnp.asarray(w), jnp.asarray(wc),
                                           jnp.asarray(m), server_lr / C,
                                           interpret=True)
        else:
            want = jx.dispatch.fillin_agg(
                {"w": jnp.asarray(w)}, {"w": jnp.asarray(wc)},
                {"w": jnp.asarray(m)}, server_lr=server_lr,
                backend="jnp")["w"]
        got = fillin_agg_(torch.tensor(w), torch.tensor(wc), torch.tensor(m),
                          server_lr).numpy()
        acc = np.zeros_like(w)
        for c in range(C):
            acc += m[c] * (wc[c] - w)
        if (C & (C - 1)) == 0:       # C = 2^k: every product exact
            _bits_equal(got, want)
        else:
            _close_fma(got, want, np.float32(server_lr / C) * acc)
        ref = fillin_agg_ref(torch.tensor(w), torch.tensor(wc),
                             torch.tensor(m), server_lr / C)
        _bits_equal(ref, got)


@pytest.mark.parametrize("bad", ["float64", "shape", "noncontig", "alias",
                                 "devices"])
def test_masked_sgd_rejects_bad_operands(bad, monkeypatch):
    w, m, g = torch.zeros(6, 4), torch.ones(6, 4), torch.ones(6, 4)
    if bad == "float64":
        m = m.double()
    elif bad == "shape":
        g = torch.ones(6, 5)
    elif bad == "noncontig":
        w = torch.zeros(4, 6).mT
    elif bad == "alias":
        m = w
    elif bad == "devices":
        g = torch.ones(6, 4, device="meta")
    with pytest.raises((TypeError, ValueError)):
        masked_sgd_(w, m, g, 0.1)


@pytest.mark.parametrize("bad", ["float64", "clients", "mask_shape",
                                 "noncontig", "alias", "no_client_axis"])
def test_fillin_rejects_bad_operands(bad):
    w, wc, mc = torch.zeros(6, 4), torch.ones(3, 6, 4), torch.ones(3, 6, 4)
    if bad == "float64":
        wc = wc.double()
    elif bad == "clients":
        wc = torch.ones(3, 6, 5)
    elif bad == "mask_shape":
        mc = torch.ones(2, 6, 4)
    elif bad == "noncontig":
        wc = torch.ones(6, 3, 4).transpose(0, 1)
    elif bad == "alias":
        w = wc[1]
    elif bad == "no_client_axis":
        wc, mc = torch.ones(6, 4), torch.ones(6, 4)
    with pytest.raises((TypeError, ValueError)):
        fillin_agg_(w, wc, mc, 1.0)


def test_cpu_calls_are_not_kernel_launches():
    """On CPU tensors the wrappers run the plain versions and count no
    launch."""
    before = dict(_build.LAUNCHES)
    x, ws, dys = _data(2)
    offs = make_offsets(OFFSETS["aligned"], "cpu")
    rolling_mm_fwd(torch.tensor(x), [torch.tensor(w) for w in ws], offs, WIN)
    rolling_mm_dx([torch.tensor(d) for d in dys],
                  [torch.tensor(w) for w in ws], offs, WIN)
    sgd_(torch.zeros(8), torch.ones(8), 0.5)
    masked_sgd_(torch.zeros(8), torch.ones(8), torch.ones(8), 0.5)
    fillin_agg_(torch.zeros(8), torch.ones(2, 8), torch.ones(2, 8))
    assert dict(_build.LAUNCHES) == before


@pytest.mark.parametrize("bad", ["float64", "noncontig_x", "offset_range",
                                 "clients", "weight_rows", "three_weights"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, ws, _ = _data(1)
    xt, wt = torch.tensor(x), torch.tensor(ws[0])
    offs, win, wts = OFFSETS["aligned"], WIN, [wt]
    if bad == "float64":
        xt = xt.double()
    elif bad == "noncontig_x":
        xt = torch.tensor(np.ascontiguousarray(x.transpose(0, 2, 1))).mT
    elif bad == "offset_range":
        offs = [0, 32, N - WIN + 1]
    elif bad == "clients":
        offs = offs[:2]
    elif bad == "weight_rows":
        wts = [wt.mT.contiguous().mT]
    elif bad == "three_weights":
        wts = [wt, wt, wt]
    with pytest.raises((ValueError, TypeError)):
        rolling_mm_fwd(xt, wts, make_offsets(offs, "cpu"), win)


@pytest.mark.parametrize("overlap", ["same", "shifted"])
def test_sgd_rejects_overlapping_operands(overlap):
    """The kernel reads g through the read-only path while it writes w, so
    the two must not share memory."""
    buf = torch.zeros(12)
    w, g = (buf[:8], buf[:8]) if overlap == "same" else (buf[:8], buf[4:])
    with pytest.raises(ValueError, match="share memory"):
        sgd_(w, g, 0.1)
    assert torch.equal(buf, torch.zeros(12))


def test_sgd_rejects_mismatched_operands():
    with pytest.raises(ValueError):
        sgd_(torch.zeros(4), torch.zeros(5), 0.1)
    with pytest.raises(TypeError):
        sgd_(torch.zeros(4, dtype=torch.float64), torch.zeros(4), 0.1)


# -- on the card: the CUDA kernels against their plain versions --------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; none is present")
    return torch.device("cuda")


# f32 on both sides, different summation order: relative to the output's
# largest magnitude, a few ulp times sqrt(contraction length)
GPU_RTOL = 1e-4


def _gpu_close(a, b):
    scale = b.abs().max().clamp_min(1.0)
    assert (a - b).abs().max() <= GPU_RTOL * scale


def _tf32(a):
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, by bit mask: add half a TF32 ulp to the magnitude's bits,
    then clear the 13 low bits (the kernels' split of ``big``)."""
    bits = a.view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _tf32_trunc(a):
    """What the tensor core reads of f32 bits: the 13 low bits dropped
    (the kernels pass ``small`` so)."""
    return (a.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_product(a, b, passes):
    """``a @ b`` as the product kernels compute it: for each 32-deep stage
    of the contraction, the TF32 products summed on the tensor core (here
    exactly) and added to an f32 accumulator, rounded to nearest.
    ``passes`` 3: the split ``a = big + small`` with the small products
    first; 1: one TF32 pass."""
    ab, bb = _tf32(a), _tf32(b)
    a_s, b_s = _tf32_trunc(a - ab), _tf32_trunc(b - bb)
    terms = [(a_s, bb), (ab, b_s), (ab, bb)] if passes == 3 else [(ab, bb)]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 32):
        acc += sum(p[:, k:k + 32].astype(np.float64)
                   @ q[k:k + 32].astype(np.float64)
                   for p, q in terms).astype(np.float32)
    return acc


@pytest.mark.parametrize("K", [2048, 2 * 2816])
def test_3xtf32_split_keeps_f32_accuracy(K):
    """The numerics the product kernels rely on, emulated on the CPU at the
    main path's contraction lengths (d_model, and the gate/up pair's dx
    over two windows of 2816): the 3xTF32 split stays within a tenth of
    the card tolerance of an f64 product, relative to the largest output;
    one TF32 pass misses the tolerance itself."""
    rng = np.random.default_rng(K)
    a = rng.standard_normal((32, K)).astype(np.float32)
    b = rng.standard_normal((K, 32)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(want).max()
    err3 = np.abs(_tf32_product(a, b, 3) - want).max() / scale
    err1 = np.abs(_tf32_product(a, b, 1) - want).max() / scale
    assert err3 <= GPU_RTOL / 10
    assert err1 > GPU_RTOL


# (C, M, K, N, win, per-client offsets).  The first two are ragged (an odd
# row stride N = 777, offsets that are not multiples of 4: 4-byte copies);
# the rest are the main path's shapes, which select each block tile on a
# 132-SM H100: the k/v projection (win 128 of 256: 64 x 32 forward, 128 x
# 128 dx), the q projection (128 x 64 forward), row 4's C = 1, M = 512 (64 x
# 64 dx) and row 2's C = 1, M = 8192 (128 x 128), with offsets that are and
# are not multiples of 4.
GPU_SHAPES = [
    (C, M, K, N, WIN, [0, 17, 34]),
    (4, 300, 1000, 777, 333, [0, 17, 34, 51]),
    (4, 512, 2048, 256, 128, [128, 37, 0, 5]),
    (4, 512, 2048, 2048, 1024, [1024, 3, 1024, 1020]),
    (1, 512, 2048, 5632, 2816, [2816]),
    (1, 8192, 2048, 5632, 2816, [1]),
    # the SSM rounds' dt projections: Mamba2's 12 of 24 columns, and
    # Hymba's 25 of 50 (a row stride and window that are not multiples of
    # 4: the scalar copy path), at shared and per-client offsets
    (4, 2048, 768, 24, 12, [12, 12, 12, 12]),
    (4, 512, 1600, 50, 25, [25, 0, 25, 13]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_gpu_rolling_kernels_match_plain(cuda, T, shape):
    c, m, k, n, win, offs = shape
    g = torch.Generator(cuda).manual_seed(T)
    x = torch.randn((c, m, k), device=cuda, generator=g)
    ws = [torch.randn((c, k, n), device=cuda, generator=g) for _ in range(T)]
    dys = [torch.randn((c, m, win), device=cuda, generator=g)
           for _ in range(T)]
    o = make_offsets(offs, cuda)
    n_fwd = _build.LAUNCHES[f"rolling_mm_fwd<{T}>"]
    ys = rolling_mm_fwd(x, ws, o, win)
    dx = rolling_mm_dx(dys, ws, o, win)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[f"rolling_mm_fwd<{T}>"] == n_fwd + 1
    for y, yr in zip(ys, rolling_matmul_batched_ref(x, ws, offs, win)):
        _gpu_close(y, yr)
    _gpu_close(dx, rolling_matmul_batched_dx_ref(dys, ws, offs, win))


@pytest.mark.gpu
def test_gpu_block_tiles_follow_the_grid_rule(cuda):
    """Each launch takes the largest block tile (128 x 128, 128 x 64, 64 x
    64) whose grid covers every SM, else 64 x 32; on a 132-SM H100 the main
    path's shapes reach all four."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    seen = set()
    for c, m, k, n, win, _ in GPU_SHAPES:
        for T in (1, 2):
            for kind, cols, z in (("fwd", win, c * T), ("dx", k, c)):
                want = next(
                    (bm, bn)
                    for bm, bn in ((128, 128), (128, 64), (64, 64), (64, 32))
                    if -(-cols // bn) * -(-m // bm) * z >= sms
                    or (bm, bn) == (64, 32))
                assert block_tile(kind, T, c, m, k, win) == want
                seen.add(want)
    if sms == 132:
        assert seen == {(128, 128), (128, 64), (64, 64), (64, 32)}


@pytest.mark.gpu
def test_gpu_bf16_wgmma_tiles_follow_the_grid_rule(cuda):
    """The bf16 arm's wgmma body takes the largest of 128 x 128, 64 x 128
    and 64 x 64 (and, in dx, 64 x 32) whose grid covers every SM, else the
    narrowest; on a 132-SM H100 the main path's shapes and the bf16
    eval's reach all four."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    seen = set()
    for c, m, k, n, win, _ in GPU_SHAPES:
        for T in (1, 2):
            for kind, cols, z in (("fwd", win, c * T), ("dx", k, c)):
                tiles = ((128, 128), (64, 128), (64, 64)) + (
                    ((64, 32),) if kind == "dx" else ())
                want = next((bm, bn) for bm, bn in tiles
                            if -(-cols // bn) * -(-m // bm) * z >= sms
                            or (bm, bn) == tiles[-1])
                assert block_tile(kind, T, c, m, k, win,
                                  dtype=torch.bfloat16) == want
                seen.add(want)
    if sms == 132:
        assert seen == {(128, 128), (64, 128), (64, 64), (64, 32)}


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("shape", [GPU_SHAPES[1], GPU_SHAPES[2],
                                   GPU_SHAPES[3]])
def test_gpu_rolling_kernels_are_deterministic(cuda, T, shape):
    """One block sums each output in a fixed order (no split contraction,
    no atomics): two launches on the same inputs are bit-equal."""
    c, m, k, n, win, offs = shape
    g = torch.Generator(cuda).manual_seed(20 + T)
    x = torch.randn((c, m, k), device=cuda, generator=g)
    ws = [torch.randn((c, k, n), device=cuda, generator=g) for _ in range(T)]
    dys = [torch.randn((c, m, win), device=cuda, generator=g)
           for _ in range(T)]
    o = make_offsets(offs, cuda)
    first = [*rolling_mm_fwd(x, ws, o, win), rolling_mm_dx(dys, ws, o, win)]
    second = [*rolling_mm_fwd(x, ws, o, win), rolling_mm_dx(dys, ws, o, win)]
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# around the update kernels' block of 256 float4 (1024 floats) and four of
# them (4096): empty, shorter than a float4, one float short of a block and
# 5 past it
UPDATE_SIZES = [0, 1, 3, 1023, 1029, 4095, 4099, 4101, 1 << 20]
# in-place views of the update kernels' operands, offsets in floats: (w, g)
# and (w, m, g) sharing one misalignment (a scalar head, then the float4
# body) and with mismatched ones (the scalar loop)
SGD_VIEWS = [(1, 1), (1, 2), (2, 0)]
MASKED_VIEWS = [(1, 1, 1), (1, 2, 2), (0, 2, 1)]


def _in_place_view(w, lo, n):
    """A copy of ``w`` and its view ``[lo, lo + n)``: the kernel then
    updates a leaf that starts off the allocation's 16-byte boundary."""
    buf = w.clone()
    return buf, buf[lo:lo + n]


@pytest.mark.gpu
@pytest.mark.parametrize("n", UPDATE_SIZES)
def test_gpu_sgd_kernel_is_bit_exact_to_plain(cuda, n):
    g = torch.Generator(cuda).manual_seed(n)
    w = torch.randn(n + 2, device=cuda, generator=g)
    gr = torch.randn(n + 2, device=cuda, generator=g)
    for lo in (0, 1):        # 16-byte aligned, then misaligned views
        want = sgd_ref(w[lo:lo + n].clone(), gr[lo:lo + n], 0.05)
        got = sgd_(w[lo:lo + n].clone(), gr[lo:lo + n], 0.05)
        assert torch.equal(got, want)
    for wo, go in SGD_VIEWS:
        want = sgd_ref(w[wo:wo + n].clone(), gr[go:go + n], 0.05)
        buf, view = _in_place_view(w, wo, n)
        assert sgd_(view, gr[go:go + n], 0.05) is view
        assert torch.equal(view.view(torch.int32), want.view(torch.int32))
        assert torch.equal(buf[:wo], w[:wo])           # nothing outside
        assert torch.equal(buf[wo + n:], w[wo + n:])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sgd", "masked_sgd"])
def test_gpu_update_kernels_are_deterministic(cuda, kind):
    """Two launches on the same inputs are bit-equal (aligned, and on
    views with a scalar head)."""
    n = 3 * 4096 + 7
    g = torch.Generator(cuda).manual_seed(5)
    w = torch.randn(n + 1, device=cuda, generator=g)
    m = (torch.rand(n + 1, device=cuda, generator=g) < 0.5).float()
    gr = torch.randn(n + 1, device=cuda, generator=g)
    for lo in (0, 1):
        outs = []
        for _ in range(2):
            v = w[lo:lo + n].clone() if lo == 0 else \
                _in_place_view(w, lo, n)[1]
            if kind == "sgd":
                outs.append(sgd_(v, gr[lo:lo + n], 0.05))
            else:
                outs.append(masked_sgd_(v, m[lo:lo + n], gr[lo:lo + n],
                                        0.05))
        assert torch.equal(outs[0].view(torch.int32),
                           outs[1].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 2])
def test_gpu_autograd_function_matches_plain_autograd(cuda, T):
    """dx through the kernel and the dW window writes, against autograd
    through the plain version, with per-client offsets."""
    c, m, k, n, win = 3, 70, 96, 130, 50
    g = torch.Generator(cuda).manual_seed(10 + T)
    x = torch.randn((c, m, k), device=cuda, generator=g, requires_grad=True)
    ws = [torch.randn((c, k, n), device=cuda, generator=g,
                      requires_grad=True) for _ in range(T)]
    dys = [torch.randn((c, m, win), device=cuda, generator=g)
           for _ in range(T)]
    offs = [0, 33, n - win]
    got = torch.autograd.grad(
        rolling_matmul_batched(x, ws, make_offsets(offs, cuda), win),
        [x, *ws], dys)
    want = torch.autograd.grad(
        rolling_matmul_batched_ref(x, ws, offs, win), [x, *ws], dys)
    for a, b in zip(got, want):
        _gpu_close(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("n", UPDATE_SIZES)
def test_gpu_masked_sgd_kernel_is_bit_exact_to_plain(cuda, n):
    g = torch.Generator(cuda).manual_seed(n)
    w = torch.randn(n + 2, device=cuda, generator=g)
    m = (torch.rand(n + 2, device=cuda, generator=g) < 0.5).float()
    gr = torch.randn(n + 2, device=cuda, generator=g)
    for lo in (0, 1):        # 16-byte aligned, then misaligned views
        sl = slice(lo, lo + n)
        want = masked_sgd_ref(w[sl].clone(), m[sl], gr[sl], 0.05)
        got = masked_sgd_(w[sl].clone(), m[sl], gr[sl], 0.05)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    for wo, mo, go in MASKED_VIEWS:
        want = masked_sgd_ref(w[wo:wo + n].clone(), m[mo:mo + n],
                              gr[go:go + n], 0.05)
        buf, view = _in_place_view(w, wo, n)
        assert masked_sgd_(view, m[mo:mo + n], gr[go:go + n], 0.05) is view
        assert torch.equal(view.view(torch.int32), want.view(torch.int32))
        assert torch.equal(buf[:wo], w[:wo])           # nothing outside
        assert torch.equal(buf[wo + n:], w[wo + n:])


@pytest.mark.gpu
@pytest.mark.parametrize("server_lr", [1.0, 0.5])
@pytest.mark.parametrize("C", [3, 4])
@pytest.mark.parametrize("n", [1, 4099, 1 << 20])
def test_gpu_fillin_kernel_is_bit_exact_to_plain(cuda, C, server_lr, n):
    g = torch.Generator(cuda).manual_seed(n + C)
    w = torch.randn(n + 1, device=cuda, generator=g)
    wc = torch.randn(C, n + 1, device=cuda, generator=g)
    mc = (torch.rand(C, n + 1, device=cuda, generator=g) < 0.5).float()
    for lo in (0, 1):        # aligned, then a misaligned server leaf
        sl = slice(lo, lo + n)
        want = fillin_agg_ref(w[sl].clone(), wc[:, :n], mc[:, :n],
                              server_lr / C)
        got = fillin_agg_(w[sl].clone(), wc[:, :n].contiguous(),
                          mc[:, :n].contiguous(), server_lr)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("shape", [(300, 1000, 777, 333, 17),
                                   (512, 2048, 5632, 2816, 2816)])
def test_gpu_scalar_products_match_plain(cuda, T, shape):
    """TPU rows 1-4: one model's windowed products (C = 1 launches).
    Launches counted under the reference's scalar names; values and the
    autograd VJP against plain autograd on the window views."""
    m, k, n, win, off = shape
    g = torch.Generator(cuda).manual_seed(T)
    x = torch.randn((m, k), device=cuda, generator=g, requires_grad=True)
    ws = [torch.randn((k, n), device=cuda, generator=g, requires_grad=True)
          for _ in range(T)]
    dys = [torch.randn((m, win), device=cuda, generator=g)
           for _ in range(T)]
    names = (["rolling_matmul", "rolling_matmul_dx"] if T == 1 else
             ["rolling_matmul_multi", "rolling_matmul_dx_multi"])
    before = [_build.LAUNCHES[nm] for nm in names]
    ys = rolling_matmul(x, ws, off, win)
    got = torch.autograd.grad(ys, [x, *ws], dys)
    torch.cuda.synchronize()
    assert [_build.LAUNCHES[nm] for nm in names] == [b + 1 for b in before]
    want_y = [x @ w[:, off:off + win] for w in ws]
    want = torch.autograd.grad(want_y, [x, *ws], dys)
    for a, b in zip([*ys, *got], [*want_y, *want]):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max().clamp_min(1.0)


# each client's window of experts read in place from the full stacks (the
# MoE layer's gate/up under experts and moe_d_ff windows): (C, E, G, M, K,
# N, win, expert offsets, column offsets), each client's G experts from its
# own offset at its own column window; a small one, and reduced-width
# Mixtral's (C = 2, 4 of 8 experts, capacity 320, d_model 1024, window 2048
# of 4096)
EXPERT_SHAPES = [(2, 4, 2, 24, 40, 96, 32, [1, 2], [5, 64]),
                 (2, 8, 4, 320, 1024, 4096, 2048, [4, 0], [2048, 1024])]


def _expert_data(T, shape, device, seed):
    Cc, E, G, m, k, n, win, eo, fo = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Cc, G, m, k)).astype(np.float32)
    ws = [rng.standard_normal((Cc, E, k, n)).astype(np.float32)
          for _ in range(T)]
    dys = [rng.standard_normal((Cc, G, m, win)).astype(np.float32)
           for _ in range(T)]
    xt = torch.tensor(x, device=device, requires_grad=True)
    wts = [torch.tensor(w, device=device, requires_grad=True) for w in ws]
    cols = [make_offsets([o] * G, device) for o in fo]
    ys = rolling_matmul_batched(xt, wts, cols, win, experts=eo)
    grads = torch.autograd.grad(ys, [xt, *wts],
                                [torch.tensor(d, device=device)
                                 for d in dys])
    return (x, ws, dys), [y.detach() for y in ys], grads


@pytest.mark.parametrize("T", [1, 2])
def test_rolling_expert_windows_match_dispatch(jx, T):
    """``rolling_matmul_batched(..., experts=)`` on the CPU: each client's
    window of experts against ``dispatch.rolling_matmul`` (T = 1) /
    ``rolling_matmul_multi`` (T = 2) vmapped over that client's experts
    of the full stacks, values and VJP; the weight gradient exactly zero
    outside every client's window of experts and columns."""
    shape = EXPERT_SHAPES[0]
    Cc, E, G, m, k, n, win, eo, fo = shape
    (x, ws, dys), ys, grads = _expert_data(T, shape, "cpu", seed=40 + T)
    jax, jnp = jx.jax, jx.jnp

    def one(a, *w_, off):
        if len(w_) == 1:
            return (jx.dispatch.rolling_matmul(a, w_[0], off, win,
                                               backend="jnp"),)
        return jx.dispatch.rolling_matmul_multi(a, w_, off, win,
                                                backend="jnp")

    def f(x_, *w_):
        per = [jax.vmap(lambda a, *b, off=fo[c]: one(a, *b, off=off))(
            x_[c], *(w[c, eo[c]:eo[c] + G] for w in w_)) for c in range(Cc)]
        return tuple(jnp.stack([p[t] for p in per]) for t in range(T))

    ys_ref, vjp = jax.vjp(f, jnp.asarray(x), *map(jnp.asarray, ws))
    grads_ref = vjp(tuple(map(jnp.asarray, dys)))
    for a, b in zip([*ys, *grads], [*ys_ref, *grads_ref]):
        _close(a, b)
    for dw in grads[1:]:
        for c in range(Cc):
            inside = dw[c, eo[c]:eo[c] + G, :, fo[c]:fo[c] + win].clone()
            dw[c, eo[c]:eo[c] + G, :, fo[c]:fo[c] + win] = 0
            assert torch.count_nonzero(inside) > 0
        assert torch.count_nonzero(dw) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("shape", EXPERT_SHAPES)
def test_gpu_rolling_kernels_match_plain_at_expert_windows(cuda, T, shape):
    """TPU rows 5-8 at the MoE layer's launches, one a client on its
    window of experts of the full stacks: values and the VJP against the
    same Function on the CPU (the plain versions), one launch a client,
    and two launches bit-equal."""
    Cc = shape[0]
    n = _build.LAUNCHES[f"rolling_mm_fwd<{T}>"]
    _, ys, grads = _expert_data(T, shape, cuda, seed=30 + T)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[f"rolling_mm_fwd<{T}>"] == n + Cc
    _, ys_cpu, grads_cpu = _expert_data(T, shape, "cpu", seed=30 + T)
    for a, b in zip([*ys, *grads], [*ys_cpu, *grads_cpu]):
        _gpu_close(a.cpu(), b)
    _, again, grads_again = _expert_data(T, shape, cuda, seed=30 + T)
    for a, b in zip([*ys, *grads], [*again, *grads_again]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("stagger", [False, True], ids=["shared", "stagger"])
def test_gpu_moe_dropping_is_deterministic(cuda, stagger):
    """One MoE layer of reduced Mixtral on the card, 2 clients on the
    ``dropping`` path under ``experts`` and ``moe_d_ff`` windows: the
    output and every weight's gradient are bit-equal across two runs (the
    combine gathers a token's k contributions and sums them in order; no
    slot is read twice), the expert products go through rows 7 and 8 (one
    launch a client, its window of experts in the kernel's leading
    dimension), and the values agree with the same layer on the CPU."""
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.models import moe
    from repro_torch.models.layers import AxisWindow, WindowMap
    cfg = get_reduced_config("mixtral_8x22b")
    g = torch.Generator().manual_seed(3)
    E, D, Fe = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff
    p_cpu = {"router": torch.randn(2, D, E, generator=g) / 16,
             "w_gate": torch.randn(2, E, D, Fe, generator=g) / 16,
             "w_up": torch.randn(2, E, D, Fe, generator=g) / 16,
             "w_down": torch.randn(2, E, Fe, D, generator=g) / 16}
    x_cpu = torch.randn(2, 2, 64, D, generator=g)
    offs = ([0, 2], [0, 128]) if stagger else ([1, 1], [64, 64])
    window = WindowMap({("experts", E): AxisWindow(offs[0], 2),
                        ("moe_d_ff", Fe): AxisWindow(offs[1], 128)})

    def run(device):
        p = {k: v.to(device, copy=True).requires_grad_()
             for k, v in p_cpu.items()}
        out, aux = moe.moe_apply(p, x_cpu.to(device), cfg, "dropping",
                                 window)
        grads = torch.autograd.grad((out.square().sum() + aux.sum()),
                                    list(p.values()))
        return [out.detach(), *grads]
    n = _build.LAUNCHES["rolling_mm_fwd<2>"]
    first = run(cuda)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["rolling_mm_fwd<2>"] == n + 2
    second = run(cuda)
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for a, b in zip(first, run("cpu")):
        _gpu_close(a.cpu(), b)


# -- on the card: the bf16 arms (rows 1-11) against their plain versions -----


def _bf16_ulp(b):
    """One bf16 ulp of each element of ``b``: 2^-7 of the power of two at
    or below its magnitude (0 where b is 0)."""
    mant, exp = torch.frexp(b.float())
    return torch.where(mant == 0, torch.zeros_like(mant),
                       torch.ldexp(torch.ones_like(mant), exp - 8))


def _within_one_ulp(a, b):
    """The products' bf16 tolerance: both sides sum in f32, in other
    orders, then round once; where the two f32 sums straddle a rounding
    boundary they round one bf16 ulp apart.  Each element within one ulp
    of the plain version's, plus 1e-6 of its largest magnitude."""
    assert a.dtype == b.dtype == torch.bfloat16
    a, b = a.float(), b.float()
    slack = _bf16_ulp(b) + 1e-6 * b.abs().max()
    assert ((a - b).abs() <= slack).all(), (a - b).abs().max()


# (C, M, K, N, win, offsets, the forward's and dx's body): the main path's
# q shape (an aligned window); per-client offsets that are multiples of 8
# elements; the k/v projections' narrow window (128 of 256); a window and
# contraction below one 64-wide stage; a window of 333 (dy's rows are not
# 16-byte vectors: the forward on wgmma, dx on mma.sync); the copy body:
# odd offsets at aligned row strides (TMA needs a box's first element on
# a 16-byte vector), Mamba2's dt (12 of 24), Hymba's dt (ldw 50, win 25),
# odd strides
GPU_BF16_SHAPES = [
    (4, 512, 2048, 2048, 1024, [1024] * 4, "wgmma", "wgmma"),
    (4, 512, 2048, 256, 128, [0, 64, 128, 8], "wgmma", "wgmma"),
    (4, 512, 2048, 256, 128, [128] * 4, "wgmma", "wgmma"),
    (3, 24, 40, 96, 32, [8, 32, 64], "wgmma", "wgmma"),
    (2, 200, 1000, 776, 333, [0, 440], "wgmma", "mma.sync"),
    (3, 24, 40, 96, 32, [5, 37, 64], "mma.sync", "mma.sync"),
    (4, 512, 2048, 256, 128, [0, 37, 128, 5], "mma.sync", "mma.sync"),
    (4, 256, 768, 24, 12, [12] * 4, "mma.sync", "mma.sync"),
    (4, 512, 1600, 50, 25, [25, 0, 25, 13], "mma.sync", "mma.sync"),
    (2, 70, 100, 130, 50, [0, 33], "mma.sync", "mma.sync"),
    (1, 300, 1000, 777, 333, [17], "mma.sync", "mma.sync"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("shape", GPU_BF16_SHAPES)
def test_gpu_bf16_rolling_kernels_within_one_ulp(cuda, T, shape):
    """Both bodies of rows 1-8's bf16 arm within one ulp of the plain
    versions, each launch counted under its name and its body, and two
    launches bit-equal."""
    c, m, k, n, win, offs, fwd_body, dx_body = shape
    g = torch.Generator(cuda).manual_seed(30 + T)
    bf = torch.bfloat16
    x = torch.randn((c, m, k), device=cuda, generator=g).to(bf)
    ws = [torch.randn((c, k, n), device=cuda, generator=g).to(bf)
          for _ in range(T)]
    dys = [torch.randn((c, m, win), device=cuda, generator=g).to(bf)
           for _ in range(T)]
    o = make_offsets(offs, cuda)
    names = [f"rolling_mm_fwd<{T}>/bf16", f"rolling_mm_dx<{T}>/bf16"]
    bodies = [f"{names[0]} {fwd_body}", f"{names[1]} {dx_body}"]
    before = ([_build.LAUNCHES[nm] for nm in names] +
              [_build.BODIES[nm] for nm in bodies])
    ys = rolling_mm_fwd(x, ws, o, win)
    dx = rolling_mm_dx(dys, ws, o, win)
    torch.cuda.synchronize()
    assert [_build.LAUNCHES[nm] for nm in names] == [b + 1 for b in before[:2]]
    assert [_build.BODIES[nm] for nm in bodies] == [b + 1 for b in before[2:]]
    for y, yr in zip(ys, rolling_matmul_batched_ref(x, ws, offs, win)):
        _within_one_ulp(y, yr)
    _within_one_ulp(dx, rolling_matmul_batched_dx_ref(dys, ws, offs, win))
    again = [*rolling_mm_fwd(x, ws, o, win), rolling_mm_dx(dys, ws, o, win)]
    for a, b in zip([*ys, dx], again):                  # deterministic
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("win", [128, 120, 40])
def test_gpu_bf16_products_read_nothing_past_the_window(cuda, win):
    """W holds inf in every column outside each client's window: the
    forward and dx stay finite and within one ulp of the plain versions
    on the window alone.  dx's contraction runs along the window, so its
    wgmma body zeroes what TMA brings in past the window's end (a ragged
    last stage at win 120 and 40; none at 128) rather than rely on dy's
    zero fill (0 x inf is NaN)."""
    bf = torch.bfloat16
    c, m, k, n, T = 3, 200, 512, 384, 2
    offs = [0, 64, n - win]
    g = torch.Generator(cuda).manual_seed(win)
    x = torch.randn((c, m, k), device=cuda, generator=g).to(bf)
    ws = [torch.randn((c, k, n), device=cuda, generator=g).to(bf)
          for _ in range(T)]
    dys = [torch.randn((c, m, win), device=cuda, generator=g).to(bf)
           for _ in range(T)]
    for w in ws:
        for ci, oc in enumerate(offs):
            w[ci, :, :oc] = float("inf")
            w[ci, :, oc + win:] = float("inf")
    o = make_offsets(offs, cuda)
    _build.reset_launches()
    ys = rolling_mm_fwd(x, ws, o, win)
    dx = rolling_mm_dx(dys, ws, o, win)
    torch.cuda.synchronize()
    assert dict(_build.BODIES) == {"rolling_mm_fwd<2>/bf16 wgmma": 1,
                                   "rolling_mm_dx<2>/bf16 wgmma": 1}
    for y, yr in zip(ys, rolling_matmul_batched_ref(x, ws, offs, win)):
        assert torch.isfinite(y.float()).all()
        _within_one_ulp(y, yr)
    assert torch.isfinite(dx.float()).all()
    _within_one_ulp(dx, rolling_matmul_batched_dx_ref(dys, ws, offs, win))


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 2])
def test_gpu_bf16_autograd_function_matches_plain_autograd(cuda, T):
    """At bf16, dx through the kernel and dW through cuBLAS into the
    window of zeros (its reductions in f32), against autograd through the
    plain products on x widened once, so that the T weights' dx sum in f32
    and round once, as the kernel sums them (the extract client phase's
    ``mlp_apply``)."""
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        _bf16_autograd_vs_plain(cuda, T)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = old


@pytest.mark.gpu
def test_gpu_bf16_extract_round_from_the_default_matmul_flag(cuda):
    """PyTorch's default lets cuBLAS add a bf16 GEMM's partial sums in
    bf16.  The port's entry points turn that off when they pick the card
    (``device.resolve_device``), so a reduced bf16 extract round started
    from the default is, bit for bit, the round started with the flag off;
    with the flag set back on, a bf16 product on the card raises."""
    from repro_torch import api
    from repro_torch.configs.base import SubmodelConfig, get_reduced_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    from repro_torch.models.layers import bmm
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_bf16_reduced_precision_reduction
    cfg = get_reduced_config("tinyllama_1_1b")
    scfg = SubmodelConfig(scheme="rolling", capacity=0.5, local_steps=2,
                          clients_per_round=4, client_lr=0.1,
                          axes=("d_ff", "heads", "kv_heads"))
    it = lm_batches(cfg.vocab, (2, 4, 2), 64, seed=0)
    batches = [next(it) for _ in range(2)]
    out = []
    try:
        for flag in (True, False):
            matmul.allow_bf16_reduced_precision_reduction = flag
            model = build_model(cfg, param_dtype=torch.bfloat16)
            fed = api.fed_round(model, scfg, fused_forward="off",
                                device="cuda")
            assert not matmul.allow_bf16_reduced_precision_reduction
            trainer = api.Trainer(fed, model.init(0, device="cuda"))
            trainer.run(iter(batches), 2)
            out.append(trainer.params)
        for k, v in out[0].items():
            assert v.dtype == torch.bfloat16
            assert torch.equal(v.view(torch.int16),
                               out[1][k].view(torch.int16)), k
        matmul.allow_bf16_reduced_precision_reduction = True
        a = torch.ones((1, 8, 8), device=cuda, dtype=torch.bfloat16)
        with pytest.raises(RuntimeError, match="reduced_precision"):
            bmm(a, a)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = old


def _bf16_autograd_vs_plain(cuda, T):
    c, m, k, n, win = 3, 70, 96, 130, 50
    g = torch.Generator(cuda).manual_seed(40 + T)
    bf = torch.bfloat16
    x = torch.randn((c, m, k), device=cuda, generator=g).to(bf)
    ws = [torch.randn((c, k, n), device=cuda, generator=g).to(bf)
          for _ in range(T)]
    dys = [torch.randn((c, m, win), device=cuda, generator=g).to(bf)
           for _ in range(T)]
    for offs in ([0, 33, n - win], [40, 40, 40]):
        leaves = [t.clone().requires_grad_() for t in (x, *ws)]
        got = torch.autograd.grad(rolling_matmul_batched(
            leaves[0], leaves[1:], make_offsets(offs, cuda), win),
            leaves, dys)
        xw = leaves[0].float()
        want = torch.autograd.grad(
            [torch.bmm(xw, window_columns(w, offs, win).float()).to(w.dtype)
             for w in leaves[1:]], leaves, dys)
        for a, b in zip(got, want):
            _within_one_ulp(a, b)


# around the bf16 arms' block of 256 vectors of 8 (2048 elements)
BF16_SIZES = [0, 1, 7, 2047, 2053, 8191, 8199, 1 << 20]
# offsets in elements: shared odd and even misalignments (a scalar head),
# mismatched ones (the scalar loop)
BF16_VIEWS = [(1, 1, 1), (3, 3, 3), (2, 2, 2), (1, 2, 2), (0, 2, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sgd", "masked_sgd"])
@pytest.mark.parametrize("n", BF16_SIZES)
def test_gpu_bf16_client_steps_bit_exact_to_plain(cuda, kind, n):
    """Rows 9 and 10 at bf16, bit for bit against the plain versions, also
    in place on views; counted under ``/bf16``."""
    g = torch.Generator(cuda).manual_seed(n + 7)
    bf = torch.bfloat16
    w = torch.randn(n + 4, device=cuda, generator=g).to(bf)
    m = (torch.rand(n + 4, device=cuda, generator=g) < 0.5).to(bf)
    gr = torch.randn(n + 4, device=cuda, generator=g).to(bf)
    name = f"{kind}_inplace/bf16"
    for wo, mo, go in [(0, 0, 0), *BF16_VIEWS]:
        if kind == "sgd":
            want = sgd_ref(w[wo:wo + n].clone(), gr[go:go + n], 0.05)
        else:
            want = masked_sgd_ref(w[wo:wo + n].clone(), m[mo:mo + n],
                                  gr[go:go + n], 0.05)
        buf, view = _in_place_view(w, wo, n)
        before = _build.LAUNCHES[name]
        if kind == "sgd":
            got = sgd_(view, gr[go:go + n], 0.05)
        else:
            got = masked_sgd_(view, m[mo:mo + n], gr[go:go + n], 0.05)
        assert got is view and _build.LAUNCHES[name] == before + 1
        assert torch.equal(view.view(torch.int16), want.view(torch.int16))
        assert torch.equal(buf[:wo].view(torch.int16),
                           w[:wo].view(torch.int16))
        assert torch.equal(buf[wo + n:].view(torch.int16),
                           w[wo + n:].view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("server_lr", [1.0, 0.5])
@pytest.mark.parametrize("C", [3, 4])
@pytest.mark.parametrize("n", [1, 8199, 1 << 20])
def test_gpu_bf16_fillin_bit_exact_to_plain(cuda, C, server_lr, n):
    """Row 11 at bf16, bit for bit: a client stride that is a multiple of
    8 elements (the vector body) and one that is not (scalar)."""
    g = torch.Generator(cuda).manual_seed(n + C + 1)
    bf = torch.bfloat16
    w = torch.randn(n + 1, device=cuda, generator=g).to(bf)
    wc = torch.randn(C, n + 1, device=cuda, generator=g).to(bf)
    mc = (torch.rand(C, n + 1, device=cuda, generator=g) < 0.5).to(bf)
    for lo in (0, 1):
        sl = slice(lo, lo + n)
        want = fillin_agg_ref(w[sl].clone(), wc[:, :n], mc[:, :n],
                              server_lr / C)
        got = fillin_agg_(w[sl].clone(), wc[:, :n].contiguous(),
                          mc[:, :n].contiguous(), server_lr)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def _odd_view(t, dim):
    """``t`` copied into a buffer one element longer along ``dim`` and
    viewed back: the same values at odd strides (no 16-byte rows)."""
    shape = list(t.shape)
    shape[dim] += 1
    buf = torch.zeros(shape, dtype=t.dtype, device=t.device)
    view = buf.narrow(dim, 0, t.shape[dim])
    view.copy_(t)
    return view


def _within_ulp_and(a, b, rel):
    """bf16 ``a`` within one ulp of ``b`` plus ``rel`` of b's largest
    magnitude (the f32 arms' own tolerance, GPU_RTOL, for their other
    summation order, then one rounding)."""
    assert a.dtype == b.dtype == torch.bfloat16
    a, b = a.float(), b.float()
    slack = _bf16_ulp(b) + rel * b.abs().max()
    assert ((a - b).abs() <= slack).all(), (a - b).abs().max()


# row 12 at bf16: (Bt, nc, Q, nh, hd, N, head_offset, head_win, odd
# strides): d_state 16 (the kernel's 16-column state) at Q 128 and 100, a
# single chunk (Bt nc = 1: heads in groups of one), head_dim 16 and 128
SSD_BF16 = [(2, 3, 100, 24, 64, 128, 5, 7, False),
            (1, 2, 128, 50, 64, 16, None, 0, False),
            (2, 3, 100, 8, 64, 16, None, 0, False),
            (1, 1, 256, 24, 64, 128, 3, 9, False),
            (2, 2, 130, 6, 16, 32, 1, 4, False),
            (1, 1, 200, 3, 128, 64, None, 0, False),
            (2, 2, 64, 16, 32, 16, 3, 5, True),
            (1, 2, 256, 4, 128, 128, None, 0, True)]
# row 12 at bf16 on views whose rows past a ragged chunk hold NaN: (Bt, nc,
# Q, nh, hd, N)
SSD_BF16_NAN_PAD = [(2, 2, 100, 6, 64, 128), (1, 2, 100, 10, 64, 16)]
# row 13 at bf16: (B, Sq, Skv, H, KV, hd, window, odd strides): every
# head_dim the kernel takes (8 and 16 below one k16 step's 16 and at it),
# G = 1, 3, 4, 5, causal and windowed, Sq < Skv and Sq > Skv, odd strides
FLASH_BF16 = [(2, 200, 200, 8, 8, 64, 0, False),
              (1, 300, 300, 25, 5, 64, 64, False),
              (2, 130, 190, 6, 2, 128, 0, True),
              (1, 97, 97, 4, 2, 96, 32, True),
              (2, 150, 150, 4, 1, 8, 0, False),
              (1, 260, 200, 16, 4, 16, 0, True),
              (2, 333, 333, 5, 1, 32, 100, False),
              (1, 520, 520, 20, 4, 128, 256, False),
              (1, 100, 260, 10, 2, 64, 0, True),
              (2, 257, 257, 4, 4, 128, 0, False)]


@pytest.mark.gpu
def test_gpu_rows_12_13_bf16_arms(cuda):
    """The bf16 arms of rows 12 and 13 against their plain versions on the
    same bf16 inputs: ragged chunks and lengths, odd head offsets,
    Hymba's 50 SSM heads and 25 on 5 query heads under a window, and views
    at odd strides (the element-by-element copies); row 12 also at
    d_state 16 (Q 128 and 100), on a single chunk, at head_dim 16 and 128,
    and on views whose rows past a ragged chunk hold NaN, which must reach
    neither y nor the states; row 13 at every head_dim it takes, with Sq
    != Skv.  A second launch of each is bit-equal.  y and the output within
    one ulp plus GPU_RTOL of the largest magnitude, the f32 states within
    GPU_RTOL (row 12 sums each head's contraction, at most 16 k16 steps of
    two passes, on the tensor core: these cases at Q 256 show it within
    them); counted under ``/bf16``; a mixed-dtype call raises."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import (flash_attention_ref,
                                         ssd_chunk_intra_ref)
    from repro_torch.kernels.ssd_chunk import ssd_chunk_intra
    bf = torch.bfloat16
    g = torch.Generator(cuda).manual_seed(12)
    F = torch.nn.functional
    for Bt, nc, Q, nh, hd, N, off, win, odd in SSD_BF16:
        x = (0.5 * torch.randn((Bt, nc, Q, nh, hd), device=cuda,
                               generator=g)).to(bf)
        dt = F.softplus(torch.randn((Bt, nc, Q, nh), device=cuda,
                                    generator=g)).to(bf)
        A = -torch.exp(0.3 * torch.randn((nh,), device=cuda, generator=g))
        B, C = ((0.5 * torch.randn((Bt, nc, Q, N), device=cuda,
                                   generator=g)).to(bf) for _ in range(2))
        if odd:
            x, dt, B, C = (_odd_view(x, 4), _odd_view(dt, 3), _odd_view(B, 3),
                           _odd_view(C, 3))
        hs = slice(off or 0, (off or 0) + (win or nh))
        n = _build.LAUNCHES["ssd_chunk_intra/bf16"]
        y, st = ssd_chunk_intra(x, dt, A, B, C, head_offset=off,
                                head_win=win)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["ssd_chunk_intra/bf16"] == n + 1
        yr, sr = ssd_chunk_intra_ref(x[..., hs, :], dt[..., hs], A[hs], B, C)
        assert y.dtype == bf and st.dtype == torch.float32
        _within_ulp_and(y, yr, GPU_RTOL)
        _gpu_close(st, sr)
        y2, st2 = ssd_chunk_intra(x, dt, A, B, C, head_offset=off,
                                  head_win=win)              # deterministic
        assert torch.equal(y.view(torch.int16), y2.view(torch.int16))
        assert torch.equal(st, st2)
    for Bt, nc, Q, nh, hd, N in SSD_BF16_NAN_PAD:
        def padded(shape):   # rows Q .. Q + 7 of the chunk axis hold NaN
            buf = torch.full((*shape[:2], Q + 8, *shape[3:]), float("nan"),
                             dtype=bf, device=cuda)
            view = buf[:, :, :Q]
            view.copy_(0.5 * torch.randn(shape, device=cuda, generator=g))
            return view
        x, B, C = (padded(sh) for sh in ((Bt, nc, Q, nh, hd), (Bt, nc, Q, N),
                                         (Bt, nc, Q, N)))
        dt = padded((Bt, nc, Q, nh))
        dt.copy_(F.softplus(dt.float()))
        A = -torch.exp(0.3 * torch.randn((nh,), device=cuda, generator=g))
        y, st = ssd_chunk_intra(x, dt, A, B, C)
        torch.cuda.synchronize()
        assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
        yr, sr = ssd_chunk_intra_ref(x, dt, A, B, C)
        _within_ulp_and(y, yr, GPU_RTOL)
        _gpu_close(st, sr)
    for Bsz, Sq, Skv, H, KV, hd, window, odd in FLASH_BF16:
        q = (2 * torch.randn((Bsz, Sq, H, hd), device=cuda,
                             generator=g)).to(bf)
        k = (2 * torch.randn((Bsz, Skv, KV, hd), device=cuda,
                             generator=g)).to(bf)
        v = torch.randn((Bsz, Skv, KV, hd), device=cuda, generator=g).to(bf)
        if odd:
            q, k, v = (_odd_view(t, 3) for t in (q, k, v))
        n = _build.LAUNCHES["flash_attention/bf16"]
        out = flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["flash_attention/bf16"] == n + 1
        assert out.dtype == bf
        _within_ulp_and(out, flash_attention_ref(q, k, v, window=window),
                        GPU_RTOL)
        again = flash_attention(q, k, v, window=window)   # deterministic
        assert torch.equal(out.view(torch.int16), again.view(torch.int16))
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention(q, k.float(), v)
    with pytest.raises(TypeError, match="one dtype"):
        ssd_chunk_intra(x, dt.float(), A, B, C)
    with pytest.raises(TypeError):
        rolling_mm_fwd(q[..., :64].reshape(1, -1, 64), [torch.randn(
            1, 64, 64, device=cuda)], make_offsets([0], cuda), 32)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2_130m", "hymba_1_5b"])
def test_gpu_bf16_ssm_paths_from_the_default_matmul_flag(cuda, arch):
    """Reduced Mamba2 and Hymba at bf16 on the card, from PyTorch's default
    matmul flag (the port's entry points turn its bf16 partial sums off):
    one fused round (rows 5-8 and 10 at bf16), an eval with
    ``REPRO_USE_FLASH`` (rows 12 and 13 at bf16), prefill and 4 greedy
    steps; finite, bf16 params and logits, only bf16 arms launched."""
    import os

    from repro_torch import api
    from repro_torch.configs.base import SubmodelConfig, get_reduced_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_bf16_reduced_precision_reduction
    cfg = get_reduced_config(arch)
    model = build_model(cfg, param_dtype=torch.bfloat16)
    batch = next(lm_batches(cfg.vocab, (2, 4, 2), 64, seed=0))
    tokens = torch.as_tensor(batch["tokens"][0, :, 0], dtype=torch.long,
                             device=cuda)
    try:
        matmul.allow_bf16_reduced_precision_reduction = True
        fed = api.fed_round(model, SubmodelConfig(
            scheme="rolling", capacity=0.5, local_steps=2,
            clients_per_round=4, client_lr=0.01), device="cuda")
        assert not matmul.allow_bf16_reduced_precision_reduction
        trainer = api.Trainer(fed, model.init(0, device="cuda"))
        _build.reset_launches()
        trainer.run(iter([batch]), 1)
        os.environ["REPRO_USE_FLASH"] = "1"
        with torch.no_grad():
            loss, _ = model.loss(trainer.params, {"tokens": tokens})
        del os.environ["REPRO_USE_FLASH"]
        out = generate(model, trainer.params, tokens, 4, return_logits=True)
        launches = dict(_build.LAUNCHES)
        assert np.isfinite(trainer.losses).all() and np.isfinite(float(loss))
        assert all(v.dtype == torch.bfloat16
                   for v in trainer.params.values())
        assert all(t.dtype == torch.bfloat16 and torch.isfinite(
            t.float()).all() for t in out["logits"])
        assert all(k.endswith("/bf16") for k in launches), launches
        for name in ("rolling_mm_fwd<1>/bf16", "sgd_inplace/bf16",
                     "ssd_chunk_intra/bf16"):
            assert launches.get(name, 0) > 0, (name, launches)
        assert (launches.get("flash_attention/bf16", 0) > 0) == (
            arch == "hymba_1_5b")
    finally:
        os.environ.pop("REPRO_USE_FLASH", None)
        matmul.allow_bf16_reduced_precision_reduction = old
