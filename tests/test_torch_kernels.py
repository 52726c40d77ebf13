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
                                     rolling_matmul_batched_ref, sgd_ref)
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


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 4099, 1 << 20])
def test_gpu_sgd_kernel_is_bit_exact_to_plain(cuda, n):
    g = torch.Generator(cuda).manual_seed(n)
    w = torch.randn(n + 1, device=cuda, generator=g)
    gr = torch.randn(n + 1, device=cuda, generator=g)
    for lo in (0, 1):        # 16-byte aligned, then misaligned views
        want = sgd_ref(w[lo:lo + n].clone(), gr[lo:lo + n], 0.05)
        got = sgd_(w[lo:lo + n].clone(), gr[lo:lo + n], 0.05)
        assert torch.equal(got, want)


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
@pytest.mark.parametrize("n", [1, 4099, 1 << 20])
def test_gpu_masked_sgd_kernel_is_bit_exact_to_plain(cuda, n):
    g = torch.Generator(cuda).manual_seed(n)
    w = torch.randn(n + 1, device=cuda, generator=g)
    m = (torch.rand(n + 1, device=cuda, generator=g) < 0.5).float()
    gr = torch.randn(n + 1, device=cuda, generator=g)
    for lo in (0, 1):        # 16-byte aligned, then misaligned views
        sl = slice(lo, lo + n)
        want = masked_sgd_ref(w[sl].clone(), m[sl], gr[sl], 0.05)
        got = masked_sgd_(w[sl].clone(), m[sl], gr[sl], 0.05)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


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
