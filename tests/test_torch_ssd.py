"""The port's SSD chunk block (TPU row 12) against the JAX reference.

On the CPU ``repro_torch.kernels.ssd_chunk.ssd_chunk_intra`` runs its plain
version (``kernels.ref.ssd_chunk_intra_ref``, a transcription of the Pallas
body); it is held against:

- the reference's Pallas ``ssd_chunk_intra`` in interpret mode, at the
  shapes of ``tests/test_kernels_interpret.py`` (head blocks included) and
  its head-window arm at the reference's block-aligned ``(off, win)``;
- through ``ssd_chunk_scan`` (the kernel plus the plain inter-chunk
  recurrence), the reference's ``ops.ssd_chunk_scan`` and
  ``models.ssm.ssd_chunked`` at the shapes of ``tests/test_kernels.py``
  (the port's differentiable ``models.ssm.ssd_chunked`` too),
  and one unaligned head window against the reference's ``ssd_chunked``
  on host-sliced heads;
- the sequential oracle ``ssd_chunk_ref`` (both packages').

Inputs are made with numpy from a seed.  Tolerance: float32, atol 1e-5 and
rtol 1e-5 -- two frameworks, the same order of operations inside a chunk,
other summation orders in the products.

The ``gpu`` tests launch the CUDA kernel and hold it against the plain
version on the card (1e-4 of each output's largest magnitude: f32 both,
other summation orders and another ``exp``); they decide inside a fixture
whether a card is present and import no JAX::

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_ssd.py
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.ssd_chunk import (ssd_chunk_intra,  # noqa: E402
                                          ssd_chunk_scan)
from repro_torch.models import ssm as port_ssm  # noqa: E402

ATOL = RTOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    """The reference's kernel, ops and oracles, imported at test time so
    that the ``gpu`` tests run where JAX is not installed."""
    jax = pytest.importorskip("jax")
    from repro.kernels import ops
    from repro.kernels import ref as jref
    from repro.kernels.ssd_chunk import ssd_chunk_intra as pallas_intra
    from repro.models.ssm import ssd_chunked
    return SimpleNamespace(
        jax=jax, jnp=jax.numpy, ops=ops, ref=jref, intra=pallas_intra,
        ssd_chunked=jax.jit(ssd_chunked, static_argnums=5))


def _inputs(lead, Q, nh, hd, N, seed=0):
    """x, dt, A, B, C as numpy f32: ``lead`` is ``(Bt, nc)`` for the chunk
    block and ``(B,)`` for a whole sequence of length ``Q``.  dt is a
    softplus and A negative, as the model makes them."""
    rng = np.random.default_rng(seed)
    f = (lambda *s: rng.standard_normal(lead + s).astype(np.float32))
    x = 0.5 * f(Q, nh, hd)
    dt = np.log1p(np.exp(f(Q, nh))).astype(np.float32)
    A = (-np.exp(0.3 * rng.standard_normal(nh))).astype(np.float32)
    return x, dt, A, 0.5 * f(Q, N), 0.5 * f(Q, N)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                               rtol=RTOL)


# -- the chunk block against the Pallas kernel (interpret mode) ---------------

# (nh, hd, N, Q, nh_block): tests/test_kernels_interpret.py's shapes
INTRA = [(4, 8, 16, 16, 0), (8, 16, 32, 32, 4), (6, 8, 16, 16, 2)]


@pytest.mark.parametrize("shape", INTRA, ids=lambda s: "-".join(map(str, s)))
def test_plain_intra_matches_pallas_kernel(jx, shape):
    nh, hd, N, Q, nh_block = shape
    args = _inputs((2, 3), Q, nh, hd, N)
    y_ref, s_ref = jx.intra(*map(jx.jnp.asarray, args), nh_block=nh_block,
                            interpret=True)
    y, s = ssd_chunk_intra(*_torch(*args))
    assert y.shape == (2, 3, Q, nh, hd) and s.shape == (2, 3, nh, hd, N)
    _close(y, y_ref)
    _close(s, s_ref)


@pytest.mark.parametrize("off,win,nh_block", [(2, 4, 2), (0, 4, 2),
                                              (4, 4, 0)])
def test_plain_intra_head_window_matches_pallas_kernel(jx, off, win,
                                                       nh_block):
    args = _inputs((1, 2), 16, 8, 8, 16)
    y_ref, s_ref = jx.intra(*map(jx.jnp.asarray, args), nh_block=nh_block,
                            head_offset=off, head_win=win, interpret=True)
    y, s = ssd_chunk_intra(*_torch(*args), head_offset=off, head_win=win)
    assert y.shape == (1, 2, 16, win, 8) and s.shape == (1, 2, win, 8, 16)
    _close(y, y_ref)
    _close(s, s_ref)


def test_plain_intra_matches_sequential_oracle(jx):
    """Per chunk, the block's y and exit state are the recurrence's from a
    zero state (the port's oracle), and the port's oracle is the
    reference's."""
    x, dt, A, B, C = _inputs((1, 2), 15, 3, 8, 16, seed=3)
    y, s = ssd_chunk_intra(*_torch(x, dt, A, B, C))
    for c in range(2):
        yo, so = ref.ssd_chunk_ref(*_torch(x[0, c], dt[0, c], A, B[0, c],
                                           C[0, c]))
        yj, sj = jx.ref.ssd_chunk_ref(x[0, c], dt[0, c], jx.jnp.asarray(A),
                                      B[0, c], C[0, c])
        _close(yo, yj)
        _close(so, sj)
        _close(y[0, c], yo)
        _close(s[0, c], so)


# -- the chunked SSD against ops.ssd_chunk_scan and ssd_chunked ---------------

# (nh, hd, N, Q, nh_block): tests/test_kernels.py's shapes; S = 4 Q
SCAN = [(4, 8, 16, 16, 0), (8, 16, 32, 32, 4), (2, 32, 8, 8, 2)]


@pytest.mark.parametrize("shape", SCAN, ids=lambda s: "-".join(map(str, s)))
def test_chunk_scan_matches_reference(jx, shape):
    nh, hd, N, Q, nh_block = shape
    args = _inputs((2,), 4 * Q, nh, hd, N)
    ja = list(map(jx.jnp.asarray, args))
    y, h = ssd_chunk_scan(*_torch(*args), Q)
    for y_ref, h_ref in (jx.ops.ssd_chunk_scan(*ja, Q, nh_block=nh_block),
                         jx.ssd_chunked(*ja, Q)):
        _close(y, y_ref)
        _close(h, h_ref)
    # the round's differentiable transcription holds to the same
    # reference and to the kernel route
    y2, h2 = port_ssm.ssd_chunked(*_torch(*args), Q)
    for y_ref, h_ref in ((y, h), jx.ssd_chunked(*ja, Q)):
        _close(y2, y_ref)
        _close(h2, h_ref)


@pytest.mark.parametrize("off,win,nh_block", [(2, 4, 2), (4, 4, 0),
                                              (3, 4, None)])
def test_chunk_scan_head_window(jx, off, win, nh_block):
    """A head window of full-width inputs == the reference's SSD on
    host-sliced heads; at the block-aligned windows also == the
    reference's head-window kernel arm.  (3, 4) is an offset the TPU
    kernel's head blocks cannot take."""
    Q = 16
    x, dt, A, B, C = _inputs((2,), 64, 8, 8, 16, seed=1)
    y, h = ssd_chunk_scan(*_torch(x, dt, A, B, C), Q, head_offset=off,
                          head_win=win)
    assert y.shape == (2, 64, win, 8) and h.shape == (2, win, 8, 16)
    hs = slice(off, off + win)
    y_ref, h_ref = jx.ssd_chunked(x[:, :, hs], dt[:, :, hs],
                                  jx.jnp.asarray(A[hs]), B, C, Q)
    _close(y, y_ref)
    _close(h, h_ref)
    if nh_block is not None:
        y_k, h_k = jx.ops.ssd_chunk_scan(
            *map(jx.jnp.asarray, (x, dt, A, B, C)), Q, nh_block=nh_block,
            head_offset=off, head_win=win)
        _close(y, y_k)
        _close(h, h_k)


def test_chunk_scan_matches_sequential_oracle(jx):
    """The chunked SSD == the step-by-step recurrence over the whole
    sequence (the port's oracle, and the reference's chunked form)."""
    x, dt, A, B, C = _inputs((2,), 64, 4, 8, 16, seed=2)
    y, h = ssd_chunk_scan(*_torch(x, dt, A, B, C), 16)
    for b in range(2):
        yo, ho = ref.ssd_chunk_ref(*_torch(x[b], dt[b], A, B[b], C[b]))
        _close(y[b], yo)
        _close(h[b], ho)
    y_ref, _ = jx.ssd_chunked(*map(jx.jnp.asarray, (x, dt, A, B, C)), 16)
    _close(y, y_ref)


def test_short_sequence_is_one_chunk(jx):
    """S < chunk runs one chunk of Q = S (the reduced decode check's
    prefill of 15)."""
    args = _inputs((2,), 15, 4, 8, 16, seed=4)
    y, h = ssd_chunk_scan(*_torch(*args), 32)
    y_ref, h_ref = jx.ssd_chunked(*map(jx.jnp.asarray, args), 32)
    _close(y, y_ref)
    _close(h, h_ref)


def test_ragged_sequence_raises_as_the_reference_does(jx):
    """S > chunk with S % chunk != 0: the reference's reshape fails, and
    the port raises ValueError."""
    args = _inputs((1,), 40, 2, 8, 16)
    with pytest.raises(TypeError):
        jx.ssd_chunked(*map(jx.jnp.asarray, args), 16)
    with pytest.raises(ValueError, match="whole number of chunks"):
        ssd_chunk_scan(*_torch(*args), 16)
    with pytest.raises(ValueError, match="whole number of chunks"):
        port_ssm.ssd_chunked(*_torch(*args), 16)


# -- refusals -----------------------------------------------------------------


def test_grad_requiring_inputs_are_refused():
    x, dt, A, B, C = _torch(*_inputs((1, 1), 8, 2, 8, 16))
    x.requires_grad_()
    with pytest.raises(NotImplementedError, match="models.ssm.ssd_chunked"):
        ssd_chunk_intra(x, dt, A, B, C)
    with pytest.raises(NotImplementedError, match="no backward"):
        ssd_chunk_scan(x.reshape(1, 8, 2, 8), dt.reshape(1, 8, 2), A,
                       B.reshape(1, 8, 16), C.reshape(1, 8, 16), 8)
    with torch.no_grad():
        ssd_chunk_intra(x, dt, A, B, C)


@pytest.mark.parametrize("bad", ["f64", "shape", "window", "window_no_off",
                                 "stride"])
def test_bad_operands_are_refused(bad):
    x, dt, A, B, C = _torch(*_inputs((1, 2), 8, 4, 8, 16))
    kw = {}
    err = ValueError
    if bad == "f64":
        x, err = x.double(), TypeError
    elif bad == "shape":
        C = C[..., :8]
    elif bad == "window":
        kw = dict(head_offset=2, head_win=3)
    elif bad == "window_no_off":
        kw = dict(head_win=2)
    else:
        B = B.transpose(-1, -2).contiguous().transpose(-1, -2)
    with pytest.raises(err):
        ssd_chunk_intra(x, dt, A, B, C, **kw)


def test_cpu_ssd_is_not_a_kernel_launch():
    before = dict(_build.LAUNCHES)
    ssd_chunk_intra(*_torch(*_inputs((1, 1), 8, 2, 8, 16)))
    assert dict(_build.LAUNCHES) == before


# -- on the card: the CUDA kernel against its plain version -------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; none is present")
    return torch.device("cuda")


GPU_RTOL = 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # (Bt, nc, Q, nh, hd, N, head_offset, head_win)
    (2, 3, 256, 4, 64, 128, None, 0),     # Mamba2-130M's chunk and state
    (1, 2, 128, 50, 64, 16, None, 0),     # hymba's shape
    (2, 2, 32, 16, 32, 16, None, 0),      # the reduced shape
    (2, 1, 15, 4, 32, 16, None, 0),       # Q = S < chunk
    (1, 2, 100, 3, 16, 100, None, 0),     # ragged Q and N
    (1, 2, 64, 24, 64, 128, 5, 7),        # unaligned head window
    (1, 1, 64, 24, 128, 32, 16, 8),       # hd 128, window at the end
    (1, 2, 256, 64, 32, 64, 5, 53),       # head groups 18, 18, 17
    (1, 2, 256, 24, 64, 128, 3, 19),      # a window inside one group
    (1, 2, 64, 6, 32, 50, None, 0),       # N 50: rows not 16-byte aligned
    (1, 2, 37, 4, 128, 64, None, 0),      # Q 37, hd 128
    (2, 1, 200, 9, 16, 24, None, 0),      # hd 16, Q 200
], ids=str)
def test_gpu_ssd_kernel_matches_plain(cuda, case):
    Bt, nc, Q, nh, hd, N, off, win = case
    args = [torch.from_numpy(a).to(cuda)
            for a in _inputs((Bt, nc), Q, nh, hd, N, seed=Q)]
    n = _build.LAUNCHES["ssd_chunk_intra"]
    got = ssd_chunk_intra(*args, head_offset=off, head_win=win)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ssd_chunk_intra"] == n + 1
    hs = slice(off or 0, (off or 0) + (win or nh))
    x, dt, A, B, C = args
    want = ref.ssd_chunk_intra_ref(x[..., hs, :], dt[..., hs], A[hs], B, C)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max() <= GPU_RTOL * w.abs().max()


@pytest.mark.gpu
def test_gpu_ssd_kernel_takes_strided_views(cuda):
    """x, dt, B and C as views with gaps between rows (unit stride along
    the last axis of x, B and C only)."""
    x, dt, A, B, C = [torch.from_numpy(a).to(cuda)
                      for a in _inputs((2, 2), 64, 6, 32, 48, seed=9)]
    xs = torch.cat([x, x], dim=-1)[..., :32]
    dts = torch.stack([dt, dt], dim=-1)[..., 0]
    Bs, Cs = (torch.cat([t, t], dim=-1)[..., :48] for t in (B, C))
    got = ssd_chunk_intra(xs, dts, A, Bs, Cs)
    want = ref.ssd_chunk_intra_ref(x, dt, A, B, C)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= GPU_RTOL * w.abs().max()


@pytest.mark.gpu
def test_gpu_ssd_kernel_is_deterministic(cuda):
    """Two launches on the same inputs give the same bits: one block sums
    each output in a fixed order, with no atomics."""
    args = [torch.from_numpy(a).to(cuda)
            for a in _inputs((2, 3), 256, 24, 64, 128, seed=3)]
    ya, sa = ssd_chunk_intra(*args)
    yb, sb = ssd_chunk_intra(*args)
    for a, b in ((ya, yb), (sa, sb)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
