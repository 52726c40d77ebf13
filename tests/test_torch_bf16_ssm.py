"""bf16 parameters for the SSM family and the hybrid block, held against
the JAX reference at bf16.

Reduced Mamba2-130M and reduced Hymba-1.5B (2 layers each) built with
``param_dtype`` bfloat16 in both packages, on the CPU; the port starts from
the reference's bf16 params (carried bit for bit by ``convert``), with the
reference's rolling offsets and Bernoulli masks injected.  The rule in
both: bf16 storage, every product summed in float32 and rounded once to
bf16; SSM states, client deltas, the server's mean delta and client
momentum in float32.  The kernels' plain versions are the CPU's rows 12
(SSD chunk block) and 13 (flash attention).

Tolerances, each stated where it is used, none looser than the
reference's own bf16 tolerance (``tests/test_kernels.py:18``, rtol = atol
= 2e-2):

* The plain bf16 arms of rows 12 and 13 against the Pallas bodies in
  interpret mode: y (the output) within one bf16 ulp plus 1e-6 of its
  largest magnitude (both round one float32 result, summed in other
  orders); row 12's float32 states within 1e-5 relative, plus 1e-5 of
  their largest magnitude.
* ``ssd_chunked`` (the differentiable route the rounds train through)
  against the reference's ``ssd_chunked`` at bf16: y within one bf16 ulp
  plus 1e-4 of its largest magnitude.  Both round ``M`` and ``sdecay`` to
  bf16 before their products; their float32 values differ by float32
  ulps between the frameworks (``exp``), so now and then one rounds to the
  neighbouring bf16 value and moves y by 2^-9 of one term (measured: 6.5e-5
  of the largest |y| at a chunk of 128).  ``ssd_chunk_scan`` (row 12 plus
  the recurrence) against ``ops.ssd_chunk_scan``: one ulp plus 1e-3 of the
  largest |y| (the entry states are rounded to bf16 before ``y_inter``, with
  the same effect; measured 2.6e-4).  The final states within 1e-5 relative
  plus 1e-5 of their largest magnitude.  On inputs whose partial sums
  cancel (each chunk's x of one sign, the next's of the other), both agree
  with the reference to within one ulp plus 1e-6 of the largest |y| (they
  measured 0): rounding ``C B^T`` or ``y_inter`` to bf16 before use (the
  port before this repair) misses there by up to 5e-3 of it.
* Gradients at bf16: every activation rounds to 8 mantissa bits, so a
  bf16 gradient lies 2-4% (in the Euclidean norm of each leaf) from the
  float32 gradient at the same params, the reference's as much as the
  port's (measured on these models: 1.2-4.4%; the reference's
  ``D_skip`` gradient 15%, a long bf16 reduction).  Each leaf of the port's
  bf16 gradient is held to lie no farther from the reference's float32
  gradient ``t`` than the reference's bf16 gradient ``w`` does, plus 2e-2
  of ``t``'s norm: ``|g - t| <= |w - t| + 2e-2 |t|``.
* ``Model.loss``: 5e-3 on losses near 6.3-6.8.  Logits of prefill and
  decode: 2e-2 of the largest magnitude plus 2e-2 of each element's (as
  ``tests/test_torch_bf16.py``).
* Rounds, held by the params' change from the starting params (as
  ``tests/test_torch_bf16.py``): ``|port - ref| / |ref - p0|`` over all
  leaves within 0.15 and for each leaf the reference moved in 1000
  elements or more within 0.4; params that did not move read 1.  Client
  losses within 5e-3.  Mamba2 trains at client lr 0.1 (measured 0.106 and
  0.266 for the window rounds, 0.055 and 0.167 for the mask rounds).
  Hymba trains at client lr 0.01: at 0.1 its bf16 rounds amplify rounding
  until the reference's own fused and extract arms lie 0.26 (all leaves)
  and 0.46 (a leaf) apart after 3 rounds, so no two implementations could
  be held within these limits there; at 0.01 the reference's two arms lie
  0.113 and 0.277 apart, and the port 0.132 and 0.339 from its extract arm
  (mask rounds 0.084 and 0.197).
* Flash evaluation at bf16 (row 13's plain version) against the
  reference's blockwise loss within 5e-3, and against the port's own
  blockwise loss within 1e-3 (both sum in float32 and round the output
  once; they differ in the order of the online softmax's blocks).
* Inside the port the fused and the extract client phases agree to the
  bit at bf16, as at f32.
"""
import math

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
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as ref_flash  # noqa: E402
from repro.kernels.ssd_chunk import ssd_chunk_intra as ref_intra  # noqa
from repro.models import build_model as ref_build  # noqa: E402
from repro.models.ssm import ssd_chunked as ref_ssd_chunked  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch.configs.base import (SubmodelConfig,  # noqa: E402
                                      get_reduced_config)
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa
from repro_torch.kernels.ssd_chunk import (ssd_chunk_intra,  # noqa: E402
                                           ssd_chunk_scan)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import AxisWindow, WindowMap  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402

BF = torch.bfloat16
ROUNDS, S, C = 3, 64, 4
CAP = 2e-2          # the reference's bf16 rtol and atol
LOSS_ATOL = 5e-3
FLASH_ATOL = 1e-3   # the port's flash eval against its blockwise eval
SSD_Y = 1e-4        # ssd_chunked's y: one ulp plus this of max |y|
SCAN_Y = 1e-3       # ssd_chunk_scan's y: one ulp plus this of max |y|
STATE_TOL = 1e-5    # float32 states, relative and of the largest
# rounds: the params' change against the reference's (_delta_gaps)
DELTA_ALL, DELTA_LEAF, LEAF_MOVED = 0.15, 0.4, 1000
ARCHS = ("mamba2_130m", "hymba_1_5b")
# the client lr of each family's rounds (the module docstring)
CLIENT_LR = {"mamba2_130m": 0.1, "hymba_1_5b": 0.01}
# one model's windows: half the SSM heads (and Hymba's d_ff)
WINDOWS = {"mamba2_130m": {("ssm_heads", 16): (4, 8)},
           "hymba_1_5b": {("ssm_heads", 16): (4, 8),
                          ("d_ff", 512): (64, 256)}}
PROMPT = {"mamba2_130m": 64, "hymba_1_5b": 96}   # Hymba's ring of 64 wraps


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


def _within_ulp(got, want, slack):
    """Within one bf16 ulp of ``want`` plus ``slack`` of its largest
    magnitude."""
    got, want = _f32(got), _f32(want)
    d = np.abs(got - want)
    bound = _ulp(want) + slack * np.abs(want).max()
    assert (d <= bound).all(), float((d - bound).max())


def _states_close(got, want):
    want = _f32(want)
    np.testing.assert_allclose(_f32(got), want, rtol=STATE_TOL,
                               atol=STATE_TOL * np.abs(want).max())


def _close_to_max(got, want, what=""):
    """Within 2e-2 of the tensor's largest magnitude plus 2e-2 of each
    element's."""
    got, want = _f32(got), _f32(want)
    bound = CAP * np.abs(want).max() + CAP * np.abs(want)
    assert (np.abs(got - want) <= bound).all(), (
        what, float((np.abs(got - want) - bound).max()))


def _bf16(*arrays):
    """numpy float32 arrays rounded once to bf16, as (jax, torch) pairs."""
    b = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    return b, [convert.as_torch(np.asarray(a)) for a in b]


# -- the plain bf16 arms of rows 12 and 13 against the Pallas bodies ----------


def _intra_inputs(seed, Bt=2, nc=2, Q=32, nh=8, hd=16, N=16):
    rng = np.random.default_rng(seed)
    f = (lambda *s: rng.standard_normal(s).astype(np.float32))  # noqa
    (x, dt, B, Cm), (tx, tdt, tB, tC) = _bf16(
        0.5 * f(Bt, nc, Q, nh, hd), np.log1p(np.exp(f(Bt, nc, Q, nh))),
        0.5 * f(Bt, nc, Q, N), 0.5 * f(Bt, nc, Q, N))
    A = (-np.exp(0.3 * f(nh))).astype(np.float32)
    return (x, dt, jnp.asarray(A), B, Cm), (tx, tdt, torch.from_numpy(A),
                                            tB, tC)


@pytest.mark.parametrize("window", [None, (4, 4, 4), (3, 5, 1)],
                         ids=["whole", "window_4_4", "odd_offset_3_5"])
def test_plain_ssd_chunk_bf16_matches_pallas_body(window):
    """Row 12's bf16 arm, plain version: x, dt, B and C bf16 (A float32)
    against the reference's Pallas ``ssd_chunk_intra`` at bf16 in
    interpret mode, whole and over a head window (an odd offset with the
    head block of 1); y bf16, the states float32."""
    jargs, targs = _intra_inputs(7)
    if window is None:
        want_y, want_s = ref_intra(*jargs, interpret=True)
        got_y, got_s = ssd_chunk_intra(*targs)
    else:
        off, win, blk = window
        want_y, want_s = ref_intra(*jargs, nh_block=blk, interpret=True,
                                   head_offset=off, head_win=win)
        got_y, got_s = ssd_chunk_intra(*targs, head_offset=off,
                                       head_win=win)
    assert got_y.dtype == BF and want_y.dtype == jnp.bfloat16
    assert got_s.dtype == torch.float32 and want_s.dtype == jnp.float32
    _within_ulp(got_y, want_y, 1e-6)
    _states_close(got_s, want_s)


@pytest.mark.parametrize("case", [(4, 4, 0), (4, 2, 24), (6, 2, 0)],
                         ids=["causal", "window_24_gqa", "gqa_3"])
def test_plain_flash_bf16_matches_pallas_body(case):
    """Row 13's bf16 arm, plain version: q, k and v bf16 against the
    reference's Pallas ``flash_attention`` at bf16 in interpret mode
    (blocks of 16), causal, under a sliding window and with GQA groups;
    the output bf16."""
    H, KV, window = case
    rng = np.random.default_rng(H + window)
    (q, k, v), (tq, tk, tv) = _bf16(
        2.0 * rng.standard_normal((1, 64, H, 16)).astype(np.float32),
        2.0 * rng.standard_normal((1, 64, KV, 16)).astype(np.float32),
        rng.standard_normal((1, 64, KV, 16)).astype(np.float32))
    want = ref_flash(q, k, v, causal=True, window=window, bq=16, bkv=16,
                     interpret=True)
    got = flash_attention(tq, tk, tv, causal=True, window=window)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    _within_ulp(got, want, 1e-6)


def _two_part_ssd(x, dt, A, B, C):
    """Row 12's bf16 kernel's arithmetic (``csrc/ssd_chunk.cu``
    ``ssd_bf16_kernel``) in plain torch: ``C B^T`` of the bf16 operands
    summed in float32 (exact products), ``M = C B^T * decay * dt`` and the
    state's weighted operand ``x * w`` (``w_t = exp(L_last - L_t) dt_t``) in
    float32, each split into ``hi = bf16(v)`` and ``lo = bf16(v - hi)``,
    their products with bf16 x (and B) summed in float32, y rounded once.
    Returns ``(y, states)`` and the ``(v, hi, lo)`` of M and of ``x w``."""
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B, C))
    Q = x.shape[2]
    L = torch.cumsum(dtf * A, dim=2)                        # [Bt,nc,Q,nh]
    CB = torch.einsum("bcqn,bctn->bcqt", Cf, Bf)
    diff = L[:, :, :, None, :] - L[:, :, None, :, :]       # [.., q, t, nh]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    decay = torch.where(causal[:, :, None], torch.exp(diff), 0.0)
    M = CB[..., None] * decay * dtf[:, :, None, :, :]      # [.., q, t, nh]

    def split(v):
        hi = v.to(torch.bfloat16)
        return hi, (v - hi.float()).to(torch.bfloat16)

    mh, ml = split(M)
    y = (torch.einsum("bcqth,bcthp->bcqhp", mh.float(), xf)
         + torch.einsum("bcqth,bcthp->bcqhp", ml.float(), xf))
    w = torch.exp(L[:, :, -1:, :] - L) * dtf                # [Bt,nc,Q,nh]
    xw = xf * w[..., None]
    xh, xl = split(xw)
    states = (torch.einsum("bcthp,bctn->bchpn", xh.float(), Bf)
              + torch.einsum("bcthp,bctn->bchpn", xl.float(), Bf))
    return (y.to(torch.bfloat16), states), [(M, mh, ml), (xw, xh, xl)]


@pytest.mark.parametrize("shape", [(1, 2, 256, 3, 64, 128),
                                   (1, 2, 128, 4, 64, 16),
                                   (2, 1, 100, 2, 32, 16)],
                         ids=["mamba2_reduced", "hymba_n16", "ragged_q100"])
def test_two_part_ssd_keeps_the_pallas_body_accuracy(shape):
    """Row 12's bf16 kernel rests on this arithmetic: M and the state's
    weighted operand ``x w`` split into two bf16 parts miss their float32
    values by at most 2^-17 of them (plus 2^-126, where a decay factor is
    subnormal), and y and the states formed from the
    parts with bf16 x and B, summed in float32, stay within the kernel's
    card tolerance of the reference's Pallas body at bf16 (interpret mode):
    y within one bf16 ulp plus 1e-4 of its largest magnitude, the float32
    states within 1e-4 of theirs.  At Mamba2's chunk, head_dim and d_state
    (fewer heads and chunks), at Hymba's d_state of 16, and at a ragged
    chunk of 100."""
    Bt, nc, Q, nh, hd, N = shape
    jargs, targs = _intra_inputs(Q + N, Bt=Bt, nc=nc, Q=Q, nh=nh, hd=hd, N=N)
    (got_y, got_s), parts = _two_part_ssd(*targs)
    for v, hi, lo in parts:   # (decay factors below 2^-126 are subnormal)
        gap = (v.double() - hi.double() - lo.double()).abs()
        assert (gap <= 2.0 ** -17 * v.double().abs() + 2.0 ** -126).all()
    want_y, want_s = ref_intra(*jargs, interpret=True)
    _within_ulp(got_y, want_y, 1e-4)
    want_s = _f32(want_s)
    assert np.abs(_f32(got_s) - want_s).max() <= 1e-4 * np.abs(want_s).max()


def test_rows_12_13_refuse_mixed_dtypes():
    """Both take their operands all float32 or all bf16 (row 12's A always
    float32); nothing widens a mixed call."""
    _, (x, dt, A, B, Cm) = _intra_inputs(1, nh=2)
    with pytest.raises(TypeError, match="one dtype"):
        ssd_chunk_intra(x, dt.float(), A, B, Cm)
    with pytest.raises(TypeError, match="float32 A"):
        ssd_chunk_intra(x, dt, A.to(BF), B, Cm)
    with pytest.raises(TypeError, match="one dtype"):
        ssd_chunk_intra(x.float(), dt.float(), A, B.float(), Cm)
    q = torch.zeros(1, 16, 2, 8, dtype=BF)
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention(q, q.float(), q)
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention(q.half(), q.half(), q.half())


# -- the repair: the chunked SSD sums its products in float32 -----------------


def _ssd_inputs(seed, B=2, S_=128, nh=4, hd=16, N=16):
    rng = np.random.default_rng(seed)
    f = (lambda *s: rng.standard_normal(s).astype(np.float32))  # noqa
    (x, dt, Bm, Cm), (tx, tdt, tB, tC) = _bf16(
        f(B, S_, nh, hd), np.log1p(np.exp(f(B, S_, nh))), f(B, S_, N),
        f(B, S_, N))
    A = (-np.exp(0.5 * f(nh))).astype(np.float32)
    return (x, dt, jnp.asarray(A), Bm, Cm), [tx, tdt, torch.from_numpy(A),
                                             tB, tC]


def _cancelling_inputs(Q, seed=3, S_=64, nh=2, hd=8, N=16):
    """Positive B, C and dt, A near 0, and each chunk's x of one sign, the
    next chunk's of the other: in the second chunk ``y_inter`` (the first
    chunk's state) and ``y_intra`` cancel, so their rounding shows in y."""
    rng = np.random.default_rng(seed)
    sign = np.where((np.arange(S_) // Q) % 2 == 0, 1.0, -1.0)
    x = (1 + rng.random((1, S_, nh, hd))) * sign[None, :, None, None]
    (jx, jdt, jB, jC), (tx, tdt, tB, tC) = _bf16(
        x.astype(np.float32), 0.5 + rng.random((1, S_, nh), np.float32),
        0.5 + rng.random((1, S_, N), np.float32),
        0.5 + rng.random((1, S_, N), np.float32))
    A = np.full((nh,), -1e-3, np.float32)
    return (jx, jdt, jnp.asarray(A), jB, jC), [tx, tdt, torch.from_numpy(A),
                                               tB, tC]


@pytest.mark.parametrize("chunk", [32, 128])
def test_ssd_chunked_matches_reference_at_bf16(chunk):
    """The differentiable ``ssd_chunked`` at bf16 (its products summed in
    float32, ``M`` and ``sdecay`` rounded to bf16 first, as the
    reference's casts do) against the reference's: y within one ulp plus
    SSD_Y of its largest magnitude, the final state within STATE_TOL."""
    jargs, targs = _ssd_inputs(0)
    want_y, want_h = ref_ssd_chunked(*jargs, chunk)
    got_y, got_h = ssd_chunked(*targs, chunk)
    assert got_y.dtype == BF and got_h.dtype == torch.float32
    _within_ulp(got_y, want_y, SSD_Y)
    _states_close(got_h, want_h)


def test_ssd_chunked_gradients_match_reference_at_bf16():
    """Its five gradients (x, dt, A, B, C) against ``jax.grad`` of the
    reference's at bf16, each leaf no farther from the reference's float32
    gradient than the reference's bf16 one, plus 2e-2 of its norm
    (:func:`_grad_within_reference_noise`)."""
    jargs, targs = _ssd_inputs(1, S_=64)
    rng = np.random.default_rng(2)
    wy = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)

    def grads(args):
        return jax.grad(lambda *a: jnp.sum(ref_ssd_chunked(*a, 32)[0]
                                           .astype(jnp.float32) * wy),
                        argnums=(0, 1, 2, 3, 4))(*args)
    want = grads(jargs)
    exact = grads([a.astype(jnp.float32) for a in jargs])
    ts = [t.clone().requires_grad_() for t in targs]
    y, _ = ssd_chunked(*ts, 32)
    got = torch.autograd.grad((y.float() * torch.from_numpy(wy)).sum(), ts)
    for name, g, w, t, leaf in zip(("x", "dt", "A", "B", "C"), got, want,
                                   exact, ts):
        assert g.dtype == leaf.dtype
        _grad_within_reference_noise(g, w, t, name)


def test_ssd_chunk_scan_matches_reference_at_bf16():
    """Row 12 (its plain version here) plus the recurrence at bf16:
    ``y_inter`` summed in float32 on the entry states rounded to bf16, as
    ``ops.ssd_chunk_scan`` (Pallas, interpret) does; y within one ulp plus
    SCAN_Y of its largest magnitude, the final state within STATE_TOL."""
    jargs, targs = _ssd_inputs(0)
    for chunk in (32, 128):
        want_y, want_h = ref_ops.ssd_chunk_scan(*jargs, chunk,
                                                interpret=True)
        got_y, got_h = ssd_chunk_scan(*targs, chunk)
        assert got_y.dtype == BF and got_h.dtype == torch.float32
        _within_ulp(got_y, want_y, SCAN_Y)
        _states_close(got_h, want_h)


def test_ssd_sums_in_f32_where_partial_sums_cancel():
    """On cancelling inputs both routes agree with the reference's to
    within one ulp plus 1e-6 of the largest |y|; rounding ``C B^T`` or
    ``y_inter`` to bf16 before use misses by up to 5e-3 of it."""
    jargs, targs = _cancelling_inputs(32)
    want_y, _ = ref_ssd_chunked(*jargs, 32)
    _within_ulp(ssd_chunked(*targs, 32)[0], want_y, 1e-6)
    want_y, _ = ref_ops.ssd_chunk_scan(*jargs, 32, interpret=True)
    _within_ulp(ssd_chunk_scan(*targs, 32)[0], want_y, 1e-6)


def _grad_within_reference_noise(g, w, t, what=""):
    """``|g - t| <= |w - t| + CAP |t|`` (Euclidean norms): the port's bf16
    gradient ``g`` no farther from the reference's float32 gradient ``t``
    than the reference's bf16 gradient ``w``, plus 2e-2 of ``t``."""
    g, w, t = _f32(g), _f32(w), _f32(t)
    assert np.isfinite(g).all(), what
    lhs = float(np.linalg.norm(g - t))
    rhs = float(np.linalg.norm(w - t) + CAP * np.linalg.norm(t))
    assert lhs <= rhs, (what, lhs, rhs)


# -- the models ---------------------------------------------------------------


class Pair:
    """A reduced config in both packages at bf16 (and the reference's
    float32 model, for the exact gradient), the reference's params."""

    def __init__(self, arch):
        self.arch = arch
        self.ref = ref_build(ref_reduced(arch), remat=False,
                             param_dtype=jnp.bfloat16)
        self.ref32 = ref_build(ref_reduced(arch), remat=False)
        self.port = build_model(get_reduced_config(arch), param_dtype=BF)
        self.params0 = _np(self.ref.init(jax.random.PRNGKey(0)))
        self.vocab = self.ref.cfg.vocab
        self.scfg = dict(scheme="rolling", capacity=0.5, local_steps=2,
                         clients_per_round=C, client_lr=CLIENT_LR[arch])

    def params(self):
        p = convert.from_reference(self.params0, "cpu")
        assert {v.dtype for v in p.values()} == {BF}
        return p

    def tokens(self, B, S_, seed):
        return np.random.default_rng(seed).integers(
            0, self.vocab, (B, S_)).astype(np.int32)


@pytest.fixture(scope="module")
def pairs():
    return {arch: Pair(arch) for arch in ARCHS}


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


@pytest.mark.parametrize("windowed", [False, True],
                         ids=["whole", "windowed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_loss_matches_reference_at_bf16(pairs, arch, windowed):
    """One model's ``Model.loss`` at bf16 (its SSM mixers through row 12's
    bf16 arm, plain here), whole and through a sub-model window (half the
    SSM heads; Hymba's d_ff too), against the reference's within
    LOSS_ATOL."""
    pair = pairs[arch]
    toks = pair.tokens(2, S, 1)
    win = WINDOWS[arch] if windowed else None
    want, _ = pair.ref.loss(jax.tree_util.tree_map(jnp.asarray,
                                                   pair.params0),
                            {"tokens": jnp.asarray(toks)}, window=win)
    with torch.no_grad():
        got, _ = pair.port.loss(pair.params(), {"tokens": _t(toks)},
                                window=win)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= LOSS_ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_windowed_grad_matches_reference_at_bf16(pairs, arch):
    """The sub-model loss's gradient through the window, in the clients'
    form (C = 1; the differentiable chunked SSD, rows 5-8 at bf16), bf16
    leaves, against ``jax.grad`` of the reference's
    (:func:`_grad_within_reference_noise`); exactly 0 outside the window
    in ``w_z``."""
    pair = pairs[arch]
    toks = pair.tokens(2, S, 2)
    win = WINDOWS[arch]

    def ref_grad(model, params):
        return _np(jax.grad(lambda p: model.loss(
            p, {"tokens": jnp.asarray(toks)}, window=win)[0])(
            jax.tree_util.tree_map(jnp.asarray, params)))
    want = _leaves(ref_grad(pair.ref, pair.params0))
    exact = _leaves(ref_grad(pair.ref32, jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), pair.params0)))
    params = {k: v[None].requires_grad_() for k, v in pair.params().items()}
    wmap = WindowMap({k: AxisWindow([o], w) for k, (o, w) in win.items()})
    loss, _ = pair.port.loss(params, {"tokens": _t(toks)[None]},
                             window=wmap)
    grads = {k: g[0] for k, g in zip(params, torch.autograd.grad(
        loss.sum(), list(params.values())))}
    assert {g.dtype for g in grads.values()} == {BF}
    got = _leaves(convert.to_reference(grads))
    for path, w in want.items():
        _grad_within_reference_noise(got[path], w, exact[path], str(path))
    stack = "ssm_layers" if arch == "mamba2_130m" else "layers"
    gz = grads[f"{stack}/0/ssm/w_z"]
    assert not gz[:, :4].any() and not gz[:, 12:].any()
    assert gz[:, 4:12].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_at_bf16(pairs, arch):
    """Prefill (row 12's bf16 arm; past Hymba's window, so its ring wraps),
    then 4 teacher-forced decode steps on the cache it returns, and a step
    from the default ``init_cache``: bf16 logits, each within 2e-2 of the
    largest plus 2e-2 of its own; the caches' SSM state ``h`` float32 and
    the rest bf16, as the reference's."""
    pair = pairs[arch]
    P = PROMPT[arch]
    toks = pair.tokens(2, P + 4, 3)
    jp = jax.tree_util.tree_map(jnp.asarray, pair.params0)
    params = pair.params()
    want, rcache = jax.jit(pair.ref.prefill, static_argnames=("max_len",))(
        jp, jnp.asarray(toks[:, :P]), max_len=P + 4)
    decode = jax.jit(pair.ref.decode_step)
    t = _t(toks)
    with torch.no_grad():
        got, cache = pair.port.prefill(params, t[:, :P], max_len=P + 4)
        assert got.dtype == BF and want.dtype == jnp.bfloat16
        for k, v in cache.items():
            assert v.dtype == (torch.float32 if k.endswith("/h") else BF), k
        ref_dtypes = {name: str(a.dtype) for stack in rcache.values()
                      for name, a in stack.items()}
        assert ref_dtypes["h"] == "float32" and ref_dtypes["conv_x"] == \
            "bfloat16"
        _close_to_max(got, want, "prefill")
        for pos in range(P, P + 4):
            want, rcache = decode(jp, jnp.asarray(toks[:, pos]), rcache, pos)
            got, cache = pair.port.decode_step(params, t[:, pos], cache, pos)
            assert got.dtype == BF
            _close_to_max(got, want, f"decode {pos}")
        want, _ = decode(jp, jnp.asarray(toks[:, 0]),
                         pair.ref.init_cache(2, 16), 0)
        got, _ = pair.port.decode_step(
            params, t[:, 0], pair.port.init_cache(2, 16, device="cpu"), 0)
        _close_to_max(got, want, "decode from init_cache")


@pytest.mark.parametrize("arch", ["hymba_1_5b", "tinyllama_1_1b"])
def test_flash_eval_at_bf16(pairs, arch, monkeypatch):
    """Evaluation with ``REPRO_USE_FLASH`` at bf16 (row 13's bf16 arm, its
    plain version here; Hymba's sliding window and its SSM branch through
    row 12): within LOSS_ATOL of the reference's blockwise loss and within
    FLASH_ATOL of the port's own blockwise loss."""
    if arch in pairs:
        pair = pairs[arch]
        ref_model, params0 = pair.ref, pair.params0
        model = pair.port
    else:
        ref_model = ref_build(ref_reduced(arch), remat=False,
                              param_dtype=jnp.bfloat16)
        params0 = _np(ref_model.init(jax.random.PRNGKey(0)))
        model = build_model(get_reduced_config(arch), param_dtype=BF)
    toks = np.random.default_rng(4).integers(
        0, ref_model.cfg.vocab, (2, 128)).astype(np.int32)
    want, _ = ref_model.loss(jax.tree_util.tree_map(jnp.asarray, params0),
                             {"tokens": jnp.asarray(toks)})
    params = convert.from_reference(params0, "cpu")
    with torch.no_grad():
        blockwise, _ = model.loss(params, {"tokens": _t(toks)})
        monkeypatch.setenv("REPRO_USE_FLASH", "1")
        flash, _ = model.loss(params, {"tokens": _t(toks)})
    assert abs(float(flash) - float(want)) <= LOSS_ATOL
    assert abs(float(flash) - float(blockwise)) <= FLASH_ATOL


def test_init_cache_dtypes_at_bf16(pairs):
    """The default caches: the SSM state ``h`` float32, the conv tails
    (and Hymba's ring ``k``, ``v``) bf16, shaped as the reference's."""
    for arch, pair in pairs.items():
        want = jax.eval_shape(lambda: pair.ref.init_cache(3, 40))
        got = pair.port.init_cache(3, 40, device="cpu")
        for stack in want.values():
            for name, sd in stack.items():
                for i in range(sd.shape[0]):
                    t = next(v for k, v in got.items()
                             if k.endswith(f"/{i}/{name}"))
                    assert tuple(t.shape) == sd.shape[1:], (arch, name)
                    assert str(t.dtype).split(".")[-1] == str(sd.dtype)


# -- rounds against the reference ------------------------------------------------


@pytest.fixture(scope="module")
def reference_runs(pairs):
    """Each family's bf16 rounds in the reference: 3 window rounds on its
    extract arm and 3 Bernoulli mask rounds, with the offsets and masks the
    port injects."""
    out = {}
    for arch, pair in pairs.items():
        model = pair.ref
        it = ref_lm_batches(pair.vocab, (2, C, 2), S, seed=0)
        batches = [next(it) for _ in range(ROUNDS)]
        jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
        runs = {}
        fed = ref_api.fed_round(model, RefSubmodelConfig(**pair.scfg),
                                kernel_backend="jnp", fused_forward="off")
        trainer = ref_api.Trainer(fed, jax.tree_util.tree_map(
            jnp.asarray, pair.params0), rng=1)
        params, history = trainer.run(iter(jb), ROUNDS)
        runs["window"] = dict(
            params=_np(params),
            injected=[{"offsets": {k: [int(o) for o in np.asarray(v)]
                                   for k, v in fed.scheme.offsets(
                                       None, r, C).items()}}
                      for r in range(ROUNDS)],
            client_loss=[np.asarray(h["client_loss"]) for h in history])
        scfg = RefSubmodelConfig(**{**pair.scfg, "scheme": "bernoulli"})
        fed = ref_api.fed_round(model, scfg, mode="mask",
                                kernel_backend="jnp")
        step = jax.jit(fed.round)
        key = jax.random.PRNGKey(1)
        params = jax.tree_util.tree_map(jnp.asarray, pair.params0)
        injected, losses = [], []
        for r in range(ROUNDS):
            key, sub = jax.random.split(key)
            injected.append({"masks": convert.from_reference(_np(ref_masks(
                sub, model.abstract_params(), model.axes(), scfg,
                fed.capacities, r)), "cpu", lead=1)})
            params, metrics = step(params, jb[r], r, sub)
            losses.append(np.asarray(metrics["client_loss"]))
        runs["mask"] = dict(params=_np(params), injected=injected,
                            client_loss=losses)
        out[arch] = dict(batches=batches, runs=runs)
    return out


def _delta_gaps(got, want, p0):
    """``|got - want| / |want - p0|`` (Euclidean norms, float32 numpy
    leaves by path) over all leaves together, and the largest over the
    leaves that ``want`` moved in LEAF_MOVED elements or more.  A ``got``
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


@pytest.mark.parametrize("case", [("window", dict(fused_forward="on")),
                                  ("window", dict(fused_forward="off")),
                                  ("mask", {})],
                         ids=["fused", "extract", "mask"])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_bf16_rounds_match_reference(pairs, reference_runs, arch,
                                           case):
    """Three rounds from the reference's bf16 params on its offsets or
    masks: the fused and the extract window rounds against the reference's
    extract arm, the Bernoulli mask round; params stay bf16, the client
    losses within LOSS_ATOL, and the params' change from the start within
    DELTA_ALL and DELTA_LEAF of the reference's (:func:`_delta_gaps`),
    which rounds that left the params where they were fail."""
    pair, (mode, kw) = pairs[arch], case
    ref, run = reference_runs[arch], reference_runs[arch]["runs"][mode]
    scheme = "bernoulli" if mode == "mask" else "rolling"
    fed = api.fed_round(pair.port, SubmodelConfig(**{**pair.scfg,
                                                     "scheme": scheme}),
                        mode=mode, device="cpu", **kw)
    if mode == "window":
        assert fed.use_fused == (kw["fused_forward"] == "on")
    trainer = api.Trainer(fed, pair.params())
    trainer.run(zip(ref["batches"], run["injected"]), ROUNDS)
    for r, h in enumerate(trainer.history):
        np.testing.assert_allclose(h["client_loss"].numpy(),
                                   run["client_loss"][r], atol=LOSS_ATOL,
                                   rtol=0, err_msg=f"{arch} round {r}")
    assert {v.dtype for v in trainer.params.values()} == {BF}
    got = _leaves(convert.to_reference(trainer.params))
    want = {k: _f32(v) for k, v in _leaves(run["params"]).items()}
    p0 = {k: _f32(v) for k, v in _leaves(pair.params0).items()}
    every, leaf = _delta_gaps(got, want, p0)
    assert every <= DELTA_ALL and leaf <= DELTA_LEAF, (every, leaf)
    # the same check fails rounds that left the params where they were
    assert min(_delta_gaps(p0, want, p0)) > DELTA_LEAF


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_equals_extract_to_the_bit_at_bf16(pairs, arch):
    """At bf16 the fused client phase (full copies through the windowed
    products' plain versions) and the extract phase (compact copies)
    agree bit for bit over 3 rolling rounds, as at f32."""
    pair = pairs[arch]
    model = pair.port
    it = lm_batches(pair.vocab, (2, C, 2), S, seed=0)
    batches = [next(it) for _ in range(ROUNDS)]
    out = {}
    for ff in ("on", "off"):
        fed = api.fed_round(model, SubmodelConfig(**pair.scfg),
                            fused_forward=ff, device="cpu")
        assert fed.use_fused == (ff == "on")
        trainer = api.Trainer(fed, model.init(0, device="cpu"))
        trainer.run(iter(batches), ROUNDS)
        out[ff] = trainer
    for a, b in zip(out["on"].history, out["off"].history):
        assert torch.equal(a["client_loss"], b["client_loss"])
    for k, v in out["on"].params.items():
        assert v.dtype == BF
        assert torch.equal(v.view(torch.int16),
                           out["off"].params[k].view(torch.int16)), k
