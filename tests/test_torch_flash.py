"""The port's flash attention against the JAX reference's Pallas kernel.

On the CPU ``repro_torch.kernels.flash_attention.flash_attention`` runs its
plain version (``kernels.ref.flash_attention_ref``, a transcription of the
Pallas body); it is held against the reference's ``flash_attention``, run
in interpret mode as ``tests/test_kernels.py`` runs it, at that test's
shapes (a sliding window and a ragged block count among them) and with a
non-default ``softmax_scale``.  Tolerance: float32, atol 1e-5 and rtol
1e-5, as the reference's own test states -- the two sum the products of
q.k and p.v in different orders.

The ``gpu`` tests launch the CUDA kernel and hold it against the plain
version on the card (1e-4 of the output's largest magnitude: f32 both,
other summation orders and another softmax blocking); they decide inside
a fixture whether a card is present and import no JAX::

    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_flash.py
"""
import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402

ATOL = RTOL = 1e-5

# (B, S, H, KV, hd, bq, bkv, window): tests/test_kernels.py's shapes
SHAPES = [
    (2, 64, 4, 2, 16, 16, 16, 0),
    (1, 128, 8, 8, 32, 32, 32, 0),
    (2, 64, 4, 2, 16, 16, 16, 24),   # sliding window
    (1, 96, 6, 2, 8, 32, 32, 0),     # ragged block count
    (1, 64, 4, 2, 96, 32, 32, 0),    # head_dim 96 (phi_3_vision_4_2b)
]


@pytest.fixture(scope="module")
def jx():
    """The reference's kernel and oracle, imported at test time so that
    the ``gpu`` tests run where JAX is not installed."""
    jax = pytest.importorskip("jax")
    from repro.kernels.flash_attention import flash_attention as ref_flash
    from repro.models.attention import blockwise_attention
    return SimpleNamespace(jax=jax, jnp=jax.numpy, flash=ref_flash,
                           blockwise=blockwise_attention)


def _qkv(B, S, H, KV, hd, seed=0, Skv=None):
    rng = np.random.default_rng(seed)
    Skv = S if Skv is None else Skv
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("scale", [None, 0.3])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_plain_flash_matches_pallas_kernel(jx, shape, scale):
    B, S, H, KV, hd, bq, bkv, win = shape
    q, k, v = _qkv(B, S, H, KV, hd)
    want = jx.flash(jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v),
                    causal=True, window=win, bq=bq, bkv=bkv,
                    softmax_scale=scale, interpret=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True, window=win,
                          softmax_scale=scale)
    _close(got, want)
    # the transcription at the Pallas call's own blocks
    _close(flash_attention_ref(tq, tk, tv, causal=True, window=win,
                               softmax_scale=scale, bq=bq, bkv=bkv), want)


def test_fully_masked_rows_of_a_visited_block_wash_out(jx):
    """Window 24 with 16-wide blocks: the q block at 32..47 visits kv block
    0, where rows 39..47 see no key.  The Pallas body gives those rows
    exp(0) weights until their first visible key rescales them by exactly
    0; the transcription does the same, and both equal blockwise
    attention, which never visits such a row."""
    B, S, H, KV, hd, win = 1, 64, 4, 2, 16, 24
    q, k, v = _qkv(B, S, H, KV, hd, seed=3)
    want = jx.blockwise(*(jx.jnp.asarray(a) for a in (q, k, v)), causal=True,
                        window=win, q_chunk=16, kv_chunk=16)
    got = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True, window=win, bq=16, bkv=16)
    _close(got, want)


def _dense(q, k, v, causal, window, scale):
    """Masked softmax attention, written out in numpy (float64)."""
    G = q.shape[2] // k.shape[2]
    kk = np.repeat(k, G, axis=2).astype(np.float64)
    vv = np.repeat(v, G, axis=2).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) * scale
    qp = np.arange(q.shape[1])[:, None]
    kp = np.arange(k.shape[1])[None]
    ok = np.ones_like(s[0, 0], dtype=bool)
    if causal:
        ok &= qp >= kp
    if window:
        ok &= (qp - kp) < window
    s = np.where(ok, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, vv)


@pytest.mark.parametrize("S,window,causal,Skv", [
    (100, 0, True, None), (100, 30, True, None), (37, 0, False, 90),
    (100, 41, True, 60)])
def test_plain_flash_takes_any_length(S, window, causal, Skv):
    """No block divisibility: ragged lengths, a window, a non-causal call
    with more keys than queries, and more queries than keys with the last
    row seeing one key, against dense masked softmax."""
    q, k, v = _qkv(2, S, 6, 3, 8, seed=5, Skv=Skv)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal, window=window)
    _close(got, _dense(q, k, v, causal, window, 1 / math.sqrt(8)))


@pytest.mark.parametrize("bad", ["bf16", "grad", "stride", "groups",
                                 "head_dim", "no_key"])
def test_flash_refuses_bad_operands(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 4, 2, 8))
    err, window = ValueError, 0
    if bad == "bf16":
        q, err = q.bfloat16(), TypeError
    elif bad == "grad":
        q, err = q.requires_grad_(), NotImplementedError
    elif bad == "stride":
        q = q.transpose(2, 3)
    elif bad == "groups":
        k, v = k[:, :, :1].repeat(1, 1, 3, 1), v[:, :, :1].repeat(1, 1, 3, 1)
    elif bad == "head_dim":
        k, v = k[..., :4], v[..., :4]
    else:   # rows 12..15 lie past the window of every key
        k, v, window = k[:, :8], v[:, :8], 5
    with pytest.raises(err):
        flash_attention(q, k, v, window=window)


def test_flash_grad_error_names_the_roadmap_item():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 4, 2, 8))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        flash_attention(q, k.requires_grad_(), v)
    with torch.no_grad():       # no tape: the same tensors are fine
        flash_attention(q, k, v)


def test_cpu_flash_is_not_a_kernel_launch():
    before = dict(_build.LAUNCHES)
    flash_attention(*(torch.from_numpy(a) for a in _qkv(1, 32, 4, 2, 8)))
    assert dict(_build.LAUNCHES) == before


# -- the bf16 arm's arithmetic, emulated on the CPU ---------------------------


@pytest.fixture
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and a thread per core in each of them oversubscribes the
    machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_ulp(b):
    """One bf16 ulp of each element of ``b`` (0 where b is 0)."""
    mant, exp = torch.frexp(b)
    return torch.where(mant == 0, torch.zeros_like(b),
                       torch.ldexp(torch.ones_like(b), exp - 8))


def _two_part_flash(q, k, v, causal, window, bkv=64):
    """The bf16 arm's arithmetic (``csrc/flash_attn.cu``
    ``flash_attn_bf16_kernel``) in plain torch: the online softmax over
    ``bkv``-key tiles in f32 (q k^T of bf16 operands is exact in f32), P
    split into ``hi = bf16(P)`` and ``lo = bf16(P - hi)``, ``P v`` as the
    products of the two bf16 parts with bf16 v summed in f32, each tile's
    sum added to the rescaled output in f32, the output rounded once.
    Returns the output and every tile's (P, hi, lo)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    c = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, Sq, KV, G, hd)
    kf, vf = k.float(), v.float()
    i = torch.arange(Sq)[:, None]
    m = torch.full((B, KV, Sq, G), -1e30)
    l = torch.zeros((B, KV, Sq, G))
    o = torch.zeros((B, KV, Sq, G, hd))
    parts = []
    for t0 in range(0, Skv, bkv):
        j = torch.arange(t0, min(t0 + bkv, Skv))[None, :]
        s = torch.einsum("bqkgd,bjkd->bkqgj", qf, kf[:, t0:t0 + bkv]) * c
        ok = (j <= i) if causal else torch.ones_like(j == i)
        if window:
            ok = ok & (i - j < window)
        s = torch.where(ok[None, None, :, None, :], s, torch.tensor(-1e30))
        mn = torch.maximum(m, s.amax(-1))
        corr, p = torch.exp(m - mn), torch.exp(s - mn[..., None])
        hi = p.to(torch.bfloat16)
        lo = (p - hi.float()).to(torch.bfloat16)
        parts.append((p, hi, lo))
        vt = vf[:, t0:t0 + bkv]
        pv = (torch.einsum("bkqgj,bjkd->bkqgd", hi.float(), vt)
              + torch.einsum("bkqgj,bjkd->bkqgd", lo.float(), vt))
        o = o * corr[..., None] + pv
        l, m = l * corr + p.sum(-1), mn
    out = (o / l.clamp_min(1e-30)[..., None]).permute(0, 2, 1, 3, 4)
    return out.reshape(B, Sq, H, hd).to(torch.bfloat16), parts


@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (1, 200, 8, 2, 64, 0),        # GQA, G = 4, causal
    (1, 150, 10, 2, 128, 0),      # head_dim 128, G = 5
    (2, 180, 25, 5, 64, 64),      # Hymba's 25 on 5 heads under a window
    (1, 130, 4, 4, 32, 0),        # G = 1
])
def test_two_part_p_keeps_f32_p_accuracy(one_torch_thread, B, S, H, KV, hd,
                                         window):
    """The bf16 arm's ``P v`` rests on this arithmetic: P in [0, 1] split
    into two bf16 parts misses P by at most 2^-17 P, and ``P v`` from the
    two parts with bf16 v, summed in f32, stays within one bf16 ulp plus
    1e-4 of the largest output (the arm's card tolerance) of the plain
    version, which keeps P in f32."""
    q, k, v = (torch.from_numpy(2 * a).to(torch.bfloat16)
               for a in _qkv(B, S, H, KV, hd, seed=hd + H))
    got, parts = _two_part_flash(q, k, v, True, window)
    for p, hi, lo in parts:
        gap = (p.double() - hi.double() - lo.double()).abs()
        assert (gap <= 2.0 ** -17 * p.double()).all(), gap.max()
    want = flash_attention_ref(q, k, v, causal=True, window=window)
    a, b = got.float(), want.float()
    assert ((a - b).abs() <= _bf16_ulp(b) + 1e-4 * b.abs().max()).all(), \
        (a - b).abs().max()


# -- on the card: the CUDA kernel against its plain version -------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; none is present")
    return torch.device("cuda")


GPU_RTOL = 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # (B, Sq, Skv, H, KV, hd, causal, window)
    (2, 256, 256, 32, 4, 64, True, 0),       # TinyLlama's heads
    (2, 256, 256, 16, 2, 64, True, 0),       # its windowed sub-model
    (1, 300, 300, 8, 8, 32, True, 0),        # G = 1, ragged
    (2, 1000, 1000, 8, 2, 64, True, 512),    # sliding window, ragged
    (1, 130, 130, 4, 1, 128, True, 0),       # hd 128
    (1, 37, 90, 6, 3, 16, False, 0),         # non-causal, Sq != Skv
    (1, 100, 60, 4, 2, 16, True, 41),        # Sq > Skv, last row: 1 key
    (1, 64, 64, 256, 2, 8, True, 0),         # G = 128, one position/block
    (1, 2048, 2048, 16, 4, 128, True, 0),    # hd 128 at TinyLlama's context
    (1, 200, 200, 8, 2, 96, True, 0),        # hd 96 (phi_3_vision_4_2b)
    (1, 70, 300, 8, 2, 64, False, 0),        # Skv past the last key tile
    (1, 150, 150, 4, 1, 128, True, 50),      # hd 128, window, ragged Skv
    (1, 512, 512, 8, 8, 128, True, 0),       # G = 1 at hd 128 (deepseek_7b)
    (1, 512, 512, 10, 2, 128, True, 0),      # G = 5 at hd 128 (qwen3_14b)
    (1, 700, 700, 12, 2, 128, True, 256),    # G = 6, window (mixtral)
], ids=str)
def test_gpu_flash_kernel_matches_plain(cuda, case):
    B, Sq, Skv, H, KV, hd, causal, win = case
    g = torch.Generator(cuda).manual_seed(Sq)
    q = torch.randn((B, Sq, H, hd), device=cuda, generator=g)
    k = torch.randn((B, Skv, KV, hd), device=cuda, generator=g)
    v = torch.randn((B, Skv, KV, hd), device=cuda, generator=g)
    n = _build.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == n + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=win)
    assert (got - want).abs().max() <= GPU_RTOL * want.abs().max()


@pytest.mark.gpu
def test_gpu_flash_kernel_takes_strided_views(cuda):
    """q, k, v as head-major tensors seen through transposes (unit stride
    along head_dim only); the output is contiguous."""
    g = torch.Generator(cuda).manual_seed(7)
    q = torch.randn((2, 8, 200, 32), device=cuda, generator=g).transpose(1, 2)
    k = torch.randn((2, 2, 200, 32), device=cuda, generator=g).transpose(1, 2)
    v = torch.randn((2, 2, 200, 32), device=cuda, generator=g).transpose(1, 2)
    got = flash_attention(q, k, v, window=64, softmax_scale=0.2)
    want = flash_attention_ref(q, k, v, window=64, softmax_scale=0.2)
    assert got.is_contiguous()
    assert (got - want).abs().max() <= GPU_RTOL * want.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
def test_gpu_flash_kernel_is_deterministic(cuda, hd):
    """Two launches on the same inputs give the same bits: one block sums
    each output row in a fixed order, with no atomics."""
    g = torch.Generator(cuda).manual_seed(hd)
    q = torch.randn((2, 1000, 16, hd), device=cuda, generator=g)
    k = torch.randn((2, 1000, 4, hd), device=cuda, generator=g)
    v = torch.randn((2, 1000, 4, hd), device=cuda, generator=g)
    a = flash_attention(q, k, v, window=300)
    b = flash_attention(q, k, v, window=300)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek_7b", "qwen3_14b",
                                  "mixtral_8x22b"])
def test_gpu_zoo_eval_with_flash_matches_blockwise(cuda, arch):
    """One model's loss of the reduced zoo configs (MHA-like G = 2,
    ``qk_norm`` and a sliding window with MoE layers) on the card with
    ``REPRO_USE_FLASH`` set equals the blockwise loss within 1e-5
    relative, and launches the flash kernel once a layer."""
    import os

    from repro_torch.configs.base import get_reduced_config
    from repro_torch.models import build_model
    model = build_model(get_reduced_config(arch))
    params = model.init(0, device=cuda)
    g = torch.Generator(cuda).manual_seed(1)
    toks = torch.randint(0, model.cfg.vocab, (2, 128), device=cuda,
                         generator=g)
    old = os.environ.pop("REPRO_USE_FLASH", None)
    try:
        with torch.no_grad():
            plain = float(model.loss(params, {"tokens": toks})[0])
            n = _build.LAUNCHES["flash_attention"]
            os.environ["REPRO_USE_FLASH"] = "1"
            flash = float(model.loss(params, {"tokens": toks})[0])
    finally:
        os.environ.pop("REPRO_USE_FLASH", None)
        if old is not None:
            os.environ["REPRO_USE_FLASH"] = old
    assert _build.LAUNCHES["flash_attention"] == n + model.cfg.n_layers
    assert abs(flash - plain) <= 1e-5 * abs(plain)
