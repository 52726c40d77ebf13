"""bf16 parameters for the codebook streams (reduced MusicGen-large) and
the vision stub (reduced Phi-3-vision), held against the JAX reference at
bf16.

Reduced MusicGen-large: 2 layers, d_model 256, 8 heads on 4 kv heads of
32, gelu, sinusoidal positions, 4 codebooks of 512 (the embeddings summed,
a head each); reduced Phi-3-vision: the same widths with RoPE and the
vision stub (16 float32 patches of 64 projected through ``w1``, gelu and
``w2``, prepended).  Built with ``param_dtype`` bfloat16 in both packages,
on the CPU; the port starts from the reference's bf16 params (carried bit
for bit by ``convert``), with the reference's rolling offsets and
Bernoulli masks injected.  The rule in both: bf16 storage, every product
summed in float32 and rounded once to bf16.  Two places follow the
reference's own dtypes rather than that rule:

* the vision projector follows jnp's promotion of the float32 patches:
  ``w1`` and ``w2`` widened, both products and the gelu in float32, one
  rounding to bf16 where the rows join the token embeddings (at bf16 the
  port's ``torch.bmm`` of float32 patches and bf16 ``w1`` raised);
* the codebook embeddings are summed in bf16, one codebook after the
  other, and the sinusoidal positions rounded once to bf16 before their
  add, as the reference's ``h = h + ...`` in the embeddings' dtype.

Tolerances, each stated where it is used, as in
``tests/test_torch_bf16_ssm.py`` (none looser than the reference's bf16
rtol = atol = 2e-2, ``tests/test_kernels.py:18``):

* The embeddings (codebook sums, positions, patch rows) and the codebook
  head's logits against the reference's: one bf16 ulp plus 1e-6 of the
  largest magnitude (both round one float32 value, summed in other
  orders).
* ``Model.loss``: 5e-3.  Gradients: each leaf no farther from the
  reference's float32 gradient than the reference's bf16 one, plus 2e-2 of
  its norm.  Logits of prefill and decode: 2e-2 of the largest magnitude
  plus 2e-2 of each element's.
* Rounds: the params' change from the start within the gap 0.15 over all
  leaves and 0.4 a leaf of the reference's (unmoved params read 1); client
  losses within 5e-3.  Client lr 0.1.
* Inside the port the fused and the extract client phases agree to the
  bit at bf16, with codebooks and with patches.

The reference is imported inside the ``ref`` fixture, never at
collection, so the ``gpu`` test runs where JAX is not installed
(``--noconftest -m gpu``).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api, convert  # noqa: E402
from repro_torch.configs.base import (SubmodelConfig,  # noqa: E402
                                      get_reduced_config)
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import AxisWindow, WindowMap  # noqa: E402

BF = torch.bfloat16
ROUNDS, S, C = 3, 32, 2
CAP = 2e-2          # the reference's bf16 rtol and atol
LOSS_ATOL = 5e-3
# rounds: the params' change against the reference's (_delta_gaps)
DELTA_ALL, DELTA_LEAF, LEAF_MOVED = 0.15, 0.4, 1000
SCFG = dict(scheme="rolling", capacity=0.5, local_steps=2,
            clients_per_round=C, client_lr=0.1)
# the client lr of each family's rounds (the module docstring)
CLIENT_LR = {"musicgen_large": 0.1, "phi_3_vision_4_2b": 0.01}
ARCHS = ("musicgen_large", "phi_3_vision_4_2b")
# one model's windows: half the heads, kv heads and d_ff
WINDOW = {("heads", 8): (2, 4), ("kv_heads", 4): (1, 2),
          ("d_ff", 512): (128, 256)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes at once, and torch's pool of a thread per core in
    each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The reference's modules, imported here and not at collection."""
    import jax
    import jax.numpy as jnp

    from repro import api as ref_api
    from repro.configs.base import SubmodelConfig as RefSubmodelConfig
    from repro.configs.base import get_reduced_config as ref_reduced
    from repro.core.fedavg import dense_client_masks
    from repro.data.synthetic import lm_batches as ref_lm_batches
    from repro.models import build_model as ref_build
    return dict(jax=jax, jnp=jnp, api=ref_api, Scfg=RefSubmodelConfig,
                reduced=ref_reduced, masks=dense_client_masks,
                lm_batches=ref_lm_batches, build=ref_build)


def _np(ref, tree):
    return ref["jax"].tree_util.tree_map(np.asarray, tree)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _leaves(ref, tree):
    return dict(ref["jax"].tree_util.tree_leaves_with_path(tree))


def _bits(t):
    return t.contiguous().view(torch.int16 if t.dtype == BF else torch.int32)


def _ulp(b):
    """One bf16 ulp of each element of ``b`` (float32 numpy): 2^-7 of the
    power of two at or below its magnitude; 0 at 0."""
    m, e = np.frexp(b)
    return np.where(m == 0, 0.0, np.ldexp(1.0, e - 8)).astype(np.float32)


def _within_ulp(got, want, slack=1e-6):
    """Within one bf16 ulp of ``want`` plus ``slack`` of its largest
    magnitude."""
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


def _grad_within_reference_noise(g, w, t, what=""):
    """``|g - t| <= |w - t| + CAP |t|`` (Euclidean norms): the port's bf16
    gradient ``g`` no farther from the reference's float32 gradient ``t``
    than the reference's bf16 gradient ``w``, plus 2e-2 of ``t``."""
    g, w, t = _f32(g), _f32(w), _f32(t)
    assert np.isfinite(g).all(), what
    lhs = float(np.linalg.norm(g - t))
    rhs = float(np.linalg.norm(w - t) + CAP * np.linalg.norm(t))
    assert lhs <= rhs, (what, lhs, rhs)


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


def _vision(cfg):
    return (cfg.vision_patches, cfg.vision_d) if cfg.vision_stub else None


def _torch_batch(batch, lead=0):
    """A reference batch for the port: tokens as long, patches float32."""
    return {k: (torch.as_tensor(np.asarray(v), dtype=torch.long)
                if k == "tokens" else torch.as_tensor(np.asarray(v)))
            for k, v in batch.items()}


class Pair:
    """A reduced config in both packages at bf16 (and the reference's
    float32 model, for the exact gradient), the reference's params."""

    def __init__(self, ref, arch):
        self.ref_mod, self.arch = ref, arch
        self.rc = ref["reduced"](arch)
        jnp = ref["jnp"]
        self.ref = ref["build"](self.rc, remat=False,
                                param_dtype=jnp.bfloat16)
        self.ref32 = ref["build"](self.rc, remat=False)
        self.port = build_model(get_reduced_config(arch), param_dtype=BF)
        self.params0 = _np(ref, self.ref.init(ref["jax"].random.PRNGKey(0)))

    def params(self):
        p = convert.from_reference(self.params0, "cpu")
        assert {v.dtype for v in p.values()} == {BF}
        return p

    def jparams(self):
        return self.ref_mod["jax"].tree_util.tree_map(
            self.ref_mod["jnp"].asarray, self.params0)

    def batch(self, batch_shape, seq, seed):
        """A reference ``lm_batches`` draw: tokens (``[..., S, CB]`` with
        codebooks) and, for the vision stub, float32 patches."""
        return next(self.ref_mod["lm_batches"](
            self.rc.vocab, batch_shape, seq, seed=seed,
            codebooks=self.rc.n_codebooks, vision=_vision(self.rc)))


@pytest.fixture(scope="module")
def pairs(ref):
    return {arch: Pair(ref, arch) for arch in ARCHS}


def _jbatch(ref, batch):
    return {k: ref["jnp"].asarray(v) for k, v in batch.items()}


# -- the embeddings and the codebook head -------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_embeddings_and_head_match_reference_at_bf16(ref, pairs, arch):
    """The embeddings at bf16 (MusicGen: four codebook rows summed in bf16
    and the sinusoidal positions rounded once before their add;
    Phi-3-vision: the float32 patches through the widened projector, one
    rounding, before the token rows) and MusicGen's codebook head on the
    reference's hidden state, against the reference's ``_embed`` and
    ``_head`` within one bf16 ulp plus 1e-6 of the largest magnitude."""
    pair = pairs[arch]
    batch = pair.batch((2,), 24, seed=5)
    want = pair.ref._embed(pair.jparams(), ref["jnp"].asarray(
        batch["tokens"]), _jbatch(ref, batch))
    tb = _torch_batch(batch)
    p1, _ = pair.port._one_model(pair.params(), None)
    with torch.no_grad():
        got = pair.port._embed(p1, tb["tokens"][None],
                               pair.port._patches(tb, True))[0]
    assert got.dtype == BF and str(want.dtype) == "bfloat16"
    assert got.shape == want.shape
    _within_ulp(got, want)
    if pair.rc.n_codebooks:
        want = pair.ref._head(pair.jparams(), want)
        with torch.no_grad():
            got = pair.port._head(p1, convert.as_torch(np.asarray(
                pair.ref._embed(pair.jparams(), ref["jnp"].asarray(
                    batch["tokens"]), None)))[None])[0]
        assert got.dtype == BF and got.shape == want.shape
        _within_ulp(got, want)


@pytest.mark.parametrize("windowed", [False, True],
                         ids=["whole", "windowed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_loss_matches_reference_at_bf16(ref, pairs, arch, windowed):
    """One model's ``Model.loss`` at bf16 with codebooks or patches (their
    logits dropped), whole and through a sub-model window (half the heads,
    kv heads and d_ff), against the reference's within LOSS_ATOL."""
    pair = pairs[arch]
    batch = pair.batch((2,), 64, seed=1)
    win = WINDOW if windowed else None
    want, _ = pair.ref.loss(pair.jparams(), _jbatch(ref, batch), window=win)
    with torch.no_grad():
        got, _ = pair.port.loss(pair.params(), _torch_batch(batch),
                                window=win)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= LOSS_ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_windowed_grad_matches_reference_at_bf16(ref, pairs, arch):
    """The sub-model loss's gradient through the window in the clients'
    form (C = 1: rows 5-8 at bf16), bf16 leaves (``vision_proj/w1`` and
    ``w2`` too, through their widening), against ``jax.grad`` of the
    reference's (:func:`_grad_within_reference_noise`)."""
    jax, jnp = ref["jax"], ref["jnp"]
    pair = pairs[arch]
    batch = pair.batch((2,), 32, seed=2)

    def ref_grad(model, params):
        return _np(ref, jax.jit(jax.grad(lambda p: model.loss(
            p, _jbatch(ref, batch), window=WINDOW)[0]))(
            jax.tree_util.tree_map(jnp.asarray, params)))
    want = _leaves(ref, ref_grad(pair.ref, pair.params0))
    exact = _leaves(ref, ref_grad(pair.ref32, jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), pair.params0)))
    params = {k: v[None].requires_grad_() for k, v in pair.params().items()}
    tb = {k: v[None] for k, v in _torch_batch(batch).items()}
    wmap = WindowMap({k: AxisWindow([o], w) for k, (o, w) in WINDOW.items()})
    loss, _ = pair.port.loss(params, tb, window=wmap)
    grads = {k: g[0] for k, g in zip(params, torch.autograd.grad(
        loss.sum(), list(params.values())))}
    assert {g.dtype for g in grads.values()} == {BF}
    got = _leaves(ref, convert.to_reference(grads))
    for path, w in want.items():
        _grad_within_reference_noise(got[path], w, exact[path], str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_at_bf16(ref, pairs, arch):
    """Prefill with the codebook prompts or the patches, then 4
    teacher-forced decode steps on the cache it returns (positions after
    the patches), and a step from the default ``init_cache``: bf16 logits,
    each within 2e-2 of the largest plus 2e-2 of its own; the caches
    bf16, as the reference's."""
    jax, jnp = ref["jax"], ref["jnp"]
    pair = pairs[arch]
    P = pair.rc.vision_patches if pair.rc.vision_stub else 0
    batch = pair.batch((2,), 36, seed=3)
    toks = batch["tokens"]
    extra = {"patches": batch["patches"]} if P else None
    jp = pair.jparams()
    want, rcache = pair.ref.prefill(
        jp, jnp.asarray(toks[:, :32]), _jbatch(ref, extra) if P else None,
        max_len=P + 36)
    decode = jax.jit(pair.ref.decode_step)
    t = torch.as_tensor(toks, dtype=torch.long)
    with torch.no_grad():
        got, cache = pair.port.prefill(
            pair.params(), t[:, :32], _torch_batch(extra) if P else None,
            max_len=P + 36)
        assert got.dtype == BF and want.dtype == jnp.bfloat16
        assert {v.dtype for v in cache.values()} == {BF}
        _close_to_max(got, want, "prefill")
        for i in range(32, 36):
            want, rcache = decode(jp, jnp.asarray(toks[:, i]), rcache, P + i)
            got, cache = pair.port.decode_step(pair.params(), t[:, i], cache,
                                               P + i)
            assert got.dtype == BF
            _close_to_max(got, want, f"decode {i}")
        want, _ = decode(jp, jnp.asarray(toks[:, 0]),
                         pair.ref.init_cache(2, 16), 0)
        got, _ = pair.port.decode_step(
            pair.params(), t[:, 0], pair.port.init_cache(2, 16,
                                                         device="cpu"), 0)
        _close_to_max(got, want, "decode from init_cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_at_bf16(pairs, arch):
    """``serve.generate`` at bf16 with codebook prompts or patches: bf16
    logits, finite, of the expected shapes."""
    pair = pairs[arch]
    batch = pair.batch((2,), 8, seed=4)
    extra = ({"patches": torch.as_tensor(batch["patches"])}
             if pair.rc.vision_stub else None)
    out = serve.generate(pair.port, pair.params(), torch.as_tensor(
        batch["tokens"], dtype=torch.long), 3, return_logits=True,
        extra=extra)
    cb = pair.rc.n_codebooks
    assert out["tokens"].shape == ((2, 3, cb) if cb else (2, 3))
    for t in out["logits"]:
        assert t.dtype == BF and bool(torch.isfinite(t).all())


# -- rounds against the reference --------------------------------------------


@pytest.fixture(scope="module")
def reference_runs(ref, pairs):
    """Each family's bf16 rounds in the reference: 3 window rounds on its
    extract arm and 3 Bernoulli mask rounds, with the offsets and masks the
    port injects."""
    jax, jnp = ref["jax"], ref["jnp"]
    out = {}
    for arch, pair in pairs.items():
        model = pair.ref
        it = ref["lm_batches"](pair.rc.vocab, (2, C, 2), S, seed=0,
                               codebooks=pair.rc.n_codebooks,
                               vision=_vision(pair.rc))
        batches = [next(it) for _ in range(ROUNDS)]
        jb = [_jbatch(ref, b) for b in batches]
        runs = {}
        lr = {"client_lr": CLIENT_LR[arch]}
        fed = ref["api"].fed_round(model, ref["Scfg"](**{**SCFG, **lr}),
                                   kernel_backend="jnp", fused_forward="off")
        trainer = ref["api"].Trainer(fed, pair.jparams(), rng=1)
        params, history = trainer.run(iter(jb), ROUNDS)
        runs["window"] = dict(
            params=_np(ref, params),
            injected=[{"offsets": {k: [int(o) for o in np.asarray(v)]
                                   for k, v in fed.scheme.offsets(
                                       None, r, C).items()}}
                      for r in range(ROUNDS)],
            client_loss=[np.asarray(h["client_loss"]) for h in history])
        scfg = ref["Scfg"](**{**SCFG, **lr, "scheme": "bernoulli"})
        fed = ref["api"].fed_round(model, scfg, mode="mask",
                                   kernel_backend="jnp")
        step = jax.jit(fed.round)
        key = jax.random.PRNGKey(1)
        params = pair.jparams()
        injected, losses = [], []
        for r in range(ROUNDS):
            key, sub = jax.random.split(key)
            injected.append({"masks": convert.from_reference(_np(
                ref, ref["masks"](sub, model.abstract_params(), model.axes(),
                                  scfg, fed.capacities, r)), "cpu", lead=1)})
            params, metrics = step(params, jb[r], r, sub)
            losses.append(np.asarray(metrics["client_loss"]))
        runs["mask"] = dict(params=_np(ref, params), injected=injected,
                            client_loss=losses)
        out[arch] = dict(batches=batches, runs=runs)
    return out


@pytest.mark.parametrize("case", [("window", dict(fused_forward="on")),
                                  ("window", dict(fused_forward="off")),
                                  ("mask", {})],
                         ids=["fused", "extract", "mask"])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_bf16_rounds_match_reference(ref, pairs, reference_runs, arch,
                                           case):
    """Three rounds from the reference's bf16 params on its offsets or
    masks (rolling at 0.5 on the default axes: d_ff, heads, kv heads),
    with codebooks or patches: the fused and the extract window rounds
    against the reference's extract arm, the Bernoulli mask round; params
    stay bf16, the client losses within LOSS_ATOL, and the params' change
    from the start within DELTA_ALL and DELTA_LEAF of the reference's
    (:func:`_delta_gaps`), which rounds that left the params where they
    were fail."""
    pair, (mode, kw) = pairs[arch], case
    data, run = reference_runs[arch], reference_runs[arch]["runs"][mode]
    scheme = "bernoulli" if mode == "mask" else "rolling"
    fed = api.fed_round(pair.port, SubmodelConfig(**{
        **SCFG, "scheme": scheme, "client_lr": CLIENT_LR[arch]}),
        mode=mode, device="cpu", **kw)
    if mode == "window":
        assert fed.use_fused == (kw["fused_forward"] == "on")
    trainer = api.Trainer(fed, pair.params())
    trainer.run(zip(data["batches"], run["injected"]), ROUNDS)
    for r, h in enumerate(trainer.history):
        np.testing.assert_allclose(h["client_loss"].numpy(),
                                   run["client_loss"][r], atol=LOSS_ATOL,
                                   rtol=0, err_msg=f"{arch} round {r}")
    assert {v.dtype for v in trainer.params.values()} == {BF}
    got = _leaves(ref, convert.to_reference(trainer.params))
    want = {k: _f32(v) for k, v in _leaves(ref, run["params"]).items()}
    p0 = {k: _f32(v) for k, v in _leaves(ref, pair.params0).items()}
    every, leaf = _delta_gaps(got, want, p0)
    assert every <= DELTA_ALL and leaf <= DELTA_LEAF, (every, leaf)
    # the same check fails rounds that left the params where they were
    assert min(_delta_gaps(p0, want, p0)) > DELTA_LEAF


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_equals_extract_to_the_bit_at_bf16(arch):
    """At bf16 the fused client phase (full copies through the windowed
    products' plain versions) and the extract phase (compact copies)
    agree bit for bit over 2 rolling rounds, with codebooks and with
    patches, as at f32."""
    cfg = get_reduced_config(arch)
    model = build_model(cfg, param_dtype=BF)
    it = lm_batches(cfg.vocab, (2, C, 2), S, seed=0,
                    codebooks=cfg.n_codebooks, vision=_vision(cfg))
    batches = [next(it) for _ in range(2)]
    out = {}
    for ff in ("on", "off"):
        fed = api.fed_round(model, SubmodelConfig(**SCFG), fused_forward=ff,
                            device="cpu")
        assert fed.use_fused == (ff == "on")
        trainer = api.Trainer(fed, model.init(0, device="cpu"))
        trainer.run(iter(batches), 2)
        out[ff] = trainer
    for a, b in zip(out["on"].history, out["off"].history):
        assert torch.equal(_bits(a["client_loss"]), _bits(b["client_loss"]))
    for k, v in out["on"].params.items():
        assert v.dtype == BF
        assert torch.equal(_bits(v), _bits(out["off"].params[k])), k


# -- the card -----------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 512, 32, 32, 96), (2, 256, 8, 8, 64)],
                         ids=["phi3_hd96", "musicgen_hd64"])
def test_gpu_row_13_bf16_at_vlm_and_audio_heads(shape):
    """Row 13's bf16 arm at Phi-3-vision's head_dim of 96 (G 1; its
    ``case 96`` instance) and MusicGen's 64 against its plain version on
    the same bf16 inputs: within one bf16 ulp plus 1e-4 of the largest
    output; one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; none is present")
    cuda = torch.device("cuda")
    B, S_, H, KV, hd = shape
    g = torch.Generator(cuda).manual_seed(hd)
    q, k, v = (torch.randn((B, S_, h, hd), device=cuda, generator=g)
               .to(BF) for h in (H, KV, KV))
    n = _build.LAUNCHES.get("flash_attention/bf16", 0)
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention/bf16"] == n + 1
    want = flash_attention_ref(q, k, v, causal=True)
    assert got.dtype == want.dtype == BF
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    bound = _ulp(want) + 1e-4 * np.abs(want).max()
    assert (np.abs(got - want) <= bound).all()
