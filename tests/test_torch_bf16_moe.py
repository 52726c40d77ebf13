"""bf16 parameters for the MoE family and MLA, held against the JAX
reference at bf16, and the router's tie order.

Reduced Mixtral-8x22B (2 MoE layers of 4 experts, top-2, softmax routing,
a sliding window of 64) and reduced DeepSeek-V3 (a leading dense layer
and an MoE layer of 4 experts, top-2, a shared expert, sigmoid routing;
MLA with ranks q 64 / kv 64, rope 16, nope 32, v 32; the MTP block), built
with ``param_dtype`` bfloat16 in both packages, on the CPU; the port
starts from the reference's bf16 params (carried bit for bit by
``convert``), with the reference's rolling offsets and Bernoulli masks
injected.  The MoE layers run the ``dropping`` path at a capacity factor
of n_experts / top_k (every expert holds every token: the reference's
dispatch zeroes an overflowing expert's first token, ROADMAP.md §C), and
Mixtral's one model also on ``dense``.  The rule in both: bf16 storage,
every product summed in float32 and rounded once to bf16, the router's
logits rounded to bf16 before the float32 softmax or sigmoid.

The router's tie order (ROADMAP.md §C, C9): ``jax.lax.top_k`` gives tied
scores to the lower index first, ``torch.topk`` does not; the port takes
the top k by a stable descending sort.  Held by hand-built ties at
float32 and bf16 for both routers, and by ``_route`` against the
reference's on bf16 inputs whose products are exact (so that both round
the same float32 logits), over tokens where ties occur.

Tolerances, each stated where it is used, none looser than the
reference's own bf16 tolerance (``tests/test_kernels.py:18``, rtol = atol
= 2e-2), as in ``tests/test_torch_bf16_ssm.py``:

* ``Model.loss``: 5e-3.  Gradients: each leaf of the port's bf16
  gradient no farther from the reference's float32 gradient ``t`` than
  the reference's bf16 gradient ``w``, plus 2e-2 of ``t``'s norm.  Logits
  of prefill and decode: 2e-2 of the largest magnitude plus 2e-2 of each
  element's.
* Rounds: the params' change from the start, ``|port - ref| / |ref -
  p0|``, within 0.15 over all leaves and 0.4 for each leaf moved in 1000
  elements or more; params that did not move read 1.  Client losses
  within 5e-3.  Client lr 0.01, 2 x 64 tokens a client step: at 0.1 the
  reference's own fused and extract arms part by 7.1e-3 (Mixtral) and
  1.0e-2 (DeepSeek-V3) on the client losses; and a routing flip (a token
  whose k-th and next logits lie within a bf16 ulp, which the two
  frameworks' activations round apart: 2 of 64 tokens in a layer of
  reduced Mixtral's mask round) moves a client's loss by about 0.4 / its
  tokens, 6.5e-3 on 64.  Measured: losses within 2.2e-3 (window) and
  2.9e-3 (mask), gaps 0.070-0.074 over all leaves, 0.18-0.26 a leaf.
* The continuous batcher at bf16 against single-request decoding inside
  the port: 2e-2 of each request's largest logit (the two decode a token
  in batches of other sizes, whose bf16 activations round apart).
* Inside the port the fused and the extract client phases agree to the
  bit at bf16, on both MoE paths and through MLA's ``heads`` window.

The reference is imported inside the ``ref`` fixture, never at
collection, so the ``gpu`` tests run where JAX is not installed
(``--noconftest -m gpu``).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api, convert  # noqa: E402
from repro_torch.configs.base import (MoEConfig, SubmodelConfig,  # noqa
                                      get_reduced_config)
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rolling_matmul import (  # noqa: E402
    make_offsets, rolling_matmul_batched)
from repro_torch.launch.batching import ContinuousBatcher  # noqa: E402
from repro_torch.launch.specs import request_queue  # noqa: E402
from repro_torch.models import build_model, moe  # noqa: E402
from repro_torch.models.layers import AxisWindow, WindowMap  # noqa: E402

BF = torch.bfloat16
ROUNDS, S, C = 3, 64, 2
CAP = 2e-2          # the reference's bf16 rtol and atol
LOSS_ATOL = 5e-3
# rounds: the params' change against the reference's (_delta_gaps)
DELTA_ALL, DELTA_LEAF, LEAF_MOVED = 0.15, 0.4, 1000
SCFG = dict(scheme="rolling", capacity=0.5, local_steps=2,
            clients_per_round=C, client_lr=0.1)
# the client lr of each family's rounds against the reference (the module
# docstring)
CLIENT_LR = {"mixtral_8x22b": 0.01, "deepseek_v3_671b": 0.01}
ARCHS = ("mixtral_8x22b", "deepseek_v3_671b")
MODELS = [("mixtral_8x22b", "dense"), ("mixtral_8x22b", "dropping"),
          ("deepseek_v3_671b", "dropping")]
# one model's windows: half the experts, the expert width, the heads
WINDOWS = {"mixtral_8x22b": {("experts", 4): (1, 2), ("moe_d_ff", 256):
                             (64, 128), ("heads", 8): (2, 4),
                             ("kv_heads", 4): (1, 2)},
           "deepseek_v3_671b": {("experts", 4): (2, 2), ("moe_d_ff", 256):
                                (128, 128), ("heads", 8): (4, 4),
                                ("d_ff", 512): (96, 256)}}
PROMPT = {"mixtral_8x22b": 96, "deepseek_v3_671b": 48}   # Mixtral's ring
# of 64 wraps


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes at once, and torch's pool of a thread per core in
    each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _roomy(cfg):
    """``cfg`` with the dispatch capacity factor n_experts / top_k: every
    expert holds every token, so no choice is dropped."""
    mo = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        mo, capacity_factor=mo.n_experts / mo.top_k))


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
    from repro.models import moe as ref_moe
    jax.config.update("jax_enable_x64", False)
    return dict(jax=jax, jnp=jnp, api=ref_api, Scfg=RefSubmodelConfig,
                reduced=ref_reduced, masks=dense_client_masks,
                lm_batches=ref_lm_batches, build=ref_build, moe=ref_moe)


def _np(ref, tree):
    return ref["jax"].tree_util.tree_map(np.asarray, tree)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _leaves(ref, tree):
    return dict(ref["jax"].tree_util.tree_leaves_with_path(tree))


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _bits(t):
    return t.contiguous().view(torch.int16 if t.dtype == BF else torch.int32)


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


# -- C9: the router's tie order -----------------------------------------------


def _route_cfg(router, E=6, k=2):
    cfg = get_reduced_config("mixtral_8x22b")
    return dataclasses.replace(cfg, moe=MoEConfig(
        n_experts=E, top_k=k, d_ff=64, router=router))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_route_breaks_ties_to_the_lower_expert_as_jax(ref, router, dtype):
    """Tied logits built by hand (one-hot tokens pick a router row each):
    the port's ``_route`` gives the experts, their order and the weights
    that the reference's (``jax.lax.top_k``) gives; ``torch.topk`` takes
    ``[2, 4]`` of ``[1, 3, 3, 2, 3, .5]`` where jax takes ``[1, 2]``."""
    jnp = ref["jnp"]
    rows = np.array([[1, 3, 3, 2, 3, .5], [2, 2, 2, 2, 2, 2],
                     [0, 1, 1, 1, 0, 1], [5, 4, 5, 4, 5, 4],
                     [-1, -1, 0, -1, 0, -1]], np.float32)
    x = np.eye(8, dtype=np.float32)[:5]            # [T, D]
    rw = np.zeros((8, 6), np.float32)
    rw[:5] = rows
    cfg = _route_cfg(router)
    rc = dataclasses.replace(ref["reduced"]("mixtral_8x22b"),
                             moe=dataclasses.replace(
                                 ref["reduced"]("mixtral_8x22b").moe,
                                 n_experts=6, top_k=2, d_ff=64,
                                 router=router))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    w_want, i_want, aux_want = ref["moe"]._route(
        jnp.asarray(rw, jd), jnp.asarray(x, jd), rc)
    w_got, i_got, aux_got = moe._route(
        torch.as_tensor(rw).to(td)[None], torch.as_tensor(x).to(td)[None],
        cfg)
    np.testing.assert_array_equal(i_got[0].numpy(), np.asarray(i_want))
    assert i_got[0, 0].tolist() == [1, 2]
    assert w_got.dtype == td
    np.testing.assert_allclose(_f32(w_got[0]), _f32(w_want), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(aux_got[0]), float(aux_want),
                               rtol=1e-6)


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_route_matches_reference_where_bf16_logits_tie(ref, router):
    """The port's ``_route`` against the reference's on bf16 x and router
    at reduced Mixtral's width (D 256, 4 experts, top-2) over 2048 tokens:
    the entries are multiples of 1/8 and 1/16 whose products and sums are
    exact in float32, so both round the same logits to bf16, and many
    tokens tie at the k-th choice or at the first (the test asserts some
    of each); the experts chosen are equal everywhere, the weights too."""
    jnp = ref["jnp"]
    rng = np.random.default_rng(9)
    D, E, T = 256, 4, 2048
    x = rng.integers(-8, 9, (T, D)).astype(np.float32) / 8
    rw = rng.integers(-2, 3, (D, E)).astype(np.float32) / 16
    cfg = _route_cfg(router, E=E)
    rc = dataclasses.replace(ref["reduced"]("mixtral_8x22b"),
                             moe=dataclasses.replace(
                                 ref["reduced"]("mixtral_8x22b").moe,
                                 d_ff=64, router=router))
    w_want, i_want, _ = ref["moe"]._route(jnp.asarray(rw, jnp.bfloat16),
                                          jnp.asarray(x, jnp.bfloat16), rc)
    w_got, i_got, _ = moe._route(torch.as_tensor(rw).to(BF)[None],
                                 torch.as_tensor(x).to(BF)[None], cfg)
    logits = np.asarray(jnp.asarray(x, jnp.bfloat16)
                        @ jnp.asarray(rw, jnp.bfloat16)).astype(
                            np.float32)
    top = -np.sort(-logits, axis=-1)
    assert (top[:, 1] == top[:, 2]).sum() >= 1      # ties at the k-th
    assert (top[:, 0] == top[:, 1]).sum() >= 1      # and at the first
    np.testing.assert_array_equal(i_got[0].numpy(), np.asarray(i_want))
    np.testing.assert_array_equal(_f32(w_got[0]), _f32(w_want))


# -- the models ---------------------------------------------------------------


class Pair:
    """A reduced config in both packages at bf16 on the MoE ``path`` (and
    the reference's float32 model, for the exact gradient), the
    reference's params."""

    def __init__(self, ref, arch, path="dropping"):
        rc, pc = _roomy(ref["reduced"](arch)), _roomy(get_reduced_config(
            arch))
        jnp = ref["jnp"]
        self.ref_mod, self.arch = ref, arch
        self.ref = ref["build"](rc, moe_path=path, remat=False,
                                param_dtype=jnp.bfloat16)
        self.ref32 = ref["build"](rc, moe_path=path, remat=False)
        self.port = build_model(pc, moe_path=path, param_dtype=BF)
        self.params0 = _np(ref, self.ref.init(ref["jax"].random.PRNGKey(0)))
        self.vocab = rc.vocab

    def params(self):
        p = convert.from_reference(self.params0, "cpu")
        assert {v.dtype for v in p.values()} == {BF}
        return p

    def jparams(self):
        return self.ref_mod["jax"].tree_util.tree_map(
            self.ref_mod["jnp"].asarray, self.params0)

    def tokens(self, B, S_, seed):
        return np.random.default_rng(seed).integers(
            0, self.vocab, (B, S_)).astype(np.int32)


@pytest.fixture(scope="module")
def pairs(ref):
    return {m: Pair(ref, *m) for m in MODELS}


@pytest.mark.parametrize("windowed", [False, True],
                         ids=["whole", "windowed"])
@pytest.mark.parametrize("model", MODELS, ids=lambda m: "-".join(m))
def test_model_loss_matches_reference_at_bf16(ref, pairs, model, windowed):
    """One model's ``Model.loss`` at bf16 (its ``aux_loss`` and, for
    DeepSeek-V3, its ``mtp_loss`` too), whole and through a sub-model
    window (half the experts, the expert width and the heads; DeepSeek's
    dense d_ff too), against the reference's within LOSS_ATOL."""
    pair = pairs[model]
    toks = pair.tokens(2, 64, 1)
    win = WINDOWS[model[0]] if windowed else None
    want, wm = pair.ref.loss(pair.jparams(), {"tokens": ref["jnp"].asarray(
        toks)}, window=win)
    with torch.no_grad():
        got, gm = pair.port.loss(pair.params(), {"tokens": _t(toks)},
                                 window=win)
    assert got.dtype == torch.float32 and set(gm) == set(wm)
    for k in wm:
        assert abs(float(gm[k]) - float(wm[k])) <= LOSS_ATOL, k


@pytest.mark.parametrize("model", MODELS, ids=lambda m: "-".join(m))
def test_windowed_grad_matches_reference_at_bf16(ref, pairs, model):
    """The sub-model loss's gradient through the window, in the clients'
    form (C = 1: the experts' windowed products, rows 7-8, through
    ``experts=`` lanes on ``dropping``; MLA's heads window through rows
    5-6), bf16 leaves, against ``jax.grad`` of the reference's
    (:func:`_grad_within_reference_noise`); exactly 0 outside the expert
    window."""
    jax, jnp = ref["jax"], ref["jnp"]
    pair = pairs[model]
    toks = pair.tokens(2, 32, 2)
    win = WINDOWS[model[0]]

    def ref_grad(m, params):
        return _np(ref, jax.jit(jax.grad(lambda p: m.loss(
            p, {"tokens": jnp.asarray(toks)}, window=win)[0]))(
            jax.tree_util.tree_map(jnp.asarray, params)))
    want = _leaves(ref, ref_grad(pair.ref, pair.params0))
    exact = _leaves(ref, ref_grad(pair.ref32, jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), pair.params0)))
    params = {k: v[None].requires_grad_() for k, v in pair.params().items()}
    wmap = WindowMap({k: AxisWindow([o], w) for k, (o, w) in win.items()})
    loss, _ = pair.port.loss(params, {"tokens": _t(toks)[None]},
                             window=wmap)
    grads = {k: g[0] for k, g in zip(params, torch.autograd.grad(
        loss.sum(), list(params.values())))}
    assert {g.dtype for g in grads.values()} == {BF}
    got = _leaves(ref, convert.to_reference(grads))
    for path, w in want.items():
        _grad_within_reference_noise(got[path], w, exact[path], str(path))
    (eo, ew), (fo, fw) = win[("experts", 4)], win[("moe_d_ff", 256)]
    g = grads["moe_layers/0/moe/w_gate"]
    inside = g[eo:eo + ew, :, fo:fo + fw]
    assert torch.count_nonzero(inside) > 0
    assert torch.count_nonzero(g) == torch.count_nonzero(inside)


@pytest.mark.parametrize("model", MODELS[1:], ids=lambda m: "-".join(m))
def test_prefill_and_decode_match_reference_at_bf16(ref, pairs, model):
    """Prefill (past Mixtral's window, so its ring wraps; DeepSeek-V3's
    decompressed MLA), then 4 teacher-forced decode steps on the cache it
    returns (MLA's absorbed decode from the bf16 ``c``/``kr`` caches), and
    a step from the default ``init_cache``: bf16 logits, each within 2e-2
    of the largest plus 2e-2 of its own; every cache leaf bf16, as the
    reference's."""
    jax, jnp = ref["jax"], ref["jnp"]
    pair = pairs[model]
    P = PROMPT[model[0]]
    toks = pair.tokens(2, P + 4, 3)
    jp = pair.jparams()
    params = pair.params()
    want, rcache = jax.jit(pair.ref.prefill, static_argnames=("max_len",))(
        jp, jnp.asarray(toks[:, :P]), max_len=P + 4)
    decode = jax.jit(pair.ref.decode_step)
    t = _t(toks)
    with torch.no_grad():
        got, cache = pair.port.prefill(params, t[:, :P], max_len=P + 4)
        assert got.dtype == BF and want.dtype == jnp.bfloat16
        assert {v.dtype for v in cache.values()} == {BF}
        assert {str(a.dtype) for s in rcache.values()
                for a in s.values()} == {"bfloat16"}
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


def test_init_cache_dtypes_at_bf16(ref, pairs):
    """The default caches: bf16 ``c``/``kr`` (MLA) and ``k``/``v``,
    shaped as the reference's."""
    for arch, path in MODELS[1:]:
        pair = pairs[(arch, path)]
        want = ref["jax"].eval_shape(lambda: pair.ref.init_cache(3, 40))
        got = pair.port.init_cache(3, 40, device="cpu")
        n = 0
        for stack, leaves in want.items():
            for name, sd in leaves.items():
                for i in range(sd.shape[0]):
                    t = got[f"{stack}/{i}/{name}"]
                    assert tuple(t.shape) == sd.shape[1:], (arch, name)
                    assert t.dtype == BF and str(sd.dtype) == "bfloat16"
                    n += 1
        assert n == len(got)


class _Recorder:
    """A model as the continuous batcher sees it, keeping the logits each
    request is handed: the prefill's row at its last prompt token and its
    slot's row of every decode step (``chip_smoke.py``'s recorder)."""

    def __init__(self, model):
        self.model, self.cfg = model, model.cfg
        self.eng, self.last_prefill, self.rows = None, None, {}

    def init_cache(self, *args, **kw):
        return self.model.init_cache(*args, **kw)

    def prefill(self, *args, **kw):
        logits, cache = self.model.prefill(*args, **kw)
        self.last_prefill = logits
        return logits, cache

    def decode_step(self, *args, **kw):
        logits, cache = self.model.decode_step(*args, **kw)
        for i, r in enumerate(self.eng._slot_req):
            if r is not None:
                self.rows.setdefault(r.rid, []).append(logits[i])
        return logits, cache

    def step(self):
        before = {id(r) for r in self.eng._slot_req if r is not None}
        ok = self.eng.step()
        for slot, r in enumerate(self.eng._slot_req):
            if r is not None and id(r) not in before:
                self.rows.setdefault(r.rid, []).insert(
                    0, self.last_prefill[slot, len(r.prompt) - 1])
        return ok


def test_batcher_at_bf16_matches_single_requests():
    """Reduced DeepSeek-V3 at bf16 through the continuous batcher (2 slots,
    ragged prompts; MLA's compressed caches merged in bf16 and decoded
    absorbed) on ``dropping`` at a capacity factor of n_experts / top_k,
    where no token's routing depends on its neighbours: every logit it
    hands out within 2e-2 of the request's largest of a single-request
    prefill and teacher-forced decode."""
    cfg = _roomy(get_reduced_config("deepseek_v3_671b"))
    model = build_model(cfg, param_dtype=BF)
    params = model.init(0, device="cpu")
    reqs = request_queue(cfg, (5, 9, 7, 12), max_new=3, seed=0)
    rec = _Recorder(model)
    rec.eng = eng = ContinuousBatcher(rec, params, batch_slots=2,
                                      max_len=40)
    assert {v.dtype for v in eng._cache.values()} == {BF}
    for r in reqs:
        eng.submit(r)
    while eng._queue or any(r is not None for r in eng._slot_req):
        assert rec.step()
    with torch.no_grad():
        for r in reqs:
            prompt = torch.as_tensor(r.prompt, dtype=torch.long)[None]
            want, cache = model.prefill(params, prompt, max_len=40)
            wants = [want[0]]
            for i, tok in enumerate(r.out[:-1]):
                want, cache = model.decode_step(
                    params, torch.as_tensor([tok]), cache,
                    prompt.shape[1] + i)
                wants.append(want[0])
            got = rec.rows[r.rid]
            assert len(got) == len(wants) == len(r.out)
            scale = max(float(w.float().abs().max()) for w in wants)
            for a, b in zip(got, wants):
                assert a.dtype == BF
                assert float((a.float() - b.float()).abs().max()) <= \
                    CAP * scale


# -- rounds against the reference --------------------------------------------


@pytest.fixture(scope="module")
def reference_runs(ref, pairs):
    """Each model's bf16 rounds in the reference (``dropping`` at the
    roomy capacity): 3 window rounds on its extract arm and 3 Bernoulli
    mask rounds, with the offsets and masks the port injects."""
    jax, jnp = ref["jax"], ref["jnp"]
    out = {}
    for arch in ARCHS:
        pair = pairs[(arch, "dropping")]
        model = pair.ref
        it = ref["lm_batches"](pair.vocab, (2, C, 2), S, seed=0)
        batches = [next(it) for _ in range(ROUNDS)]
        jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
        runs = {}
        scfg = ref["Scfg"](**{**SCFG, "client_lr": CLIENT_LR[arch]})
        fed = ref["api"].fed_round(model, scfg, kernel_backend="jnp",
                                   fused_forward="off")
        trainer = ref["api"].Trainer(fed, pair.jparams(), rng=1)
        params, history = trainer.run(iter(jb), ROUNDS)
        runs["window"] = dict(
            params=_np(ref, params),
            injected=[{"offsets": {k: [int(o) for o in np.asarray(v)]
                                   for k, v in fed.scheme.offsets(
                                       None, r, C).items()}}
                      for r in range(ROUNDS)],
            client_loss=[np.asarray(h["client_loss"]) for h in history])
        scfg = ref["Scfg"](**{**SCFG, "scheme": "bernoulli",
                              "client_lr": CLIENT_LR[arch]})
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
    masks (rolling at 0.5 on the default axes: experts 2 of 4, moe_d_ff
    128 of 256, the heads, Mixtral's kv heads, DeepSeek's dense d_ff): the
    fused and the extract window rounds against the reference's extract
    arm, the Bernoulli mask round; params stay bf16, the client losses
    within LOSS_ATOL, and the params' change from the start within
    DELTA_ALL and DELTA_LEAF of the reference's (:func:`_delta_gaps`),
    which rounds that left the params where they were fail."""
    pair, (mode, kw) = pairs[(arch, "dropping")], case
    data, run = reference_runs[arch], reference_runs[arch]["runs"][mode]
    scheme = "bernoulli" if mode == "mask" else "rolling"
    fed = api.fed_round(pair.port, SubmodelConfig(**{
        **SCFG, "scheme": scheme, "client_lr": CLIENT_LR[arch]}),
        mode=mode, device="cpu", **kw)
    if mode == "window":
        assert fed.use_fused == (kw["fused_forward"] == "on")
        assert ("experts", 4) in fed.scheme.sizes
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


@pytest.mark.parametrize("model", MODELS, ids=lambda m: "-".join(m))
def test_fused_equals_extract_to_the_bit_at_bf16(model):
    """At bf16 the fused client phase (full copies: the experts through
    rows 7-8's plain versions on ``experts=`` lanes and ``_ExpertDown``,
    MLA's per-head up-projections through rows 5-6) and the extract phase
    (compact copies) agree bit for bit over 2 rolling rounds, as at f32,
    on the ``dense`` and ``dropping`` paths."""
    arch, path = model
    cfg = _roomy(get_reduced_config(arch))
    m = build_model(cfg, moe_path=path, param_dtype=BF)
    it = lm_batches(cfg.vocab, (2, C, 2), S, seed=0)
    batches = [next(it) for _ in range(2)]
    out = {}
    for ff in ("on", "off"):
        fed = api.fed_round(m, SubmodelConfig(**SCFG), fused_forward=ff,
                            device="cpu")
        assert fed.use_fused == (ff == "on")
        trainer = api.Trainer(fed, m.init(0, device="cpu"))
        trainer.run(iter(batches), 2)
        out[ff] = trainer
    for a, b in zip(out["on"].history, out["off"].history):
        assert torch.equal(_bits(a["client_loss"]), _bits(b["client_loss"]))
    for k, v in out["on"].params.items():
        assert v.dtype == BF
        assert torch.equal(_bits(v), _bits(out["off"].params[k])), k


# -- the card -----------------------------------------------------------------


def _card():
    """The card, picked as the port's entry points pick it (bf16 products
    summing in f32), or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; none is present")
    from repro_torch.device import resolve_device
    return resolve_device("cuda")


# row 7's bf16 arm on Mixtral's expert lanes: x [C, G, cap, D] against a
# client's window of G experts of the full stack [C, E, D, F], offsets
# repeated over the experts (reduced, and one full-width lane of 2 experts)
EXPERT_LANES = [(2, 4, 2, 64, 256, 256, 128, [0, 2], [64, 128]),
                (1, 8, 2, 512, 6144, 16384, 8192, [3], [4096])]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", EXPERT_LANES, ids=["reduced", "mixtral"])
def test_gpu_row_7_bf16_on_expert_lanes_matches_plain(shape):
    """Rows 7-8's bf16 arm through ``experts=`` lanes on the card against
    the same call on the CPU (the plain versions): the gate/up pair within
    one bf16 ulp plus 1e-6 of its largest output, dx and dW within one
    ulp plus 1e-4 (the f32 arms' tolerance for another summation order:
    Mixtral's dx sums 2 x 8192 products an element, whose float32 sums in
    two orders part by about 1e-6 of the largest); one launch a client of
    each.  The backward's first CUDA work is the dx kernel's launch, which
    failed before the wrapper set the autograd thread's device (ROADMAP.md
    §C, C10)."""
    cuda = _card()
    C_, E, G, cap, D, F, win, eo, fo = shape
    g = torch.Generator().manual_seed(D)
    x = torch.randn((C_, G, cap, D), generator=g).to(BF)
    ws = [(torch.randn((C_, E, D, F), generator=g) / 32).to(BF)
          for _ in range(2)]
    dys = [torch.randn((C_, G, cap, win), generator=g).to(BF)
           for _ in range(2)]

    def run(dev):
        xs = x.to(dev).requires_grad_()
        wl = [w.to(dev).requires_grad_() for w in ws]
        offs = [make_offsets([o] * G, dev) for o in fo]
        ys = rolling_matmul_batched(xs, wl, offs, win, experts=eo)
        torch.autograd.backward(ys, [d.to(dev) for d in dys])
        return [t.detach().cpu() for t in (*ys, xs.grad,
                                           *(w.grad for w in wl))]
    n = dict(_build.LAUNCHES)
    got = run(cuda)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["rolling_mm_fwd<2>/bf16"] == \
        n.get("rolling_mm_fwd<2>/bf16", 0) + C_
    assert _build.LAUNCHES["rolling_mm_dx<2>/bf16"] == \
        n.get("rolling_mm_dx<2>/bf16", 0) + C_
    want = run("cpu")
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.float(), b.float()
        slack = 1e-6 if i < 2 else 1e-4
        m, e = np.frexp(b.numpy())
        ulp = np.where(m == 0, 0.0, np.ldexp(1.0, e - 8))
        bound = ulp + slack * float(b.abs().max())
        assert ((a - b).abs().numpy() <= bound).all(), i


@pytest.mark.gpu
def test_gpu_reduced_bf16_moe_round_matches_cpu():
    """Two fused rounds of reduced Mixtral at bf16 (``dropping`` at the
    roomy capacity) on the card and on the CPU from the same params,
    tokens and CPU-drawn offsets, at client lr 0.01: params bf16, client
    losses within 2e-2, the params' change within the gap (0.15 over all
    leaves, 0.4 a leaf)."""
    cuda = _card()
    cfg = _roomy(get_reduced_config("mixtral_8x22b"))
    model = build_model(cfg, param_dtype=BF)
    it = lm_batches(cfg.vocab, (2, C, 2), S, seed=0)
    batches = [next(it) for _ in range(2)]
    params0 = model.init(0, device="cpu")
    scfg = SubmodelConfig(**{**SCFG, "client_lr": 0.01})
    fed = api.fed_round(model, scfg, device="cpu")
    injected = [{"offsets": fed._client_offsets(r)} for r in range(2)]
    out = {}
    for dev in ("cpu", cuda):
        fed = api.fed_round(model, scfg, device=dev)
        trainer = api.Trainer(fed, {k: v.to(dev, copy=True) for k, v in
                                    params0.items()})
        trainer.run(zip(batches, injected), 2)
        out[str(dev)] = trainer
    cpu, card = out["cpu"], out[str(cuda)]
    for a, b in zip(card.history, cpu.history):
        assert float((a["client_loss"].cpu() - b["client_loss"]).abs()
                     .max()) <= CAP
    assert {v.dtype for v in card.params.values()} == {BF}
    got = {k: _f32(v.cpu()) for k, v in card.params.items()}
    want = {k: _f32(v) for k, v in cpu.params.items()}
    p0 = {k: _f32(v) for k, v in params0.items()}
    every, leaf = _delta_gaps(got, want, p0)
    assert every <= DELTA_ALL and leaf <= DELTA_LEAF, (every, leaf)
