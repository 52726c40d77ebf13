"""MLA, the leading dense layers and the MTP block (reduced DeepSeek-V3) in
the port against the JAX reference.

Reduced DeepSeek-V3: 2 layers (one leading dense layer, one MoE layer of 4
experts, top-2, a shared expert, sigmoid routing), d_model 256, 8 heads,
MLA ranks q 64 / kv 64, rope 16, nope 32, v 32, and the MTP block; params
made by the reference and converted through numpy; the MoE layers on the
``dense`` path (the reference's ``dropping`` dispatch zeroes an
overflowing expert's first token, ROADMAP.md §C):

- one model's loss, its ``mtp_loss`` and the gradient of every leaf
  against ``jax.grad`` of the reference's, with no window, with the
  standalone ``heads`` window (MLA has no ``kv_heads`` axis: the per-head
  up-projections and ``wo``'s rows are windowed on their own), and with a
  ``heads`` + ``d_ff`` window threaded into the MTP block too;
- a ``kv_heads`` window refused with ``ValueError`` in both packages, and
  ``api.fed_round`` taking the fused phase on an uncoupled ``heads``
  window (the GQA-coupling guard passes: no ``kv_heads`` axis);
- absorbed decode (attention over the compressed cache) against the
  decompressed prefill of the same tokens; ``init_cache`` and the padded
  prefill caches (``c``, ``kr``) against the reference's;
- 3 rounds (C = 2, K = 2 x 2 x 32 tokens, rolling at 0.5 on the default
  axes: ``heads`` 4 of 8, ``d_ff`` 256 of 512, ``experts`` 2 of 4,
  ``moe_d_ff`` 128 of 256) of the port's fused and extract phases against
  the reference's extract arm, with its offsets injected; fused ==
  extract to the bit inside the port (``dense``, ``dropping``, staggered);
- the continuous batcher's ``c``/``kr`` merge: the same ragged queue as
  the reference's batcher gives its tokens, stats and final caches.

Tolerance: float32, atol 1e-5 and rtol 1e-5.  The JAX reference is
imported inside the ``ref`` fixture, never at collection, so the ``gpu``
test runs where JAX is not installed (``--noconftest -m gpu``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api, convert  # noqa: E402
from repro_torch.configs.base import (SubmodelConfig,  # noqa: E402
                                      get_reduced_config)
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ref import (rolling_matmul_batched_dx_ref,  # noqa
                                     rolling_matmul_batched_ref)
from repro_torch.kernels.rolling_matmul import (make_offsets,  # noqa: E402
                                                rolling_mm_dx, rolling_mm_fwd)
from repro_torch.launch.batching import ContinuousBatcher  # noqa: E402
from repro_torch.launch.specs import request_queue  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ATOL = RTOL = 1e-5
ARCH = "deepseek_v3_671b"
ROUNDS, S, C = 3, 32, 2
SCFG = dict(scheme="rolling", capacity=0.5, local_steps=2,
            clients_per_round=C, client_lr=0.1)
WINDOWS = {"none": {},
           "heads": {("heads", 8): (2, 4)},
           "heads and d_ff": {("heads", 8): (4, 4), ("d_ff", 512): (96, 256)}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The reduced config in both packages: the reference's model and
    params, the port's model and the converted params."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_reduced_config as ref_reduced
    from repro.models import build_model as ref_build
    rc = ref_reduced(ARCH)
    model = ref_build(rc, moe_path="dense", remat=False)
    params = model.init(jax.random.PRNGKey(0))
    params0 = jax.tree_util.tree_map(np.asarray, params)
    return dict(jax=jax, jnp=jnp, cfg=rc, model=model, params=params,
                params0=params0,
                port=build_model(get_reduced_config(ARCH), moe_path="dense"),
                port_params=convert.from_reference(params0, device="cpu"))


def _close(a, b, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                               rtol=RTOL, err_msg=msg)


def _tokens(B, S_, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, S_)).astype(np.int32)


def _bits(t):
    return t.contiguous().view(torch.int32)


# -- one model: loss, mtp_loss, gradients, the heads window -------------------


@pytest.mark.parametrize("name", list(WINDOWS))
def test_loss_mtp_and_grads_match_jax_grad(ref, name):
    jax, jnp = ref["jax"], ref["jnp"]
    from repro.models.layers import AxisWindow as RefAxisWindow
    from repro.models.layers import WindowMap as RefWindowMap
    spans = WINDOWS[name]
    rw = (RefWindowMap({k: RefAxisWindow(*v) for k, v in spans.items()},
                       backend="jnp") if spans else None)
    toks = _tokens(2, 48, seed=1)

    def ref_loss(p):
        return ref["model"].loss(p, {"tokens": jnp.asarray(toks)},
                                 window=rw)
    (want, wm), wg = jax.jit(jax.value_and_grad(ref_loss, has_aux=True))(
        ref["params"])
    p = {k: v.clone().requires_grad_() for k, v in
         ref["port_params"].items()}
    got, gm = ref["port"].loss(p, {"tokens": torch.as_tensor(
        toks, dtype=torch.long)}, window=spans or None)
    grads = dict(zip(p, torch.autograd.grad(got, list(p.values()))))
    _close(got.detach(), want)
    assert set(gm) == set(wm) == {"lm_loss", "aux_loss", "mtp_loss", "loss"}
    for k in wm:
        _close(gm[k].detach(), wm[k], k)
    back = convert.to_reference(grads)
    for path, g in jax.tree_util.tree_leaves_with_path(wg):
        keys = [q.key for q in path]
        node = back
        for q in keys:
            node = node[q]
        _close(node, g, "/".join(keys))
    if ("heads", 8) in spans:
        o, w = spans[("heads", 8)]
        for leaf, dim in (("dense_layers/0/attn/w_uq", 1),
                          ("moe_layers/0/attn/w_uk", 1),
                          ("mtp/attn/w_uv", 1), ("mtp/attn/wo", 0)):
            g = grads[leaf]
            inside = g.narrow(dim, o, w)
            assert torch.count_nonzero(inside) > 0, leaf
            assert torch.count_nonzero(g) == torch.count_nonzero(inside), \
                leaf


def test_kv_heads_window_is_refused(ref):
    from repro.models.layers import AxisWindow as RefAxisWindow
    from repro.models.layers import WindowMap as RefWindowMap
    toks = _tokens(1, 16)
    with pytest.raises(ValueError, match="kv_heads"):
        ref["model"].loss(ref["params"], {"tokens": ref["jnp"].asarray(
            toks)}, window=RefWindowMap({("kv_heads", 4): RefAxisWindow(
                0, 2)}, backend="jnp"))
    with pytest.raises(ValueError, match="kv_heads"):
        ref["port"].loss(ref["port_params"], {"tokens": torch.as_tensor(
            toks, dtype=torch.long)}, window={("kv_heads", 4): (0, 2)})


def test_fed_round_fuses_the_standalone_heads_window(ref):
    """No leaf carries a ``kv_heads`` axis, so the scheme windows ``heads``
    as a primary axis and the GQA-coupling guard lets it through."""
    fed = api.fed_round(ref["port"], SubmodelConfig(**SCFG), device="cpu")
    assert fed.use_fused
    assert fed.scheme.sizes == {("heads", 8): 4, ("d_ff", 512): 256,
                                ("experts", 4): 2, ("moe_d_ff", 256): 128}
    assert not fed.scheme.derived
    axes = ref["port"].axes()
    assert not any("kv_heads" in a for a in axes.values())
    assert axes["mtp/attn/w_uq"] == ("mla_q_rank", "heads", "head_dim")
    assert axes["dense_layers/0/mlp/w_gate"] == ("d_model", "d_ff")


# -- serving: absorbed decode, caches -----------------------------------------


def test_absorbed_decode_matches_prefill(ref):
    """Prefill 40 tokens, then 8 teacher-forced decode steps through the
    absorbed path, against one decompressed prefill of all 48."""
    model, params = ref["port"], ref["port_params"]
    toks = torch.as_tensor(_tokens(2, 48, seed=2), dtype=torch.long)
    with torch.no_grad():
        want, _ = model.prefill(params, toks, return_all_logits=True)
        logits, cache = model.prefill(params, toks[:, :40], max_len=48)
        got = [logits]
        for pos in range(40, 47):
            logits, cache = model.decode_step(params, toks[:, pos], cache,
                                              pos)
            got.append(logits)
    _close(torch.stack(got, 1), want[:, 39:47])


def test_caches_match_reference(ref):
    """``init_cache`` and the prefill's caches padded to ``max_len``:
    the compressed ``c [B, S, r]`` and ``kr [B, S, rd]`` of each stack's
    layers, as the reference lays them out."""
    jnp = ref["jnp"]
    toks = _tokens(2, 24, seed=3)
    _, want = ref["model"].prefill(ref["params"], jnp.asarray(toks),
                                   max_len=30)
    with torch.no_grad():
        _, got = ref["port"].prefill(ref["port_params"], torch.as_tensor(
            toks, dtype=torch.long), max_len=30)
    got = convert.to_reference(got)
    empty = convert.to_reference(ref["port"].init_cache(
        2, 30, torch.float32, device="cpu"))
    zeros = ref["model"].init_cache(2, 30, jnp.float32)
    assert set(got) == set(want) == set(empty) == {"dense_layers",
                                                   "moe_layers"}
    for stack in want:
        assert set(got[stack]) == set(want[stack]) == {"c", "kr"}
        for name in want[stack]:
            assert got[stack][name].shape == want[stack][name].shape
            _close(got[stack][name], want[stack][name])
            np.testing.assert_array_equal(empty[stack][name],
                                          np.asarray(zeros[stack][name]))
    assert got["dense_layers"]["c"].shape == (1, 2, 30, 64)
    assert got["moe_layers"]["kr"].shape == (1, 2, 30, 16)


def test_convert_round_trips_stacks_and_mtp(ref):
    back = convert.to_reference(ref["port_params"])
    jax = ref["jax"]
    for path, w in jax.tree_util.tree_leaves_with_path(ref["params0"]):
        node = back
        for q in path:
            node = node[q.key]
        np.testing.assert_array_equal(node, w)
    assert back["dense_layers"]["mlp"]["w_gate"].shape == (1, 256, 512)
    assert back["moe_layers"]["moe"]["w_up"].shape == (1, 4, 256, 256)
    assert back["mtp"]["attn"]["w_uq"].shape == (64, 8, 48)
    assert "mtp/final" in ref["port_params"]
    assert "mtp/mlp/w_down" in ref["port_params"]
    again = convert.from_reference(back, "cpu")
    assert again.keys() == ref["port_params"].keys()
    assert all(torch.equal(again[k], ref["port_params"][k]) for k in again)


# -- rounds -------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_rounds(ref):
    """3 rounds of the reference's extract arm, with the offsets it drew."""
    jax, jnp = ref["jax"], ref["jnp"]
    from repro import api as ref_api
    from repro.configs.base import SubmodelConfig as RefSubmodelConfig
    from repro.data.synthetic import lm_batches as ref_lm_batches
    it = ref_lm_batches(ref["cfg"].vocab, (2, C, 2), S, seed=0)
    batches = [next(it) for _ in range(ROUNDS)]
    fed = ref_api.fed_round(ref["model"], RefSubmodelConfig(**SCFG),
                            kernel_backend="jnp", fused_forward="off")
    trainer = ref_api.Trainer(fed, jax.tree_util.tree_map(
        jnp.asarray, ref["params0"]), rng=1)
    params, history = trainer.run(
        ({k: jnp.asarray(v) for k, v in b.items()} for b in batches),
        ROUNDS)
    offsets = [{k: [int(o) for o in np.asarray(v)] for k, v in
                fed.scheme.offsets(None, r, C).items()}
               for r in range(ROUNDS)]
    return dict(batches=batches, offsets=offsets,
                params=jax.tree_util.tree_map(np.asarray, params),
                client_loss=[np.asarray(h["client_loss"]) for h in history])


def _port_rounds(model, params, scfg, batches, offsets, ff):
    fed = api.fed_round(model, scfg, fused_forward=ff, device="cpu")
    assert fed.use_fused == (ff == "on")
    trainer = api.Trainer(fed, params)
    items = (zip(batches, ({"offsets": o} for o in offsets)) if offsets
             else iter(batches))
    trainer.run(items, len(batches))
    return trainer


@pytest.mark.parametrize("ff", ["on", "off"], ids=["fused", "extract"])
def test_rounds_match_reference_extract_arm(ref, ref_rounds, ff):
    trainer = _port_rounds(ref["port"], convert.from_reference(
        ref["params0"], "cpu"), SubmodelConfig(**SCFG),
        ref_rounds["batches"], ref_rounds["offsets"], ff)
    assert len({tuple(o[("heads", 8)]) for o in ref_rounds["offsets"]}) > 1
    for r, h in enumerate(trainer.history):
        _close(h["client_loss"].numpy(), ref_rounds["client_loss"][r])
    got = convert.to_reference(trainer.params)
    jax = ref["jax"]
    for path, want in jax.tree_util.tree_leaves_with_path(
            ref_rounds["params"]):
        node = got
        for q in path:
            node = node[q.key]
        _close(node, want, f"{ff} {'/'.join(q.key for q in path)}")


@pytest.mark.parametrize("case", ["dense", "dropping", "dense staggered"])
def test_fused_equals_extract_to_the_bit(case):
    cfg = get_reduced_config(ARCH)
    model = build_model(cfg, moe_path=case.split()[0])
    it = lm_batches(cfg.vocab, (2, C, 2), S, seed=0)
    batches = [next(it) for _ in range(2)]
    scfg = SubmodelConfig(**SCFG, stagger=case.endswith("staggered"))
    out = {ff: _port_rounds(model, model.init(0, device="cpu"), scfg,
                            batches, None, ff) for ff in ("on", "off")}
    fused, extract = out["on"], out["off"]
    for a, b in zip(fused.history, extract.history):
        assert torch.equal(_bits(a["client_loss"]), _bits(b["client_loss"]))
    for k in fused.params:
        assert torch.equal(_bits(fused.params[k]),
                           _bits(extract.params[k])), k


# -- the continuous batcher ---------------------------------------------------


def test_batcher_merges_compressed_caches_as_the_reference(ref):
    """The reference's queue (prompts of 5, 9, 7, 12, 3 tokens, 4 new
    each, 2 slots, a timeline of 60) through both batchers: the same
    tokens and stats, and the same compressed caches at the end (every
    cohort's ``c`` and ``kr`` merged at its timeline positions)."""
    from repro.launch.batching import ContinuousBatcher as RefBatcher
    from repro.launch.specs import request_queue as ref_request_queue
    lengths = (5, 9, 7, 12, 3)
    ref_reqs = ref_request_queue(ref["cfg"], lengths, max_new=4, seed=0)
    ref_eng = RefBatcher(ref["model"], ref["params"], batch_slots=2,
                         max_len=60)
    reqs = request_queue(get_reduced_config(ARCH), lengths, max_new=4,
                         seed=0)
    eng = ContinuousBatcher(ref["port"], ref["port_params"], batch_slots=2,
                            max_len=60)
    for e, rs in ((ref_eng, ref_reqs), (eng, reqs)):
        for r in rs:
            e.submit(r)
        e.run()
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert vars(eng.stats) == vars(ref_eng.stats)
    assert eng.stats.prefills >= 2
    got = convert.to_reference(eng._cache)
    for stack, leaves in ref_eng._cache.items():
        for name, want in leaves.items():
            _close(got[stack][name], want, f"{stack}/{name}")


# -- the card -----------------------------------------------------------------

# rows 5/6 at MLA's shapes in DeepSeek-V3's round: x [C = 2, 512 rows, K]
# against the flattened per-head up-projections (K = q_lora 1536 -> 128 x
# 192 columns, K = kv_lora 512 -> 128 x 128), half the heads, at shared and
# per-client offsets
MLA_SHAPES = [(2, 512, 1536, 128 * 192, 64 * 192, [0, 0]),
              (2, 512, 1536, 128 * 192, 64 * 192, [64 * 192, 32 * 192]),
              (2, 512, 512, 128 * 128, 64 * 128, [32 * 128, 32 * 128]),
              (2, 512, 512, 128 * 128, 64 * 128, [0, 64 * 128])]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", MLA_SHAPES)
def test_gpu_rows_5_6_at_mla_shapes_match_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; none is present")
    cuda = torch.device("cuda")
    c, m, k, n, win, offs = shape
    g = torch.Generator(cuda).manual_seed(k)
    x = torch.randn((c, m, k), device=cuda, generator=g)
    w = torch.randn((c, k, n), device=cuda, generator=g)
    dy = torch.randn((c, m, win), device=cuda, generator=g)
    o = make_offsets(offs, cuda)
    n_fwd = _build.LAUNCHES["rolling_mm_fwd<1>"]
    (y,) = rolling_mm_fwd(x, [w], o, win)
    dx = rolling_mm_dx([dy], [w], o, win)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["rolling_mm_fwd<1>"] == n_fwd + 1
    for got, want in ((y, rolling_matmul_batched_ref(x, [w], offs, win)[0]),
                      (dx, rolling_matmul_batched_dx_ref([dy], [w], offs,
                                                         win))):
        scale = want.abs().max().clamp_min(1.0)
        assert float((got - want).abs().max() / scale) <= 1e-4

