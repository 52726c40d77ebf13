"""The port's model and weight converter against the JAX reference.

Reduced TinyLlama (2 layers, d_model 256, 8/4 heads of dim 32, d_ff 512,
vocab 512).  Params come from the reference's own init and cross through
numpy (``repro_torch.convert``); tokens come from the reference's data
generator.  Tolerance: float32, atol 1e-5 and rtol 1e-5 on losses and
gradients -- two frameworks, two summation orders through two layers of
matmuls, softmax and a 512-way cross-entropy.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_reduced_config as ref_reduced  # noqa: E402
from repro.data.synthetic import lm_batches as ref_lm_batches  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models.layers import AxisWindow as RefWindow  # noqa: E402
from repro.models.layers import WindowMap as RefWindowMap  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_reduced_config  # noqa: E402
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import AxisWindow, WindowMap  # noqa: E402

ATOL = RTOL = 1e-5
S = 32

# (kv_heads offset, d_ff offset); heads offsets derive as kv * group
WINDOWS = {"none": None, "aligned": (2, 256), "unaligned": (1, 37)}


@pytest.fixture(scope="module")
def ref():
    cfg = ref_reduced("tinyllama_1_1b")
    model = ref_build(cfg, remat=False)
    params = [model.init(jax.random.PRNGKey(s)) for s in (0, 1)]
    tokens = next(ref_lm_batches(cfg.vocab, (2, 2), S, seed=3))["tokens"]
    return cfg, model, params, tokens


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _windows(cfg, kind):
    if WINDOWS[kind] is None:
        return None, None
    kv, ff = WINDOWS[kind]
    G = cfg.n_heads // cfg.n_kv_heads
    plan = {("kv_heads", cfg.n_kv_heads): (kv, cfg.n_kv_heads // 2),
            ("heads", cfg.n_heads): (kv * G, cfg.n_heads // 2),
            ("d_ff", cfg.d_ff): (ff, cfg.d_ff // 2)}
    ref_w = RefWindowMap({k: RefWindow(o, w) for k, (o, w) in plan.items()},
                         backend="jnp")
    port_w = WindowMap({k: AxisWindow([o, o], w)
                        for k, (o, w) in plan.items()})
    return ref_w, port_w


def test_config_copy_matches_reference():
    for port_cfg, ref_cfg in ((get_reduced_config("tinyllama_1_1b"),
                               ref_reduced("tinyllama_1_1b")),):
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab", "head_dim", "norm_eps", "rope_theta", "act",
                  "name", "sliding_window"):
            assert getattr(port_cfg, f) == getattr(ref_cfg, f), f


def test_data_copy_gives_the_reference_tokens():
    a = next(lm_batches(512, (2, 4, 2), 16, seed=7))["tokens"]
    b = next(ref_lm_batches(512, (2, 4, 2), 16, seed=7))["tokens"]
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_converter_round_trip_is_bit_exact(ref):
    _, _, (p0, _), _ = ref
    src = _to_np(p0)
    port = convert.from_reference(src, device="cpu")
    assert "layers/1/mlp/w_gate" in port and "layers" not in port
    back = convert.to_reference(port)
    flat_a = jax.tree_util.tree_leaves_with_path(src)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), path


def test_port_axes_match_reference_axes(ref):
    cfg, model, _, _ = ref
    port_axes = build_model(get_reduced_config("tinyllama_1_1b")).axes()
    for path, axes in port_axes.items():
        parts = path.split("/")
        node = model.axes()
        if parts[0] == "layers":
            parts = ["layers"] + parts[2:]
        for q in parts:
            node = node[q]
        want = node[1:] if path.startswith("layers/") else node
        assert tuple(want) == axes, path


@pytest.mark.parametrize("kind", sorted(WINDOWS))
def test_model_loss_and_grads_match_reference(ref, kind):
    """Two clients with their own params and tokens: the port's per-client
    loss and gradient against the reference's ``Model.loss``."""
    cfg, model, params, tokens = ref
    ref_w, port_w = _windows(cfg, kind)
    port_model = build_model(get_reduced_config("tinyllama_1_1b"))
    clients = [convert.from_reference(_to_np(p), device="cpu")
               for p in params]
    stacked = {k: torch.stack([c[k] for c in clients]).requires_grad_()
               for k in clients[0]}
    loss, _ = port_model.loss(stacked, {"tokens": torch.tensor(
        tokens, dtype=torch.long)}, window=port_w)
    grads = torch.autograd.grad(loss.sum(), list(stacked.values()))
    grads = dict(zip(stacked, grads))
    for c in range(2):
        (ref_loss, _), ref_g = jax.value_and_grad(
            lambda p: model.loss(p, {"tokens": jnp.asarray(tokens[c])},
                                 window=ref_w), has_aux=True)(params[c])
        np.testing.assert_allclose(float(loss[c].detach()), float(ref_loss),
                                   atol=ATOL, rtol=RTOL)
        port_g = convert.to_reference({k: g[c] for k, g in grads.items()})
        want = dict(jax.tree_util.tree_leaves_with_path(_to_np(ref_g)))
        for path, g in jax.tree_util.tree_leaves_with_path(port_g):
            np.testing.assert_allclose(g, want[path], atol=ATOL, rtol=RTOL,
                                       err_msg=str(path))


def test_windowed_grads_are_exactly_zero_outside_the_window(ref):
    cfg, _, params, tokens = ref
    _, port_w = _windows(cfg, "unaligned")
    port_model = build_model(get_reduced_config("tinyllama_1_1b"))
    p = convert.from_reference(_to_np(params[0]), device="cpu")
    stacked = {k: v[None].repeat(2, *([1] * v.dim())).requires_grad_()
               for k, v in p.items()}
    loss, _ = port_model.loss(stacked, {"tokens": torch.tensor(
        tokens, dtype=torch.long)}, window=port_w)
    grads = dict(zip(stacked, torch.autograd.grad(loss.sum(),
                                                  list(stacked.values()))))
    kv, ff = WINDOWS["unaligned"]
    g = grads["layers/0/mlp/w_gate"]
    assert torch.count_nonzero(g[:, :, :ff]) == 0
    assert torch.count_nonzero(g[:, :, ff + cfg.d_ff // 2:]) == 0
    g = grads["layers/1/attn/wk"]
    assert torch.count_nonzero(g[:, :, :kv]) == 0
    assert torch.count_nonzero(g[:, :, kv + cfg.n_kv_heads // 2:]) == 0


def test_model_refuses_unported_families():
    # every family of the zoo is ported (A10); a family label its fields
    # contradict (an MoE label without experts) is no configuration of it
    cfg = replace(get_reduced_config("tinyllama_1_1b"), family="moe")
    with pytest.raises(NotImplementedError):
        build_model(cfg)
