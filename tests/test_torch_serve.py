"""The port's serving path against the JAX reference.

On reduced Mamba2-130M (2 SSM layers, d_model 256, 16 heads of 32, d_state
16, chunk 32) and reduced TinyLlama-1.1B (2 layers), with params made by
the reference and converted:

- ``Model.prefill`` logits and every cache leaf (``h``, ``conv_x``,
  ``conv_B``, ``conv_C``; ``k``, ``v``), the port's caches carried back
  with ``convert.to_reference``, against the reference's
  ``Model.prefill(max_len=...)``, at S = 64 (two chunks) and S = 15 (one
  chunk of Q = S);
- 4 teacher-forced ``decode_step`` s after that prefill, and the
  prefill's ``pos_offset`` / ``return_all_logits`` and the decode step's
  ``valid`` / ``rope_pos`` (the continuous batcher's arguments);
- the reference's own identity (``tests/test_system.py``), inside the
  port: prefill(t[:-1]) + decode(t[-1]) == forward(t)[-1];
- a sliding-window TinyLlama (``sliding_window=8``, S = 16): the ring
  cache and decode past the window;
- Mamba2's ``Model.loss`` and ``init_cache``;
- ``launch.serve.generate`` against the reference's prefill / argmax /
  decode loop fed the port's tokens, on the logits of every step and on
  the tokens wherever the reference's top-2 margin exceeds the tolerance;
- ``python -m repro_torch.launch.serve --reduced --device cpu``.

Tolerance: float32, atol 1e-5 and rtol 1e-5 -- two frameworks, two
summation orders through two layers (the round and eval tests'
tolerance); the identity inside the port holds to the same.
"""
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import checkpoint as ref_ckpt  # noqa: E402
from repro.configs.base import get_reduced_config as ref_reduced  # noqa: E402
from repro.launch.specs import sample_prompts as ref_prompts  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import checkpoint  # noqa: E402
from repro_torch.configs.base import get_reduced_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.specs import sample_prompts  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ATOL = RTOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["mamba2_130m", "tinyllama_1_1b"]


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                               rtol=RTOL)


def _close_trees(port_caches, ref_caches):
    got = convert.to_reference(port_caches)
    want = jax.tree_util.tree_map(np.asarray, ref_caches)
    assert got.keys() == want.keys()
    for stack in want:
        assert got[stack].keys() == want[stack].keys()
        for name in want[stack]:
            assert got[stack][name].shape == want[stack][name].shape, name
            _close(got[stack][name], want[stack][name])


class Pair:
    """One configuration in both packages, with the reference's params
    converted for the port, and the reference's entry points jitted."""

    def __init__(self, cfg_ref, cfg_port, seed=0):
        self.ref = ref_build(cfg_ref, remat=False)
        self.port = build_model(cfg_port)
        self.ref_params = self.ref.init(jax.random.PRNGKey(seed))
        self.params = convert.from_reference(
            jax.tree_util.tree_map(np.asarray, self.ref_params),
            device="cpu")
        self.ref_prefill = jax.jit(self.ref.prefill,
                                   static_argnames=("max_len",))
        self.ref_decode = jax.jit(self.ref.decode_step)
        self.vocab = cfg_ref.vocab

    def tokens(self, B, S, seed=0):
        rng = np.random.default_rng(seed)
        return rng.integers(0, self.vocab, (B, S)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(ref_reduced(request.param), get_reduced_config(request.param))


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


# -- prefill and decode against the reference ---------------------------------


@pytest.mark.parametrize("S", [64, 15])
def test_prefill_matches_reference(pair, S):
    toks = pair.tokens(2, S)
    want, ref_cache = pair.ref_prefill(pair.ref_params, jnp.asarray(toks),
                                       max_len=S + 4)
    with torch.no_grad():
        got, cache = pair.port.prefill(pair.params, _t(toks), max_len=S + 4)
    assert got.shape == (2, pair.vocab)
    _close(got, want)
    _close_trees(cache, ref_cache)


def test_decode_steps_match_reference(pair):
    """4 teacher-forced decode steps after a prefill of 64, logits and
    caches at every step."""
    toks = pair.tokens(2, 68, seed=1)
    _, ref_cache = pair.ref_prefill(pair.ref_params, jnp.asarray(toks[:, :64]),
                                    max_len=68)
    with torch.no_grad():
        _, cache = pair.port.prefill(pair.params, _t(toks[:, :64]),
                                     max_len=68)
        for pos in range(64, 68):
            want, ref_cache = pair.ref_decode(pair.ref_params,
                                              jnp.asarray(toks[:, pos]),
                                              ref_cache, pos)
            got, cache = pair.port.decode_step(pair.params, _t(toks[:, pos]),
                                               cache, pos)
            _close(got, want)
            _close_trees(cache, ref_cache)


def test_prefill_decode_equals_forward(pair):
    """prefill(t[:-1]) + decode(t[-1]) == forward(t)[-1], the reference's
    identity (tests/test_system.py), inside the port; prefill of 15 is one
    chunk of Q = 15 for the SSM."""
    toks = _t(pair.tokens(2, 16, seed=2))
    with torch.no_grad():
        full, _ = pair.port.forward(pair.params, toks)
        _, cache = pair.port.prefill(pair.params, toks[:, :15], max_len=16)
        last, _ = pair.port.decode_step(pair.params, toks[:, 15], cache, 15)
    _close(last, full[:, -1])


def test_decode_leaves_the_caches_passed_in_alone(pair):
    toks = _t(pair.tokens(2, 17, seed=3))
    with torch.no_grad():
        _, cache = pair.port.prefill(pair.params, toks[:, :16], max_len=17)
        before = {k: v.clone() for k, v in cache.items()}
        pair.port.decode_step(pair.params, toks[:, 16], cache, 16)
    assert all(torch.equal(cache[k], before[k]) for k in before)


def test_sliding_window_ring_cache():
    """TinyLlama with an 8-position sliding window at S = 16: the prefill's
    ring cache (the last 8 keys rolled into slot ``i % 8``) and 4 decode
    steps past the window, against the reference."""
    sw = dict(sliding_window=8)
    pair = Pair(replace(ref_reduced("tinyllama_1_1b"), **sw),
                replace(get_reduced_config("tinyllama_1_1b"), **sw), seed=1)
    toks = pair.tokens(2, 20, seed=4)
    want, ref_cache = pair.ref_prefill(pair.ref_params,
                                       jnp.asarray(toks[:, :16]), max_len=20)
    with torch.no_grad():
        got, cache = pair.port.prefill(pair.params, _t(toks[:, :16]),
                                       max_len=20)
        assert cache["layers/0/k"].shape[1] == 8
        _close(got, want)
        _close_trees(cache, ref_cache)
        for pos in range(16, 20):
            want, ref_cache = pair.ref_decode(pair.ref_params,
                                              jnp.asarray(toks[:, pos]),
                                              ref_cache, pos)
            got, cache = pair.port.decode_step(pair.params, _t(toks[:, pos]),
                                               cache, pos)
            _close(got, want)
        _close_trees(cache, ref_cache)


def test_prefill_options_and_decode_overrides_match_reference(pair):
    """``pos_offset`` and ``return_all_logits`` of the prefill, and a
    decode step with a per-slot ``valid`` mask and per-row ``rope_pos``
    (the continuous batcher's arguments), against the reference."""
    toks = pair.tokens(2, 17, seed=6)
    kw = dict(pos_offset=3, return_all_logits=True)
    want, ref_cache = jax.jit(pair.ref.prefill, static_argnames=(
        "max_len", "pos_offset", "return_all_logits"))(
        pair.ref_params, jnp.asarray(toks[:, :16]), max_len=20, **kw)
    with torch.no_grad():
        got, cache = pair.port.prefill(pair.params, _t(toks[:, :16]),
                                       max_len=20, **kw)
    assert got.shape == (2, 16, pair.vocab)
    _close(got, want)
    valid = np.zeros((2, 20), bool)
    valid[0, :17] = True
    valid[1, 4:17] = True
    rope_pos = np.array([19, 12], np.int32)
    want, _ = pair.ref_decode(pair.ref_params, jnp.asarray(toks[:, 16]),
                              ref_cache, 16, valid=jnp.asarray(valid),
                              rope_pos=jnp.asarray(rope_pos))
    with torch.no_grad():
        got, _ = pair.port.decode_step(pair.params, _t(toks[:, 16]), cache,
                                       16, valid=torch.from_numpy(valid),
                                       rope_pos=_t(rope_pos))
    _close(got, want)


def test_init_cache_matches_reference(pair):
    want = jax.eval_shape(lambda: pair.ref.init_cache(3, 40))
    got = pair.port.init_cache(3, 40, device="cpu")
    for stack, leaves in want.items():
        for name, sd in leaves.items():
            for i in range(sd.shape[0]):
                t = got[f"{stack}/{i}/{name}"]
                assert tuple(t.shape) == sd.shape[1:], (stack, name)
                assert str(t.dtype).split(".")[-1] == str(sd.dtype), name
                assert not t.any()
    assert len(got) == sum(sd.shape[0] for leaves in want.values()
                           for sd in leaves.values())
    # a decode step from empty float32 caches (the continuous batcher's
    # start: model.init_cache(..., model.param_dtype))
    toks = pair.tokens(3, 1, seed=8)[:, 0]
    want, _ = pair.ref_decode(pair.ref_params, jnp.asarray(toks),
                              pair.ref.init_cache(3, 40, jnp.float32), 0)
    with torch.no_grad():
        got, _ = pair.port.decode_step(
            pair.params, _t(toks),
            pair.port.init_cache(3, 40, torch.float32, device="cpu"), 0)
    _close(got, want)


# -- Mamba2's loss -----------------------------------------------------------


@pytest.fixture(scope="module")
def mamba():
    return Pair(ref_reduced("mamba2_130m"), get_reduced_config("mamba2_130m"),
                seed=3)


def test_mamba2_loss_matches_reference(mamba):
    toks = mamba.tokens(2, 64, seed=5)
    want, wm = jax.jit(mamba.ref.loss)(mamba.ref_params,
                                        {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, gm = mamba.port.loss(mamba.params, {"tokens": _t(toks)})
    _close(got, want)
    assert set(gm) == set(wm)
    for k in wm:
        _close(gm[k], wm[k])


def test_mamba2_cannot_train_yet(mamba):
    """The clients' ``[C, ...]`` loss trains: its gradient runs through the
    differentiable chunked SSD, is finite and reaches every SSM leaf.  One
    model's loss still runs the SSD chunk kernel (TPU row 12), which has no
    backward: its gradient raises, pointing to ``models.ssm.ssd_chunked``."""
    toks = _t(mamba.tokens(2, 32))
    params = {k: v.clone().requires_grad_() for k, v in
              mamba.params.items()}
    with pytest.raises(NotImplementedError, match="models.ssm.ssd_chunked"):
        mamba.port.loss(params, {"tokens": toks})
    stacked = {k: torch.stack([v, v]).requires_grad_() for k, v in
               mamba.params.items()}
    loss, _ = mamba.port.loss(stacked, {"tokens": torch.stack([toks, toks])})
    assert loss.shape == (2,)
    with torch.no_grad():
        one, _ = mamba.port.loss(mamba.params, {"tokens": toks})
    _close(loss.detach(), torch.stack([one, one]))
    grads = torch.autograd.grad(loss.sum(), list(stacked.values()))
    for k, g in zip(stacked, grads):
        assert torch.isfinite(g).all(), k
        if "/ssm/" in k:
            assert torch.count_nonzero(g) > 0, k


def test_mamba2_checkpoints_load_in_the_other_package(mamba, tmp_path):
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, mamba.params, {"round": 1})
    tree, _ = ref_ckpt.load(path)
    jax.tree_util.tree_map(np.testing.assert_array_equal, tree,
                           jax.tree_util.tree_map(np.asarray,
                                                  mamba.ref_params))
    ref_ckpt.save(path, mamba.ref_params, {"round": 2})
    params, meta = checkpoint.load(path, device="cpu")
    assert meta["round"] == 2 and params.keys() == mamba.params.keys()
    assert all(torch.equal(params[k], mamba.params[k]) for k in params)


# -- the serve launcher ------------------------------------------------------


def test_sample_prompts_match_reference():
    for arch in ARCHS:
        got, _ = sample_prompts(get_reduced_config(arch), 3, 20, seed=7)
        want, _ = ref_prompts(ref_reduced(arch), 3, 20, seed=7)
        assert got.dtype == np.int32 and np.array_equal(got, want)


def test_generate_matches_reference_loop(pair):
    """``serve.generate`` against the reference's greedy loop: the reference
    is fed the port's tokens (teacher-forced), so a near tie cannot send
    the two down different continuations; its logits must match at every
    step, and the port's token must be the reference's argmax wherever
    the reference's top-2 margin exceeds the tolerance."""
    S, G = 32, 6
    prompts, _ = ref_prompts(pair.ref.cfg, 2, S, seed=0)
    out = serve.generate(pair.port, pair.params, _t(prompts), G,
                         return_logits=True)
    toks = out["tokens"].numpy()
    assert toks.shape == (2, G) and len(out["logits"]) == G + 1
    want, cache = pair.ref_prefill(pair.ref_params, jnp.asarray(prompts),
                                   max_len=S + G)
    checked = 0
    for i in range(G + 1):
        _close(out["logits"][i], want)
        if i == G:
            break
        w = np.asarray(want)
        top2 = np.sort(w, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > ATOL + RTOL * np.abs(top2[:, 1])
        assert np.array_equal(toks[sure, i], w.argmax(-1)[sure])
        checked += int(sure.sum())
        want, cache = pair.ref_decode(pair.ref_params,
                                      jnp.asarray(toks[:, i]), cache, S + i)
    assert checked > 0


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mamba2_130m", "--reduced", "--device", "cpu", "--batch", "2",
         "--gen", "4"], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].startswith("prefill: ")
    assert "(2x32 tokens, cpu)" in lines[0]
    assert lines[1].startswith("decode : ") and "ms/token (4 steps" in lines[1]
    assert lines[2].startswith("sample generations")


def test_continuous_engine_names_the_roadmap_item():
    # the continuous batcher is ported (A9) for the attention families;
    # it refuses recurrent state, as the reference's does
    with pytest.raises(AssertionError, match="generation-level batching"):
        serve.main(["--arch", "mamba2_130m", "--reduced", "--device", "cpu",
                    "--engine", "continuous"])
