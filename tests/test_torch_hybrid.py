"""The hybrid block (Hymba-1.5B) in the port against the JAX reference.

Reduced Hymba-1.5B (2 layers, d_model 256, 5 query heads and one kv head of
32 under a sliding window of 64, an SSM branch of 16 heads of 32 with
d_state 16 and chunk 32, d_ff 512), params made by the reference and
converted through numpy:

- ``Model.loss`` of one model, ``Model.prefill`` (logits and every cache
  leaf: the ring ``k``/``v`` of the window and the SSM's ``h`` and conv
  tails, carried back with ``convert.to_reference``) on a prompt of 96
  tokens, past the window, so the ring wraps; 4 teacher-forced decode
  steps after it; ``init_cache``; the port's own prefill + decode ==
  forward identity;
- 3 federated rounds (C = 4, K = 2, S = 64, the default axes: ``d_ff``
  256 of 512 and ``ssm_heads`` 8 of 16; the single kv head leaves the
  heads windows improper) of the port's fused and extract phases against
  the reference's extract arm, with its offsets injected (its fused ==
  extract pins fail on jax 0.9, ROADMAP.md §C).  On these batches the
  reference's fused arm equals its extract arm to the bit, and the port
  lies within 7.2e-6 of both (the params' largest difference);
- fused == extract inside the port to the bit, 3 rounds;
- ``convert`` round trips of the params and of the mixed caches;
- ``launch/serve.py`` and ``launch/train.py`` with ``--arch hymba_1_5b``,
  and ``examples/serve_demo_torch.py`` over its three families.

Tolerance: float32, atol 1e-5 and rtol 1e-5 (two frameworks, other
summation orders through two layers and 6 SGD steps at lr 0.1).
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as ref_api  # noqa: E402
from repro.configs.base import SubmodelConfig as RefSubmodelConfig  # noqa
from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.configs.base import get_reduced_config as ref_reduced  # noqa: E402
from repro.data.synthetic import lm_batches as ref_lm_batches  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch.configs.base import (SubmodelConfig,  # noqa: E402
                                      get_config, get_reduced_config)
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ATOL = RTOL = 1e-5
ARCH = "hymba_1_5b"
ROUNDS, S, C = 3, 64, 4
PROMPT = 96                      # past the sliding window of 64
SCFG = dict(scheme="rolling", capacity=0.5, local_steps=2,
            clients_per_round=C, client_lr=0.1)


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


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                               rtol=RTOL)


def _close_trees(port_caches, ref_caches):
    got = convert.to_reference(port_caches)
    want = _np(ref_caches)
    assert got.keys() == want.keys()
    for stack in want:
        assert got[stack].keys() == want[stack].keys()
        for name in want[stack]:
            assert got[stack][name].shape == want[stack][name].shape, name
            _close(got[stack][name], want[stack][name])


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


class Pair:
    """Reduced Hymba in both packages, the reference's params converted
    for the port, its entry points jitted."""

    def __init__(self):
        self.ref = ref_build(ref_reduced(ARCH), remat=False)
        self.port = build_model(get_reduced_config(ARCH))
        self.ref_params = self.ref.init(jax.random.PRNGKey(0))
        self.params0 = _np(self.ref_params)
        self.params = convert.from_reference(self.params0, device="cpu")
        self.ref_prefill = jax.jit(self.ref.prefill,
                                   static_argnames=("max_len",))
        self.ref_decode = jax.jit(self.ref.decode_step)
        self.vocab = self.ref.cfg.vocab

    def tokens(self, B, S, seed=0):
        rng = np.random.default_rng(seed)
        return rng.integers(0, self.vocab, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    return Pair()


# -- one model: loss, prefill, decode -------------------------------------------


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_config_and_params_match_reference(pair, reduced):
    want = (ref_reduced if reduced else ref_config)(ARCH)
    got = (get_reduced_config if reduced else get_config)(ARCH)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (vars(a) == vars(b) if f.name == "ssm" else a == b), f.name
    if reduced:
        assert pair.port.abstract_params() == {
            k: v.shape for k, v in pair.params.items()}


def test_loss_matches_reference(pair):
    toks = pair.tokens(2, PROMPT)
    want, _ = jax.jit(pair.ref.loss)(pair.ref_params,
                                     {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, metrics = pair.port.loss(pair.params, {"tokens": _t(toks)})
    _close(got, want)
    assert float(metrics["aux_loss"]) == 0.0
    # the clients' form (the round's) gives the same loss per client
    stacked = {k: torch.stack([v, v]) for k, v in pair.params.items()}
    with torch.no_grad():
        per, _ = pair.port.loss(stacked, {"tokens": torch.stack(
            [_t(toks), _t(toks)])})
    _close(per, torch.stack([got, got]))


def test_prefill_and_decode_match_reference(pair):
    """A prefill of 96 (the 64-slot ring wraps), then 4 teacher-forced
    decode steps, logits and every cache leaf at each step."""
    toks = pair.tokens(2, PROMPT + 4, seed=1)
    want, ref_cache = pair.ref_prefill(
        pair.ref_params, jnp.asarray(toks[:, :PROMPT]), max_len=PROMPT + 4)
    with torch.no_grad():
        got, cache = pair.port.prefill(pair.params, _t(toks[:, :PROMPT]),
                                       max_len=PROMPT + 4)
        assert cache["layers/0/k"].shape[1] == 64
        assert cache["layers/0/h"].shape == (2, 16, 32, 16)
        _close(got, want)
        _close_trees(cache, ref_cache)
        for pos in range(PROMPT, PROMPT + 4):
            want, ref_cache = pair.ref_decode(pair.ref_params,
                                              jnp.asarray(toks[:, pos]),
                                              ref_cache, pos)
            got, cache = pair.port.decode_step(pair.params, _t(toks[:, pos]),
                                               cache, pos)
            _close(got, want)
            _close_trees(cache, ref_cache)


def test_prefill_decode_equals_forward(pair):
    """prefill(t[:-1]) + decode(t[-1]) == forward(t)[-1] (the reference's
    identity, ``tests/test_system.py``); a prefill of 15 is one chunk."""
    toks = _t(pair.tokens(2, 16, seed=2))
    with torch.no_grad():
        full, _ = pair.port.forward(pair.params, toks)
        _, cache = pair.port.prefill(pair.params, toks[:, :15], max_len=16)
        last, _ = pair.port.decode_step(pair.params, toks[:, 15], cache, 15)
    _close(last, full[:, -1])


def test_init_cache_matches_reference(pair):
    want = jax.eval_shape(lambda: pair.ref.init_cache(3, 40))
    got = pair.port.init_cache(3, 40, device="cpu")
    assert len(got) == sum(sd.shape[0] for sd in want["layers"].values())
    for name, sd in want["layers"].items():
        for i in range(sd.shape[0]):
            t = got[f"layers/{i}/{name}"]
            assert tuple(t.shape) == sd.shape[1:], name
            assert str(t.dtype).split(".")[-1] == str(sd.dtype), name
    toks = pair.tokens(3, 1, seed=8)[:, 0]
    want, _ = pair.ref_decode(pair.ref_params, jnp.asarray(toks),
                              pair.ref.init_cache(3, 40, jnp.float32), 0)
    with torch.no_grad():
        got, _ = pair.port.decode_step(
            pair.params, _t(toks),
            pair.port.init_cache(3, 40, torch.float32, device="cpu"), 0)
    _close(got, want)


def test_convert_round_trips_params_and_caches(pair):
    back = convert.to_reference(pair.params)
    for path, w in _leaves(pair.params0).items():
        np.testing.assert_array_equal(_leaves(back)[path], w)
    with torch.no_grad():
        _, cache = pair.port.prefill(pair.params, _t(pair.tokens(2, 32)),
                                     max_len=36)
    again = convert.from_reference(convert.to_reference(cache), "cpu")
    assert again.keys() == cache.keys()
    assert all(torch.equal(again[k], cache[k]) for k in cache)


# -- rounds -------------------------------------------------------------------


def _offsets(fed, r):
    return {k: [int(o) for o in np.asarray(v)] for k, v in
            fed.scheme.offsets(None, r, C).items()}


@pytest.fixture(scope="module")
def reference_runs(pair):
    """3 rounds of the reference's extract and fused arms, with the offsets
    each drew."""
    it = ref_lm_batches(pair.vocab, (2, C, 2), S, seed=0)
    batches = [next(it) for _ in range(ROUNDS)]
    runs = {}
    for ff in ("off", "on"):
        fed = ref_api.fed_round(pair.ref, RefSubmodelConfig(**SCFG),
                                kernel_backend="jnp", fused_forward=ff)
        trainer = ref_api.Trainer(fed, jax.tree_util.tree_map(
            jnp.asarray, pair.params0), rng=1)
        params, history = trainer.run(
            ({k: jnp.asarray(v) for k, v in b.items()} for b in batches),
            ROUNDS)
        runs[ff] = dict(
            params=_np(params),
            offsets=[_offsets(fed, r) for r in range(ROUNDS)],
            client_loss=[np.asarray(h["client_loss"]) for h in history])
    return dict(batches=batches, runs=runs)


@pytest.mark.parametrize("ff", ["auto", "off"], ids=["fused", "extract"])
def test_three_rounds_match_reference_extract_arm(pair, reference_runs, ff):
    ref = reference_runs
    fed = api.fed_round(pair.port, SubmodelConfig(**SCFG), fused_forward=ff,
                        device="cpu")
    assert fed.use_fused == (ff == "auto")
    trainer = api.Trainer(fed, convert.from_reference(pair.params0, "cpu"))
    trainer.run(((b, {"offsets": o}) for b, o in
                 zip(ref["batches"], ref["runs"]["off"]["offsets"])), ROUNDS)
    for arm in ("off", "on"):          # the extract arm, then the fused
        run = ref["runs"][arm]
        for r, h in enumerate(trainer.history):
            _close(h["client_loss"].numpy(), run["client_loss"][r])
        got = _leaves(convert.to_reference(trainer.params))
        for path, want in _leaves(run["params"]).items():
            np.testing.assert_allclose(got[path], want, atol=ATOL,
                                       rtol=RTOL, err_msg=f"{arm} {path}")


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_fused_equals_extract_to_the_bit(pair):
    batches = lm_batches(pair.vocab, (2, C, 2), S, seed=0)
    batches = [next(batches) for _ in range(ROUNDS)]
    out = {}
    for ff in ("on", "off"):
        fed = api.fed_round(pair.port, SubmodelConfig(**SCFG),
                            fused_forward=ff, device="cpu")
        trainer = api.Trainer(fed, pair.port.init(0, device="cpu"))
        trainer.run(iter(batches), ROUNDS)
        out[ff] = trainer
    fused, extract = out["on"], out["off"]
    for a, b in zip(fused.history, extract.history):
        assert torch.equal(_bits(a["client_loss"]), _bits(b["client_loss"]))
    for k in fused.params:
        assert torch.equal(_bits(fused.params[k]),
                           _bits(extract.params[k])), k


# -- entry points ---------------------------------------------------------------


def test_train_cli_trains_hymba(capsys):
    out = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--rounds", "2", "--seq", str(S), "--log-every", "1",
                      "--lr", "0.1"])
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    assert len(re.findall(r"round +\d+ loss", capsys.readouterr().out)) == 2


def test_serve_cli_serves_hymba(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", str(PROMPT), "--gen", "4"])
    out = capsys.readouterr().out
    assert "prefill:" in out and "ms/token" in out


def test_serve_demo_example_runs_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "serve_demo_torch.py"),
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=300, check=True).stdout
    for arch in ("tinyllama_1_1b", "mamba2_130m", ARCH):
        assert f"=== {arch} ===" in out
    assert out.count("ms/token") == 3
