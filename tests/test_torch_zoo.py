"""The dense and MoE model zoo in the port against the JAX reference.

Reduced DeepSeek-7B (8 heads on 4 kv heads of 32 after the cut),
Qwen3-14B (the same with ``qk_norm``) and Mixtral-8x22B (4 experts,
top-2, per-expert width 256, a sliding window of 64), 2 layers each,
params made by the reference and converted through numpy:

- the configs field for field and ``n_params`` / ``n_active_params`` of
  the four full configs (Qwen3-32B too);
- ``Model.loss`` (with its ``aux_loss``) and the logits of one model,
  ``Model.prefill`` and 3 teacher-forced decode steps (logits and every
  cache leaf), the port's prefill + decode == forward identity, and the
  ``convert`` round trips of the expert stacks and the ``q_norm`` /
  ``k_norm`` leaves; Mixtral on the ``dense`` path, and on ``dropping``
  at a capacity factor that holds every choice;
- the reference fault the port does not copy: the reference's
  ``dropping`` dispatch zeroes an overflowing expert's first token;
- reduced Mixtral rounds (C = 4, K = 2, 2 x 32 tokens a step, rolling at
  0.5 on the default axes: ``experts`` 2 of 4, ``moe_d_ff`` 128 of 256,
  ``kv_heads`` 2 of 4 and ``heads`` 4 of 8) of the port's fused and
  extract phases against the reference's extract arm, with its offsets
  injected: shared windows on ``dense`` and on ``dropping``, and
  staggered windows on ``dense``;
- fused == extract inside the port to the bit (Mixtral on both paths and
  staggered, Qwen3), the exact zeros outside the expert windows, and the
  shared-expert arm (``n_shared``, sigmoid routing) of one MoE layer
  against the reference's, windowed and not;
- ``api.fed_round`` and ``api.Trainer`` through the training CLI on the
  seven reduced configs.

The generic tests (configs, ``n_params``, loss and logits, prefill and
decode, prefill + decode == forward, the ``convert`` round trips, the
training CLI) also run reduced DeepSeek-V3 (MLA, a leading dense layer,
the MoE layer, the MTP block), MusicGen-large (4 codebooks, sinusoidal
positions, gelu) and Phi-3-vision (tokens only here; its patches in
``tests/test_torch_audio_vlm.py``).

Tolerance: float32, atol 1e-5 and rtol 1e-5 (two frameworks, other
summation orders through two layers and 4 SGD steps at lr 0.1).
"""
import dataclasses
import re

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
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.layers import AxisWindow as RefAxisWindow  # noqa: E402
from repro.models.layers import WindowMap as RefWindowMap  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch.configs.base import (MoEConfig, SubmodelConfig,  # noqa
                                      get_config, get_reduced_config)
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import AxisWindow, WindowMap  # noqa: E402

ATOL = RTOL = 1e-5
ARCHS = ["deepseek_7b", "qwen3_14b", "mixtral_8x22b", "deepseek_v3_671b",
         "musicgen_large", "phi_3_vision_4_2b"]
FULL = ["deepseek_7b", "qwen3_14b", "qwen3_32b", "mixtral_8x22b",
        "deepseek_v3_671b", "musicgen_large", "phi_3_vision_4_2b"]
ROUNDS, S, C = 2, 32, 4
PROMPT = 24
SCFG = dict(scheme="rolling", capacity=0.5, local_steps=2,
            clients_per_round=C, client_lr=0.1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (the suite runs in several
    worker processes at once; a pool of a thread per core in each of them
    oversubscribes the machine)."""
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


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _with_moe(cfg, **over):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **over))


class Pair:
    """A reduced config in both packages, the reference's params converted
    for the port, its entry points jitted."""

    def __init__(self, arch, path="dense", **moe_over):
        rc, pc = ref_reduced(arch), get_reduced_config(arch)
        if moe_over:
            rc, pc = _with_moe(rc, **moe_over), _with_moe(pc, **moe_over)
        self.ref = ref_build(rc, moe_path=path, remat=False)
        self.port = build_model(pc, moe_path=path)
        self.ref_params = self.ref.init(jax.random.PRNGKey(0))
        self.params0 = _np(self.ref_params)
        self.params = convert.from_reference(self.params0, device="cpu")
        self.vocab = rc.vocab

    def tokens(self, B, S_, seed=0):
        """``[B, S]`` tokens, ``[B, S, CB]`` for a codebook model."""
        rng = np.random.default_rng(seed)
        cb = self.port.cfg.n_codebooks
        return rng.integers(0, self.vocab, (B, S_, cb) if cb else
                            (B, S_)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(request.param)


# -- configs ------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", FULL)
def test_config_matches_reference(arch, reduced):
    want = (ref_reduced if reduced else ref_config)(arch)
    got = (get_reduced_config if reduced else get_config)(arch)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (vars(a) == vars(b) if f.name in ("moe", "mla") and a
                else a == b), f.name


@pytest.mark.parametrize("arch", FULL)
def test_n_params_match_reference(arch):
    got, want = get_config(arch), ref_config(arch)
    assert got.n_params() == want.n_params()
    assert got.n_active_params() == want.n_active_params()
    if got.moe is None:
        assert got.n_active_params() == got.n_params()


# -- one model: loss, logits, prefill, decode ---------------------------------


def test_loss_and_logits_match_reference(pair):
    toks = pair.tokens(2, 64)
    want, wm = jax.jit(pair.ref.loss)(pair.ref_params,
                                      {"tokens": jnp.asarray(toks)})
    logits, _, _ = jax.jit(pair.ref.forward)(pair.ref_params,
                                             jnp.asarray(toks))
    with torch.no_grad():
        got, gm = pair.port.loss(pair.params, {"tokens": _t(toks)})
        got_logits, _ = pair.port.forward(pair.params, _t(toks))
    _close(got, want)
    _close(gm["aux_loss"], wm["aux_loss"])
    _close(got_logits, logits)
    assert (float(gm["aux_loss"]) > 0) == (pair.port.cfg.moe is not None)
    assert pair.port.abstract_params() == {k: v.shape for k, v in
                                           pair.params.items()}


def test_dropping_loss_matches_reference_when_nothing_overflows():
    """At a capacity factor that holds every choice, the two dispatches
    agree (the reference's fault needs an overflowing expert)."""
    p = Pair("mixtral_8x22b", "dropping", capacity_factor=8.0)
    toks = p.tokens(2, 64, seed=3)
    want, wm = jax.jit(p.ref.loss)(p.ref_params,
                                   {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, gm = p.port.loss(p.params, {"tokens": _t(toks)})
    _close(got, want)
    _close(gm["aux_loss"], wm["aux_loss"])


def _close_caches(port_caches, ref_caches):
    got, want = convert.to_reference(port_caches), _np(ref_caches)
    assert got.keys() == want.keys()
    for stack in want:
        assert got[stack].keys() == want[stack].keys()
        for name in want[stack]:
            _close(got[stack][name], want[stack][name])


def test_prefill_and_decode_match_reference(pair):
    toks = pair.tokens(2, PROMPT + 3, seed=1)
    ref_prefill = jax.jit(pair.ref.prefill, static_argnames=("max_len",))
    ref_decode = jax.jit(pair.ref.decode_step)
    want, ref_cache = ref_prefill(pair.ref_params,
                                  jnp.asarray(toks[:, :PROMPT]),
                                  max_len=PROMPT + 3)
    with torch.no_grad():
        got, cache = pair.port.prefill(pair.params, _t(toks[:, :PROMPT]),
                                       max_len=PROMPT + 3)
        _close(got, want)
        _close_caches(cache, ref_cache)
        for pos in range(PROMPT, PROMPT + 3):
            want, ref_cache = ref_decode(pair.ref_params,
                                         jnp.asarray(toks[:, pos]),
                                         ref_cache, pos)
            got, cache = pair.port.decode_step(pair.params, _t(toks[:, pos]),
                                               cache, pos)
            _close(got, want)
            _close_caches(cache, ref_cache)


def test_prefill_decode_equals_forward(pair):
    """prefill(t[:-1]) + decode(t[-1]) == forward(t)[-1] (the reference's
    identity, ``tests/test_system.py``)."""
    toks = _t(pair.tokens(2, 16, seed=2))
    with torch.no_grad():
        full, _ = pair.port.forward(pair.params, toks)
        _, cache = pair.port.prefill(pair.params, toks[:, :15], max_len=16)
        last, _ = pair.port.decode_step(pair.params, toks[:, 15], cache, 15)
    _close(last, full[:, -1])


def test_convert_round_trips_experts_and_qk_norm(pair):
    back = convert.to_reference(pair.params)
    for path, w in _leaves(pair.params0).items():
        np.testing.assert_array_equal(_leaves(back)[path], w)
    again = convert.from_reference(back, "cpu")
    assert all(torch.equal(again[k], pair.params[k]) for k in pair.params)
    cfg = pair.port.cfg
    D = cfg.d_model
    if cfg.moe is not None:
        E, Fe = cfg.moe.n_experts, cfg.moe.d_ff
        n_moe = cfg.n_layers - cfg.n_dense_layers
        assert back["moe_layers"]["moe"]["w_gate"].shape == (n_moe, E, D, Fe)
        assert pair.params[f"moe_layers/{n_moe - 1}/moe/w_down"].shape == (
            E, Fe, D)
        assert pair.port.axes()["moe_layers/0/moe/w_up"] == (
            "experts", "d_model", "moe_d_ff")
    if cfg.n_dense_layers:
        assert back["dense_layers"]["mlp"]["w_up"].shape == (
            cfg.n_dense_layers, D, cfg.d_ff)
    if cfg.mla is not None:
        m = cfg.mla
        assert back["dense_layers"]["attn"]["w_uk"].shape == (
            cfg.n_dense_layers, m.kv_lora_rank, cfg.n_heads, m.nope_head_dim)
        assert pair.port.axes()["moe_layers/0/attn/w_uv"] == (
            "mla_kv_rank", "heads", "v_head_dim")
    if cfg.mtp:
        assert back["mtp"]["mlp"]["w_gate"].shape == (D, cfg.d_ff)
        assert back["mtp"]["final"].shape == (D,)
    if cfg.n_codebooks:
        assert back["head"].shape == (cfg.n_codebooks, D, cfg.vocab)
    if cfg.vision_stub:
        assert back["vision_proj"]["w1"].shape == (cfg.vision_d, D)
    if cfg.qk_norm:
        assert back["layers"]["attn"]["q_norm"].shape == (2, cfg.head_dim)
        assert pair.port.axes()["layers/0/attn/k_norm"] == ("head_dim",)


# -- the reference fault the port does not copy -------------------------------


def test_reference_dropping_zeroes_an_overflowing_experts_first_token():
    """One MoE layer of reduced Mixtral on 16 copies of one token: every
    token picks the same two experts, which hold 10 each (capacity factor
    1.25 over 4 experts), so both overflow.  The reference's dispatch
    writes every dropped choice's zeros into its expert's rank-0 slot, and
    XLA keeps the last write: token 0, first in both buckets, loses both
    experts' outputs.  The port keeps it (its row equals the dense
    path's), and at a capacity that holds every choice the port's
    ``dropping`` equals its ``dense``."""
    p = Pair("mixtral_8x22b", "dropping")
    cfg = p.port.cfg
    layer = {k: v[0] for k, v in p.params0["moe_layers"]["moe"].items()}
    x = np.random.default_rng(4).standard_normal((1, 1, cfg.d_model))
    x = np.repeat(x, 16, axis=1).astype(np.float32)            # [1, 16, D]
    ref_out, _ = ref_moe.moe_apply(
        {k: jnp.asarray(v) for k, v in layer.items()}, jnp.asarray(x),
        p.ref.cfg, path="dropping")
    ref_out = np.asarray(ref_out)
    pl = {k: torch.as_tensor(v)[None] for k, v in layer.items()}
    xt = torch.as_tensor(x)[None]
    with torch.no_grad():
        got, _ = moe.moe_apply(pl, xt, cfg, path="dropping")
        dense, _ = moe.moe_apply(pl, xt, cfg, path="dense")
        roomy, _ = moe.moe_apply(pl, xt, _with_moe(cfg, capacity_factor=8.0),
                                 path="dropping")
    got, dense = got[0, 0].numpy(), dense[0, 0].numpy()
    cap = int(16 * 2 / 4 * 1.25)
    assert cap == 10
    assert np.all(ref_out[0, 0] == 0.0)                 # the fault
    assert np.abs(dense[0]).max() > 0
    _close(got[:cap], dense[:cap])                      # the port keeps it
    _close(ref_out[0, 1:cap], dense[1:cap])             # the rest agree
    assert np.all(got[cap:] == 0.0) and np.all(ref_out[0, cap:] == 0.0)
    _close(roomy[0, 0], dense)


# -- rounds -------------------------------------------------------------------


def _offsets(fed, r):
    return {k: [int(o) for o in np.asarray(v)] for k, v in
            fed.scheme.offsets(None, r, C).items()}


RUNS = {"dense": ("dense", {}), "dropping": ("dropping", {}),
        "dense staggered": ("dense", {"stagger": True})}


@pytest.fixture(scope="module")
def mixtral_runs():
    """2 rounds of the reference's extract arm on reduced Mixtral per run,
    with the offsets it drew."""
    it = ref_lm_batches(ref_reduced("mixtral_8x22b").vocab, (2, C, 2), S,
                        seed=0)
    batches = [next(it) for _ in range(ROUNDS)]
    out = {}
    for name, (path, over) in RUNS.items():
        p = Pair("mixtral_8x22b", path)
        fed = ref_api.fed_round(p.ref, RefSubmodelConfig(**SCFG, **over),
                                kernel_backend="jnp", fused_forward="off")
        trainer = ref_api.Trainer(fed, jax.tree_util.tree_map(
            jnp.asarray, p.params0), rng=1)
        params, history = trainer.run(
            ({k: jnp.asarray(v) for k, v in b.items()} for b in batches),
            ROUNDS)
        out[name] = dict(
            pair=p, params=_np(params),
            offsets=[_offsets(fed, r) for r in range(ROUNDS)],
            client_loss=[np.asarray(h["client_loss"]) for h in history])
    return dict(batches=batches, runs=out)


def _port_rounds(model, params, scfg, batches, offsets, ff):
    fed = api.fed_round(model, scfg, fused_forward=ff, device="cpu")
    assert fed.use_fused == (ff == "on")
    trainer = api.Trainer(fed, params)
    items = (zip(batches, ({"offsets": o} for o in offsets)) if offsets
             else iter(batches))
    trainer.run(items, len(batches))
    return trainer


@pytest.mark.parametrize("ff", ["on", "off"], ids=["fused", "extract"])
@pytest.mark.parametrize("run", list(RUNS))
def test_mixtral_rounds_match_reference_extract_arm(mixtral_runs, run, ff):
    ref = mixtral_runs["runs"][run]
    path, over = RUNS[run]
    p = ref["pair"]
    trainer = _port_rounds(p.port, convert.from_reference(p.params0, "cpu"),
                           SubmodelConfig(**SCFG, **over),
                           mixtral_runs["batches"], ref["offsets"], ff)
    assert ("experts", 4) in trainer.fed.scheme.sizes
    assert ("moe_d_ff", 256) in trainer.fed.scheme.sizes
    for r, h in enumerate(trainer.history):
        _close(h["client_loss"].numpy(), ref["client_loss"][r])
    got = _leaves(convert.to_reference(trainer.params))
    for path_, want in _leaves(ref["params"]).items():
        np.testing.assert_allclose(got[path_], want, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{run} {ff} {path_}")
    if path == "dropping" and ff == "on":
        # the batch's expert loads: each client routes its 64 tokens' top-2
        # choices; in the round, over its window of 2 experts (capacity
        # 64: none dropped), here over all 4 (capacity 40)
        print(f"[zoo] reduced Mixtral, round 0 step 0, all 4 experts: "
              f"choices per expert and client, by layer "
              f"{_expert_loads(p, mixtral_runs['batches'][0])}")


def _expert_loads(p, batch):
    """The routed choices per expert and client of each MoE layer on
    ``batch``'s first step (the clients' form, no window)."""
    loads = []
    route = moe._route

    def counting(router, x, cfg):
        w, idx, aux = route(router, x, cfg)
        loads.append([torch.bincount(i.reshape(-1), minlength=4).tolist()
                      for i in idx])
        return w, idx, aux
    tokens = torch.as_tensor(batch["tokens"][0], dtype=torch.long)
    stacked = {k: v[None].expand(C, *v.shape) for k, v in p.params.items()}
    moe._route = counting
    try:
        with torch.no_grad():
            p.port.loss(stacked, {"tokens": tokens})
    finally:
        moe._route = route
    return loads


@pytest.mark.parametrize("case", ["mixtral dense", "mixtral dropping",
                                  "mixtral staggered", "qwen3"])
def test_fused_equals_extract_to_the_bit(case):
    arch = "qwen3_14b" if case == "qwen3" else "mixtral_8x22b"
    path = "dense" if case == "mixtral dense" else "dropping"
    cfg = get_reduced_config(arch)
    model = build_model(cfg, moe_path=path)
    it = lm_batches(cfg.vocab, (2, C, 2), S, seed=0)
    batches = [next(it) for _ in range(ROUNDS)]
    scfg = SubmodelConfig(**SCFG, stagger=case == "mixtral staggered")
    out = {ff: _port_rounds(model, model.init(0, device="cpu"), scfg,
                            batches, None, ff) for ff in ("on", "off")}
    fused, extract = out["on"], out["off"]
    for a, b in zip(fused.history, extract.history):
        assert torch.equal(_bits(a["client_loss"]), _bits(b["client_loss"]))
    for k in fused.params:
        assert torch.equal(_bits(fused.params[k]),
                           _bits(extract.params[k])), k


def test_grads_are_zero_outside_the_expert_windows():
    """The fused forward's gradient on the full expert stacks is exactly 0
    outside each client's ``experts`` x ``moe_d_ff`` window, per-client
    windows included (the experts' products read the full stacks and
    write their gradients into full-shaped zeros)."""
    cfg = get_reduced_config("mixtral_8x22b")
    model = build_model(cfg)
    p = model.init(0, device="cpu")
    stacked = {k: v[None].repeat(2, *([1] * v.dim())).requires_grad_()
               for k, v in p.items()}
    window = WindowMap({("experts", 4): AxisWindow([0, 2], 2),
                        ("moe_d_ff", 256): AxisWindow([128, 64], 128)})
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 2, 32)), dtype=torch.long)
    loss, _ = model.loss(stacked, {"tokens": toks}, window=window)
    grads = dict(zip(stacked, torch.autograd.grad(loss.sum(),
                                                  list(stacked.values()))))
    for c, (e0, f0) in enumerate([(0, 128), (2, 64)]):
        for name, fdim in (("w_gate", 3), ("w_up", 3), ("w_down", 2)):
            g = grads[f"moe_layers/0/moe/{name}"][c]
            inside = g[e0:e0 + 2].narrow(fdim - 1, f0, 128)
            assert torch.count_nonzero(inside) > 0
            assert torch.count_nonzero(g) == torch.count_nonzero(inside)
        r = grads["moe_layers/0/moe/router"][c]
        assert torch.count_nonzero(r[:, e0:e0 + 2]) == \
            torch.count_nonzero(r) > 0


@pytest.mark.parametrize("path", ["dense", "dropping"])
@pytest.mark.parametrize("windowed", [False, True], ids=["full", "window"])
def test_shared_experts_and_sigmoid_routing_match_reference(path, windowed):
    """One MoE layer with a shared expert (its width windowed on its own
    ``moe_d_ff`` key) and DeepSeek-V3's sigmoid router, against the
    reference's ``moe_apply``."""
    mo = dict(n_experts=4, top_k=2, d_ff=64, n_shared=2, router="sigmoid",
              capacity_factor=4.0)
    rc = dataclasses.replace(ref_reduced("mixtral_8x22b"), d_model=64,
                             moe=dataclasses.replace(ref_reduced(
                                 "mixtral_8x22b").moe, **mo))
    pc = dataclasses.replace(get_reduced_config("mixtral_8x22b"), d_model=64,
                             moe=MoEConfig(**mo))
    rng = np.random.default_rng(5)
    shapes = {"router": (64, 4), "w_gate": (4, 64, 64), "w_up": (4, 64, 64),
              "w_down": (4, 64, 64), "shared/w_gate": (64, 128),
              "shared/w_up": (64, 128), "shared/w_down": (128, 64)}
    flat = {k: (rng.standard_normal(s) / 8).astype(np.float32)
            for k, s in shapes.items()}
    nested = {k: v for k, v in flat.items() if "/" not in k}
    nested["shared"] = {k[7:]: v for k, v in flat.items() if "/" in k}
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    spans = {("experts", 4): (1, 2), ("moe_d_ff", 64): (32, 32),
             ("moe_d_ff", 128): (64, 64)}
    rw = RefWindowMap({k: RefAxisWindow(*v) for k, v in spans.items()},
                      backend="jnp") if windowed else None
    pw = WindowMap({k: AxisWindow([v[0]], v[1]) for k, v in spans.items()}
                   ) if windowed else None
    want, waux = ref_moe.moe_apply(jax.tree_util.tree_map(jnp.asarray,
                                                          nested),
                                   jnp.asarray(x), rc, path=path, window=rw)
    with torch.no_grad():
        got, gaux = moe.moe_apply({k: torch.as_tensor(v)[None] for k, v in
                                   flat.items()}, torch.as_tensor(x)[None],
                                  pc, path=path, window=pw)
    _close(got[0], want)
    _close(gaux[0], waux)


# -- the training CLI ---------------------------------------------------------


@pytest.mark.parametrize("arch", FULL)
def test_train_cli_trains_the_zoo(arch, capsys):
    out = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--rounds", "2", "--seq", "16", "--clients", "2",
                      "--log-every", "1", "--lr", "0.1"])
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    assert len(re.findall(r"round +\d+ loss", capsys.readouterr().out)) == 2
