"""The audio and VLM families (reduced MusicGen-large and Phi-3-vision) and
the gelu repair, in the port against the JAX reference.

Reduced MusicGen-large: 2 layers, d_model 256, 8 heads on 4 kv heads of
32, gelu, sinusoidal positions (no RoPE), 4 codebooks of 512; reduced
Phi-3-vision: the same widths with RoPE and the vision stub (16 patches of
64 projected through ``w1``, gelu, ``w2`` and prepended).  Params made by
the reference and converted through numpy:

- ``act_fn("gelu")`` is the tanh form ``jax.nn.gelu`` computes by default
  (the port had the exact erf form, 4.1e-4 away on [-4, 4]), alone and in
  ``mlp_apply``; ``sinusoidal_positions``;
- the codebook loss (mean cross-entropy over every codebook) and the
  loss with patches (their logits dropped), one model's and the clients'
  form;
- 3 rounds (C = 2, K = 2 x 2 x 32 tokens, rolling at 0.5 on the default
  axes) of the port's fused and extract phases against the reference's
  extract arm (``fused_forward="off"``), offsets injected; fused ==
  extract to the bit inside the port;
- ``lm_batches`` with ``codebooks=`` and ``vision=`` bit for bit;
- ``serve.generate`` with codebook prompts and patches against the
  reference's prefill and decode loop (positions ``P + S + i``), and the
  serve CLI;
- every registered architecture (the reference's ``list_archs()``) trains
  a round and serves through the port's entry points.

Tolerance: float32, atol 1e-5 and rtol 1e-5 (gelu: 1e-6).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.configs.base import SubmodelConfig as RefSubmodelConfig  # noqa
from repro.configs.base import get_reduced_config as ref_reduced  # noqa: E402
from repro.configs.base import list_archs as ref_list_archs  # noqa: E402
from repro.data.synthetic import lm_batches as ref_lm_batches  # noqa: E402
from repro.launch.specs import sample_prompts as ref_sample_prompts  # noqa
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch.configs.base import (SubmodelConfig,  # noqa: E402
                                      get_reduced_config, list_archs)
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.specs import request_queue  # noqa: E402
from repro_torch.launch.specs import sample_prompts  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers  # noqa: E402

ATOL = RTOL = 1e-5
ARCHS = ["musicgen_large", "phi_3_vision_4_2b"]
ROUNDS, S, C = 3, 32, 2
SCFG = dict(scheme="rolling", capacity=0.5, local_steps=2,
            clients_per_round=C, client_lr=0.1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(a, b, msg="", tol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol, err_msg=msg)


def _vision(cfg):
    return (cfg.vision_patches, cfg.vision_d) if cfg.vision_stub else None


def _torch_batch(batch):
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.long)
            if k == "tokens" else torch.as_tensor(np.asarray(v))
            for k, v in batch.items()}


class Pair:
    def __init__(self, arch):
        self.rc = ref_reduced(arch)
        self.ref = ref_build(self.rc, remat=False)
        self.port = build_model(get_reduced_config(arch))
        self.ref_params = self.ref.init(jax.random.PRNGKey(0))
        self.params0 = _np(self.ref_params)
        self.params = convert.from_reference(self.params0, device="cpu")

    def batch(self, batch_shape, seq, seed=3):
        it = ref_lm_batches(self.rc.vocab, batch_shape, seq, seed=seed,
                            codebooks=self.rc.n_codebooks,
                            vision=_vision(self.rc))
        return next(it)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(request.param)


# -- the gelu repair ----------------------------------------------------------


def test_gelu_is_the_tanh_form_of_the_reference():
    x = np.linspace(-4.0, 4.0, 4001, dtype=np.float32)
    want = np.asarray(ref_layers.act_fn("gelu")(jnp.asarray(x)))
    got = layers.act_fn("gelu")(torch.as_tensor(x)).numpy()
    _close(got, want, tol=1e-6)
    exact = torch.nn.functional.gelu(torch.as_tensor(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4       # the erf form differs

    rng = np.random.default_rng(0)
    p = {"w_gate": rng.standard_normal((64, 128)) / 8,
         "w_up": rng.standard_normal((64, 128)) / 8,
         "w_down": rng.standard_normal((128, 64)) / 8}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    h = rng.standard_normal((2, 16, 64)).astype(np.float32)
    want = ref_layers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(h), "gelu")
    got = layers.mlp_apply({k: torch.as_tensor(v)[None] for k, v in
                            p.items()}, torch.as_tensor(h)[None], "gelu")
    _close(got[0], want, tol=1e-6)


def test_sinusoidal_positions_match_reference():
    """Positions 0..63 (the reduced models' sequences): the two libraries'
    ``sin`` of one float32 angle differ by up to an ulp of the angle, so
    far out (angles of hundreds of radians) they part by more than 1e-5."""
    pos = np.arange(64)[None]
    want = ref_layers.sinusoidal_positions(jnp.asarray(pos), 256)
    got = layers.sinusoidal_positions(torch.as_tensor(pos), 256)
    assert got.shape == (1, 64, 256)
    _close(got, want)


# -- losses -------------------------------------------------------------------


def test_loss_with_codebooks_or_patches_matches_reference(pair):
    """One model's loss on a batch with its extras (codebook tokens ``[B,
    S, CB]``; patches ``[B, P, vision_d]``), and the clients' form on two
    clients' copies, each client's loss equal to its one-model loss."""
    batch = pair.batch((2,), 40)
    want, wm = jax.jit(pair.ref.loss)(pair.ref_params,
                                      {k: jnp.asarray(v) for k, v in
                                       batch.items()})
    tb = _torch_batch(batch)
    with torch.no_grad():
        got, gm = pair.port.loss(pair.params, tb)
        logits, _ = pair.port.forward(pair.params, tb["tokens"], tb)
    _close(got, want)
    _close(gm["lm_loss"], wm["lm_loss"])
    assert "mtp_loss" not in gm
    want_logits, _, _ = jax.jit(pair.ref.forward)(
        pair.ref_params, jnp.asarray(batch["tokens"]),
        {k: jnp.asarray(v) for k, v in batch.items()})
    _close(logits, want_logits)
    cfg = pair.port.cfg
    P = cfg.vision_patches if cfg.vision_stub else 0
    tail = (cfg.n_codebooks, cfg.vocab) if cfg.n_codebooks else (cfg.vocab,)
    assert logits.shape == (2, P + 40, *tail)
    # the clients' form: client 1's params scaled, its batch the second half
    scaled = {k: torch.stack([v, v * 1.01]) for k, v in pair.params.items()}
    both = {k: torch.stack([v[:1], v[1:]]) for k, v in tb.items()}
    with torch.no_grad():
        per, _ = pair.port.loss(scaled, both)
        for c in range(2):
            one, _ = pair.port.loss({k: v[c] for k, v in scaled.items()},
                                    {k: v[c] for k, v in both.items()})
            _close(per[c], one)


# -- rounds -------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_rounds(pair):
    it = ref_lm_batches(pair.rc.vocab, (2, C, 2), S, seed=0,
                        codebooks=pair.rc.n_codebooks,
                        vision=_vision(pair.rc))
    batches = [next(it) for _ in range(ROUNDS)]
    fed = ref_api.fed_round(pair.ref, RefSubmodelConfig(**SCFG),
                            kernel_backend="jnp", fused_forward="off")
    trainer = ref_api.Trainer(fed, jax.tree_util.tree_map(
        jnp.asarray, pair.params0), rng=1)
    params, history = trainer.run(
        ({k: jnp.asarray(v) for k, v in b.items()} for b in batches),
        ROUNDS)
    offsets = [{k: [int(o) for o in np.asarray(v)] for k, v in
                fed.scheme.offsets(None, r, C).items()}
               for r in range(ROUNDS)]
    return dict(batches=batches, offsets=offsets, params=_np(params),
                client_loss=[np.asarray(h["client_loss"]) for h in history])


def _port_rounds(model, params, batches, offsets, ff):
    fed = api.fed_round(model, SubmodelConfig(**SCFG), fused_forward=ff,
                        device="cpu")
    assert fed.use_fused == (ff == "on")
    trainer = api.Trainer(fed, params)
    items = (zip(batches, ({"offsets": o} for o in offsets)) if offsets
             else iter(batches))
    trainer.run(items, len(batches))
    return trainer


@pytest.mark.parametrize("ff", ["on", "off"], ids=["fused", "extract"])
def test_rounds_match_reference_extract_arm(pair, ref_rounds, ff):
    trainer = _port_rounds(pair.port, convert.from_reference(
        pair.params0, "cpu"), ref_rounds["batches"], ref_rounds["offsets"],
        ff)
    assert {k[0] for k in trainer.fed.scheme.sizes} == {"d_ff", "heads",
                                                        "kv_heads"}
    for r, h in enumerate(trainer.history):
        _close(h["client_loss"].numpy(), ref_rounds["client_loss"][r])
    got = dict(jax.tree_util.tree_leaves_with_path(
        convert.to_reference(trainer.params)))
    for path, want in jax.tree_util.tree_leaves_with_path(
            ref_rounds["params"]):
        _close(got[path], want, f"{ff} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_equals_extract_to_the_bit(arch):
    cfg = get_reduced_config(arch)
    model = build_model(cfg)
    it = lm_batches(cfg.vocab, (2, C, 2), S, seed=0,
                    codebooks=cfg.n_codebooks, vision=_vision(cfg))
    batches = [next(it) for _ in range(2)]
    fused, extract = (_port_rounds(model, model.init(0, device="cpu"),
                                   batches, None, ff) for ff in ("on", "off"))
    bits = (lambda t: t.contiguous().view(torch.int32))
    for a, b in zip(fused.history, extract.history):
        assert torch.equal(bits(a["client_loss"]), bits(b["client_loss"]))
    for k in fused.params:
        assert torch.equal(bits(fused.params[k]), bits(extract.params[k])), k


# -- data ---------------------------------------------------------------------


@pytest.mark.parametrize("extras", [dict(codebooks=4),
                                    dict(vision=(16, 64)),
                                    dict(codebooks=2, vision=(3, 8))],
                         ids=["codebooks", "vision", "both"])
def test_lm_batches_match_reference_bit_for_bit(extras):
    want = ref_lm_batches(512, (2, 3, 2), 12, seed=5, **extras)
    got = lm_batches(512, (2, 3, 2), 12, seed=5, **extras)
    for _ in range(2):
        a, b = next(got), next(want)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


# -- serving ------------------------------------------------------------------


def test_generate_matches_reference_loop(pair):
    """``serve.generate`` on the reference's ``sample_prompts`` against
    the reference's loop (``launch/serve.py``): prefill with the extras,
    then greedy decode steps at positions ``P + S + i``."""
    B, S_, G = 2, 12, 4
    prompts, extra = ref_sample_prompts(pair.rc, B, S_, seed=0)
    P = pair.rc.vision_patches if pair.rc.vision_stub else 0
    jextra = ({k: jnp.asarray(v) for k, v in extra.items()} if extra
              else None)
    logits, cache = pair.ref.prefill(pair.ref_params, jnp.asarray(prompts),
                                     jextra, max_len=P + S_ + G)
    want_logits, want_toks = [logits], []
    tok = jnp.argmax(logits, -1)
    decode = jax.jit(pair.ref.decode_step)
    for i in range(G):
        want_toks.append(np.asarray(tok))
        logits, cache = decode(pair.ref_params, tok, cache, P + S_ + i)
        want_logits.append(logits)
        tok = jnp.argmax(logits, -1)
    textra = ({k: torch.as_tensor(v) for k, v in extra.items()} if extra
              else None)
    out = serve.generate(pair.port, pair.params, torch.as_tensor(
        prompts, dtype=torch.long), G, return_logits=True, extra=textra)
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  np.stack(want_toks, axis=1))
    for got, want in zip(out["logits"], want_logits):
        _close(got, want)
    cb = pair.rc.n_codebooks
    assert out["tokens"].shape == ((B, G, cb) if cb else (B, G))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_and_the_batcher_refusal(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert "prefill:" in out and "ms/token (3 steps, batch 2)" in out
    with pytest.raises(ValueError, match="plain token prompts"):
        request_queue(get_reduced_config(arch), (3, 5))


# -- the zoo, whole -----------------------------------------------------------


def test_list_archs_matches_reference():
    assert list_archs() == ref_list_archs()


@pytest.mark.parametrize("arch", ref_list_archs())
def test_every_architecture_trains_a_round_and_serves(arch):
    """The reference's end-to-end pin (``tests/test_system.py``): each
    reduced architecture through ``api.fed_round`` + ``api.Trainer`` (one
    round) and ``serve.generate`` (a prefill and two decode steps), with
    finite losses and logits."""
    cfg = get_reduced_config(arch)
    model = build_model(cfg, moe_path="dense")
    params = model.init(0, device="cpu")
    fed = api.fed_round(model, SubmodelConfig(**SCFG), device="cpu")
    trainer = api.Trainer(fed, params)
    it = lm_batches(cfg.vocab, (2, C, 1), 16, seed=0,
                    codebooks=cfg.n_codebooks, vision=_vision(cfg))
    trainer.run(it, 1)
    assert np.isfinite(trainer.losses[0])
    prompts, extra = sample_prompts(cfg, 2, 8, seed=0)
    out = serve.generate(model, trainer.params, torch.as_tensor(
        prompts, dtype=torch.long), 2, return_logits=True,
        extra={k: torch.as_tensor(v) for k, v in extra.items()}
        if extra else None)
    assert all(bool(torch.isfinite(t).all()) for t in out["logits"])
