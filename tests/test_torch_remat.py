"""Rematerialisation (``Model.remat``) in the port.

``build_model(cfg)`` builds ``Model(remat=True)``, as the reference's: in
training with grad enabled each layer runs under non-reentrant
``torch.utils.checkpoint`` and is recomputed in the backward.  On the CPU:

* remat on equals remat off bit for bit inside the port, losses and
  params: reduced TinyLlama's fused window, extract and momentum mask
  rounds (2 rounds each), one round each of reduced Mixtral (``dense`` and
  ``dropping``), DeepSeek-V3 (MLA + MTP), Mamba2, Hymba, MusicGen and
  Phi-3-vision, and bf16 TinyLlama (2 rounds); fused == extract still
  holds at 0 ulp with remat on;
* the port with remat against the reference built with ``remat=True``
  (its default) on one reduced window round, from the same params, tokens
  and injected offsets: client losses within 2e-6 and params within 3e-7
  (absolute; ROADMAP C3, the frameworks' products sum in other orders);
* under ``torch.no_grad()`` remat changes nothing and enters no
  checkpoint;
* on ``meta``, at a train shape of a reduced config: the plan's peak with
  remat lies below the one without, the counted FLOPs rise by the
  layers' forward (a ratio within (1, 1.5); rows 5 and 7 launch twice, 6
  and 8 once), ``model_flops`` is the same; ``RunConfig.remat`` and
  ``make_plan(remat=)`` reach the model; the dry-run notes no longer say
  that remat has no effect;
* ``launch/train.py`` builds remat off with ``--reduced`` and on
  otherwise (on ``meta``, without a full-size run);
* the C11 pin: the port's round-profile and results-book CLIs leave the
  reference's ``experiments/bench_results.json`` byte for byte as it was
  and write the port's own artifact;
* ``examples/train_lm_e2e_torch.py`` (built with ``remat=False``, as its
  reference twin) trains, checkpoints and resumes on the CPU.

A ``gpu``-marked test runs the reduced window round with remat on and off
on the card: bit for bit, rows 5 and 7 launched twice.  JAX is imported
only inside the reference's fixture, so the card's machine collects this
file without it.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api, convert  # noqa: E402
from repro_torch.configs.base import (RunConfig, ShapeConfig,  # noqa: E402
                                      SubmodelConfig, get_reduced_config)
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

LOSS_ATOL, PARAM_ATOL = 2e-6, 3e-7      # port vs reference (ROADMAP C3)
S, C, K = 32, 4, 2
SCFG = dict(scheme="rolling", capacity=0.5, local_steps=K,
            clients_per_round=C, client_lr=0.1,
            axes=("d_ff", "heads", "kv_heads"))


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


@pytest.fixture
def checkpoints(monkeypatch):
    """Counts the layers run under ``torch.utils.checkpoint``."""
    seen = []

    def counted(fn, *args, **kw):
        seen.append(fn)
        return real(fn, *args, **kw)
    real = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint", counted)
    return seen


# -- remat on == remat off, inside the port -----------------------------------


#: (arch, rounds, build keywords, fed_round keywords, sub-model overrides)
CASES = {
    "tinyllama-fused": ("tinyllama_1_1b", 2, {}, {}, {}),
    "tinyllama-extract": ("tinyllama_1_1b", 2, {},
                          {"fused_forward": "off"}, {}),
    "tinyllama-momentum-mask": ("tinyllama_1_1b", 2, {},
                                {"client_opt": "momentum"},
                                {"scheme": "bernoulli"}),
    "mixtral-dense": ("mixtral_8x22b", 1, {"moe_path": "dense"}, {},
                      {"axes": SubmodelConfig().axes}),
    "mixtral-dropping": ("mixtral_8x22b", 1, {"moe_path": "dropping"}, {},
                         {"axes": SubmodelConfig().axes}),
    "deepseek-v3": ("deepseek_v3_671b", 1, {}, {},
                    {"axes": SubmodelConfig().axes}),
    "mamba2": ("mamba2_130m", 1, {}, {}, {"axes": SubmodelConfig().axes}),
    "hymba": ("hymba_1_5b", 1, {}, {}, {"axes": SubmodelConfig().axes}),
    "musicgen": ("musicgen_large", 1, {}, {}, {}),
    "phi-3-vision": ("phi_3_vision_4_2b", 1, {}, {}, {}),
    "tinyllama-bf16": ("tinyllama_1_1b", 2,
                       {"param_dtype": torch.bfloat16}, {}, {}),
}


def _rounds(arch, n, build_kw, fed_kw, over, remat):
    """``n`` rounds of reduced ``arch`` on the CPU from seed 0; the window
    rounds take the scheme's offsets injected.  Returns the trainer."""
    cfg = get_reduced_config(arch)
    model = build_model(cfg, remat=remat, **build_kw)
    fed = api.fed_round(model, SubmodelConfig(**{**SCFG, **over}),
                        device="cpu", **fed_kw)
    vision = (cfg.vision_patches, cfg.vision_d) if cfg.vision_stub else None
    it = lm_batches(cfg.vocab, (K, C, 2), S, seed=0,
                    codebooks=cfg.n_codebooks, vision=vision)
    window = hasattr(fed, "_client_offsets")
    items = [(next(it), {"offsets": fed.scheme.offsets(r, C)}) if window
             else next(it) for r in range(n)]
    trainer = api.Trainer(fed, model.init(0, device="cpu"), rng=0)
    trainer.run(iter(items), n)
    return trainer


def _bits_equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("case", list(CASES))
def test_remat_equals_no_remat_bit_for_bit(case, checkpoints):
    arch, n, build_kw, fed_kw, over = CASES[case]
    off = _rounds(arch, n, build_kw, fed_kw, over, remat=False)
    assert not checkpoints
    on = _rounds(arch, n, build_kw, fed_kw, over, remat=True)
    cfg = get_reduced_config(arch)
    # every layer of every client step went through a checkpoint
    assert len(checkpoints) >= cfg.n_layers * K * n
    for h_off, h_on in zip(off.history, on.history, strict=True):
        assert torch.equal(h_off["client_loss"], h_on["client_loss"])
    assert off.losses == on.losses
    assert _bits_equal(off.params, on.params)


def test_fused_equals_extract_with_remat(checkpoints):
    fused = _rounds("tinyllama_1_1b", 2, {}, {"fused_forward": "on"}, {},
                    remat=True)
    extract = _rounds("tinyllama_1_1b", 2, {}, {"fused_forward": "off"},
                      {}, remat=True)
    assert fused.fed.use_fused and not extract.fed.use_fused
    assert checkpoints
    assert fused.losses == extract.losses
    assert _bits_equal(fused.params, extract.params)


def test_no_grad_changes_nothing_and_enters_no_checkpoint(checkpoints):
    cfg = get_reduced_config("tinyllama_1_1b")
    params = build_model(cfg).init(0, device="cpu")
    batch = {"tokens": torch.as_tensor(
        next(lm_batches(cfg.vocab, (2,), 64, seed=3))["tokens"])}
    with torch.no_grad():
        on = build_model(cfg).loss(params, batch)[0]
        off = build_model(cfg, remat=False).loss(params, batch)[0]
        logits, _ = build_model(cfg).prefill(params, batch["tokens"])
        want, _ = build_model(cfg, remat=False).prefill(params,
                                                        batch["tokens"])
    assert torch.equal(on, off) and torch.equal(logits, want)
    assert not checkpoints
    # with grad the same model checkpoints each layer
    build_model(cfg).loss(params, batch)
    assert len(checkpoints) == cfg.n_layers


# -- against the reference's default (remat=True) ------------------------------


def test_remat_round_matches_the_reference_remat_round():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import api as ref_api
    from repro.configs.base import SubmodelConfig as RefSubmodelConfig
    from repro.configs.base import get_reduced_config as ref_reduced
    from repro.data.synthetic import lm_batches as ref_lm_batches
    from repro.models import build_model as ref_build
    ref_model = ref_build(ref_reduced("tinyllama_1_1b"))
    assert ref_model.remat
    params0 = jax.tree_util.tree_map(
        np.asarray, ref_model.init(jax.random.PRNGKey(0)))
    fed = ref_api.fed_round(ref_model, RefSubmodelConfig(**SCFG),
                            kernel_backend="jnp")
    batch = next(ref_lm_batches(ref_model.cfg.vocab, (K, C, 2), S, seed=0))
    offsets = {k: [int(o) for o in np.asarray(v)]
               for k, v in fed.scheme.offsets(None, 0, C).items()}
    trainer = ref_api.Trainer(fed, jax.tree_util.tree_map(jnp.asarray,
                                                          params0), rng=1)
    want, history = trainer.run(iter([{k: jnp.asarray(v)
                                       for k, v in batch.items()}]), 1)

    model = build_model(get_reduced_config("tinyllama_1_1b"))
    assert model.remat
    port = api.Trainer(api.fed_round(model, SubmodelConfig(**SCFG),
                                     device="cpu"),
                       convert.from_reference(params0, device="cpu"))
    port.run(iter([(batch, {"offsets": offsets})]), 1)
    np.testing.assert_allclose(port.history[0]["client_loss"].numpy(),
                               np.asarray(history[0]["client_loss"]),
                               atol=LOSS_ATOL, rtol=0)
    got = dict(jax.tree_util.tree_leaves_with_path(
        convert.to_reference(port.params)))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(got[path], np.asarray(w),
                                   atol=PARAM_ATOL, rtol=0,
                                   err_msg=str(path))


# -- the plans on meta ----------------------------------------------------------


TRAIN = ShapeConfig("train_small", 256, 2 * C, "train")


def _plan_record(remat):
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(get_reduced_config("tinyllama_1_1b"),
                              n_layers=4)
    return dryrun.run_one("tinyllama_1_1b", TRAIN, world=1, verbose=False,
                          cfg=cfg, scfg=SubmodelConfig(**SCFG), remat=remat)


@pytest.fixture(scope="module")
def plans():
    return {remat: _plan_record(remat) for remat in (False, True)}


def test_remat_plan_holds_less_and_counts_the_recompute(plans):
    off, on = plans[False], plans[True]
    assert (off["remat"], on["remat"]) == (False, True)
    assert on["peak_bytes"] < off["peak_bytes"]
    ratio = on["flops_per_dev"] / off["flops_per_dev"]
    assert 1 < ratio < 1.5, ratio
    assert on["model_flops"] == off["model_flops"]
    assert on["useful_ratio"] < off["useful_ratio"]
    for name in ("rolling_mm_fwd<1>", "rolling_mm_fwd<2>"):
        assert on["kernels"][name] == 2 * off["kernels"][name]
    for name in ("rolling_mm_dx<1>", "rolling_mm_dx<2>", "sgd_inplace"):
        assert on["kernels"][name] == off["kernels"][name]


def test_run_config_and_make_plan_reach_the_model():
    from repro_torch.launch import specs
    assert specs.make_plan("tinyllama_1_1b", "train_4k").model.remat
    assert not specs.make_plan("tinyllama_1_1b", "train_4k",
                               remat=False).model.remat
    for remat in (False, True):
        plan = specs.run_plan(RunConfig("tinyllama_1_1b", "train_4k",
                                        remat=remat))
        assert plan.model.remat is remat
        assert plan.param_dtype == torch.bfloat16 and plan.kind == "train"
    assert RunConfig("a", "b").remat


def test_dry_run_notes_no_longer_say_remat_has_no_effect(plans):
    from repro_torch.launch import dryrun
    for rec in plans.values():
        assert not any("remat" in n for n in rec["notes"])
    assert not any("remat" in n for n in dryrun.NOTES)
    assert any("fsdp" in n for n in dryrun.NOTES)


# -- the training CLI's choice ---------------------------------------------------


class _Built(Exception):
    pass


@pytest.mark.parametrize("reduced", [True, False])
def test_train_cli_builds_remat_off_reduced_and_on_at_full_size(
        reduced, monkeypatch):
    from repro_torch.launch import train
    built = []

    def build(cfg, **kw):
        built.append(build_model(cfg, **kw))
        raise _Built
    monkeypatch.setattr(train, "build_model", build)
    args = train.parser().parse_args(
        ["--arch", "tinyllama_1_1b", "--device", "cpu"]
        + (["--reduced"] if reduced else []))
    with pytest.raises(_Built):
        train._run(args, torch.device("meta"))
    (model,) = built
    assert model.remat is not reduced
    assert (model.cfg.n_layers == 2) is reduced


def test_serving_and_the_round_profile_build_remat_off(monkeypatch):
    from repro_torch.analysis import round_profile
    from repro_torch.launch import serve
    built = []

    def build(cfg, **kw):
        built.append(kw.get("remat", True))
        raise _Built
    import repro_torch.models as models
    for mod in (serve, models):
        monkeypatch.setattr(mod, "build_model", build)
    with pytest.raises(_Built):
        serve.main(["--arch", "tinyllama_1_1b", "--reduced", "--device",
                    "cpu"])
    with pytest.raises(_Built):
        round_profile.profile()
    assert built == [False, False]


# -- C11: the port's CLIs keep off the reference's artifact ---------------------


REFERENCE_ARTIFACT = {"paper_protocol": {"rounds": 3, "from": "reference"},
                      "round_profile": {"fused_round_flops": 1.0}}


def _run_experiment_cli():
    from repro_torch.launch import experiment
    experiment.main(["--rounds", "1", "--device", "cpu", "--schemes",
                     "shuffled", "--partitions", "iid"])
    return experiment.SECTION


def _run_round_profile_cli():
    from repro_torch.analysis import round_profile
    round_profile.main([])
    return "round_profile"


@pytest.mark.parametrize("cli", [_run_round_profile_cli,
                                 _run_experiment_cli],
                         ids=["round_profile", "experiment"])
def test_port_clis_leave_the_reference_artifact_unchanged(cli, tmp_path,
                                                          monkeypatch):
    monkeypatch.chdir(tmp_path)
    os.makedirs("experiments")
    ref = os.path.join("experiments", "bench_results.json")
    with open(ref, "w") as f:
        json.dump(REFERENCE_ARTIFACT, f, indent=1)
    before = open(ref, "rb").read()
    section = cli()
    assert open(ref, "rb").read() == before
    with open(os.path.join("experiments", "bench_results_torch.json")) as f:
        assert section in json.load(f)


# -- the end-to-end example ---------------------------------------------------------


def test_train_lm_e2e_example_trains_checkpoints_and_resumes(tmp_path):
    """``examples/train_lm_e2e_torch.py`` (``build_model(cfg,
    remat=False)``, as ``examples/train_lm_e2e.py``): rounds with eval,
    a checkpoint, and a second run resumed from it at the saved round."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src"),
           "OMP_NUM_THREADS": "1"}
    ckpt = str(tmp_path / "lm.npz")

    def run(*extra):
        return subprocess.run(
            [sys.executable, str(root / "examples" / "train_lm_e2e_torch.py"),
             "--device", "cpu", "--ckpt", ckpt, *extra],
            capture_output=True, text=True, env=env, timeout=300,
            check=True).stdout
    out = run("--rounds", "4")
    assert "round    0 loss" in out and "eval" in out
    assert f"checkpoint -> {ckpt}" in out and os.path.exists(ckpt)
    with open(ckpt + ".json") as f:
        assert json.load(f)["round"] == 4
    out = run("--rounds", "2", "--resume", ckpt)
    assert f"resumed from {ckpt} at round 4" in out
    assert "round    5 loss" in out          # the last round logs
    with open(ckpt + ".json") as f:
        assert json.load(f)["round"] == 6


# -- on the card ------------------------------------------------------------------


@pytest.mark.gpu
def test_gpu_remat_round_is_bit_equal_and_recomputes_rows_5_and_7():
    """The reduced window round with remat on and off on the card, 2
    rounds from the same params and offsets: bit for bit; under remat the
    forward products (rows 5 and 7) launch twice, the rest as without."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; none is present")
    from repro_torch.kernels import _build
    cfg = get_reduced_config("tinyllama_1_1b")
    it = lm_batches(cfg.vocab, (K, C, 2), 64, seed=0)
    batches = [next(it) for _ in range(2)]
    out = {}
    for remat in (False, True):
        model = build_model(cfg, remat=remat)
        fed = api.fed_round(model, SubmodelConfig(**SCFG))
        trainer = api.Trainer(fed, model.init(0))
        _build.reset_launches()
        trainer.run(iter([(b, {"offsets": fed.scheme.offsets(r, C)})
                          for r, b in enumerate(batches)]), 2)
        torch.cuda.synchronize()
        out[remat] = (trainer.losses, trainer.params, dict(_build.LAUNCHES))
    (l_off, p_off, n_off), (l_on, p_on, n_on) = out[False], out[True]
    assert l_off == l_on and _bits_equal(p_off, p_on)
    for name in ("rolling_mm_fwd<1>", "rolling_mm_fwd<2>"):
        assert n_off[name] > 0 and n_on[name] == 2 * n_off[name]
    for name in ("rolling_mm_dx<1>", "rolling_mm_dx<2>", "sgd_inplace"):
        assert n_on[name] == n_off[name] > 0
