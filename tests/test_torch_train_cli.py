"""The port's training CLI, ``python -m repro_torch.launch.train``.

Reduced TinyLlama (2 layers) on the CPU (``--reduced --device cpu``), 2
rounds of C = 4 clients x K = 2 steps x 2 x 32 tokens: the final JSON
(``first_loss``, ``last_loss``, finite) for the flag combinations this
slice ports (per-client windows, client and server optimizers, the bf16
uplink, both client phases, mask mode), the ``round N loss`` log lines,
the checkpoint, one run equal to the same configuration driven through
``api`` directly, the async fleet's flags (``--async-buffer`` with the
fleet, dropout and server-lr-schedule flags; the async record carries the
reference CLI's keys), the mesh flags (``--mesh 2 --devices 2``: two
local gloo ranks print the unmeshed run's losses bit for bit, once) and
their refusals.  The ``gpu`` twins run the CLI, and the mesh round on a
world of one NCCL rank, on the card and skip without one.  No JAX here:
the card's machine runs the twins with ``--noconftest``.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.checkpoint.checkpoint import load  # noqa: E402
from repro_torch.configs.base import (SubmodelConfig,  # noqa: E402
                                      get_reduced_config)
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BASE = ["--arch", "tinyllama_1_1b", "--reduced", "--rounds", "2",
        "--seq", "32", "--log-every", "1", "--lr", "0.1"]
FLAGS = {
    "stagger_momentum_adam_bf16": ["--stagger", "--client-opt", "momentum",
                                   "--server-opt", "adam",
                                   "--uplink-compression", "bf16"],
    "random_proximal": ["--scheme", "random", "--client-opt", "proximal"],
    "importance_stagger_extract": ["--scheme", "importance", "--stagger",
                                   "--fused-forward", "off"],
    "no_shared_window_server_momentum": ["--no-shared-window",
                                         "--server-opt", "momentum"],
    "mask_momentum_adam": ["--scheme", "bernoulli", "--client-opt",
                           "momentum", "--server-opt", "adam"],
    "axes_d_ff_sgd": ["--axes", "d_ff", "--server-opt", "sgd"],
}


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


def _check(out, text):
    assert set(out) == {"first_loss", "last_loss"}
    assert all(math.isfinite(v) for v in out.values())
    assert json.loads(text.strip().splitlines()[-1]) == out
    assert "round    0 loss" in text and "round    1 loss" in text
    assert "s/round)" in text


@pytest.mark.parametrize("name", list(FLAGS))
def test_cli_flag_combinations_print_finite_losses(name, capsys):
    out = train.main(BASE + FLAGS[name] + ["--device", "cpu"])
    _check(out, capsys.readouterr().out)


def test_cli_runs_as_a_module_and_checkpoints(tmp_path):
    ckpt = tmp_path / "ck.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    text = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *BASE,
         *FLAGS["stagger_momentum_adam_bf16"], "--device", "cpu",
         "--ckpt", str(ckpt)], capture_output=True, text=True, env=env,
        timeout=300, check=True).stdout
    out = json.loads(text.strip().splitlines()[-1])
    _check(out, text)
    params, meta = load(str(ckpt), device="cpu")
    assert meta["rounds"] == 2 and meta["history"][0] == out["first_loss"]
    assert all(torch.isfinite(v).all() for v in params.values())


def test_cli_equals_the_same_round_through_api(capsys):
    """The CLI's losses are those of ``api.fed_round`` + ``api.Trainer`` on
    the same configuration, params (seed 0) and batches."""
    out = train.main(BASE + FLAGS["random_proximal"] + ["--device", "cpu"])
    capsys.readouterr()
    cfg = get_reduced_config("tinyllama_1_1b")
    model = build_model(cfg)
    fed = api.fed_round(model, SubmodelConfig(
        scheme="random", capacity=0.5, local_steps=2, clients_per_round=4,
        client_lr=0.1, seed=0), client_opt="proximal", device="cpu")
    trainer = api.Trainer(fed, model.init(0, device="cpu"), rng=1)
    trainer.run(lm_batches(cfg.vocab, (2, 4, 2), 32, seed=0), 2)
    assert trainer.losses == [out["first_loss"], out["last_loss"]]


def _losses(text):
    """The round lines' losses (their timings cut) and the final record."""
    lines = text.strip().splitlines()
    return [ln.split(" (")[0] for ln in lines if ln.startswith("round")], \
        json.loads(lines[-1])


def test_cli_mesh_run_prints_the_unmeshed_losses(capfd):
    """``--mesh 2 --devices 2``: two local gloo ranks, a client block each,
    the gather aggregation; rank 0 alone prints, the round lines and the
    record of the run without a mesh, bit for bit."""
    want = train.main(BASE + ["--device", "cpu"])
    want_text = capfd.readouterr().out
    got = train.main(BASE + ["--mesh", "2", "--devices", "2", "--device",
                             "cpu"])
    text = capfd.readouterr().out
    _check(got, text)
    assert got == want and _losses(text) == _losses(want_text)
    assert len(_losses(text)[0]) == 2 and text.count("first_loss") == 1


@pytest.mark.parametrize("flags,says", [
    (["--mesh", "2", "--async-buffer", "2"], "--async-buffer owns"),
    (["--mesh", "2", "--devices", "2", "--device", "cuda"], "torchrun"),
    (["--devices", "2", "--device", "cpu"], "add --mesh")],
    ids=["async_with_mesh", "devices_on_cards", "devices_without_mesh"])
def test_cli_refuses_mesh_misuse(flags, says):
    with pytest.raises(SystemExit, match=says):
        train.main(BASE + flags)


# the keys of the reference CLI's final record with --async-buffer
# (repro/launch/train.py: first/last loss, then the async extras)
ASYNC_KEYS = {"first_loss", "last_loss", "virtual_time", "rounds_per_vsec",
              "mean_staleness"}


@pytest.mark.parametrize("flags", [
    ["--async-buffer", "2"], ["--async-buffer", "2", "--fleet", "8"],
    ["--async-buffer", "2", "--dropout", "0.1"],
    ["--async-buffer", "2", "--server-lr-schedule", "inv_sqrt"]],
    ids=["async", "fleet", "dropout", "lr_schedule"])
def test_cli_async_flags_run(flags, capsys):
    """The async FedBuff server through the CLI: finite losses, the round
    lines with the async extras, and the reference CLI's async record."""
    out = train.main(BASE + flags + ["--device", "cpu"])
    text = capsys.readouterr().out
    assert set(out) == ASYNC_KEYS
    assert json.loads(text.strip().splitlines()[-1]) == out
    assert math.isfinite(out["first_loss"]) and \
        math.isfinite(out["last_loss"])
    assert out["virtual_time"] > 0 and out["mean_staleness"] >= 0
    assert out["rounds_per_vsec"] == round(2 / out["virtual_time"], 4)
    assert "round    1 loss" in text and "virtual_time" in text


def test_cli_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="uplink_compression"):
        train.main(BASE + ["--scheme", "bernoulli", "--uplink-compression",
                           "bf16", "--device", "cpu"])
    with pytest.raises(SystemExit):
        train.main(BASE + ["--client-opt", "adamw", "--device", "cpu"])


def test_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(BASE)


@pytest.mark.gpu
def test_gpu_mesh_round_on_one_nccl_rank_is_bit_equal():
    """The mesh round's gather arm on a world of one NCCL rank (reduced
    TinyLlama, 2 rounds from the same params, batches and offsets) equals
    the round without a mesh bit for bit, launching rows 5-8 and 10."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; none is present")
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import host_mesh, init_world
    model = build_model(get_reduced_config("tinyllama_1_1b"))
    scfg = SubmodelConfig(scheme="rolling", capacity=0.5, local_steps=2,
                          clients_per_round=4, client_lr=0.1, stagger=True)
    batches = list(zip(lm_batches(512, (2, 4, 2), 32, seed=0), range(2)))
    end = init_world("cuda")
    try:
        runs = []
        for mesh in (None, host_mesh("1")):
            fed = api.fed_round(model, scfg, mesh=mesh)
            trainer = api.Trainer(fed, model.init(0))
            _build.reset_launches()
            trainer.run((b for b, _ in batches), 2)
            torch.cuda.synchronize()
            runs.append((trainer.params, [h["client_loss"] for h in
                                          trainer.history],
                         dict(_build.LAUNCHES)))
    finally:
        if end is not None:
            end()
    (p0, l0, n0), (p1, l1, n1) = runs
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    for name in ("rolling_mm_fwd<1>", "rolling_mm_fwd<2>",
                 "rolling_mm_dx<1>", "rolling_mm_dx<2>", "sgd_inplace"):
        assert n1.get(name, 0) == n0.get(name, 0) > 0, name


@pytest.mark.gpu
def test_gpu_cli_trains_on_the_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; none is present")
    from repro_torch.kernels import _build
    _build.reset_launches()
    out = train.main(BASE + FLAGS["stagger_momentum_adam_bf16"])
    _check(out, capsys.readouterr().out)
    for name in ("rolling_mm_fwd<1>", "rolling_mm_fwd<2>",
                 "rolling_mm_dx<1>", "rolling_mm_dx<2>", "sgd_inplace"):
        assert _build.LAUNCHES.get(name, 0) > 0, name
    assert np.isfinite(out["last_loss"])


@pytest.mark.gpu
@pytest.mark.parametrize("arch,rows", [
    ("mamba2_130m", ("rolling_mm_fwd<1>", "rolling_mm_dx<1>")),
    ("hymba_1_5b", ("rolling_mm_fwd<1>", "rolling_mm_dx<1>",
                    "rolling_mm_fwd<2>", "rolling_mm_dx<2>"))])
def test_gpu_cli_trains_the_ssm_and_hybrid_families(capsys, arch, rows):
    """The SSM family and the hybrid block train on the card through the
    differentiable chunked SSD: the windowed products of their default
    axes and the client step launch, and the SSD chunk kernel does not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; none is present")
    from repro_torch.kernels import _build
    _build.reset_launches()
    out = train.main(["--arch", arch, "--reduced", "--rounds", "2", "--seq",
                      "64", "--log-every", "1", "--lr", "0.1"])
    _check(out, capsys.readouterr().out)
    for name in (*rows, "sgd_inplace"):
        assert _build.LAUNCHES.get(name, 0) > 0, name
    assert not _build.LAUNCHES.get("ssd_chunk_intra")
