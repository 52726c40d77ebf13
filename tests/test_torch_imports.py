"""The port stands alone: no module of ``src/repro_torch``, not its
examples (``examples/*_torch.py``), not ``chip_smoke.py`` and not the
card's measurement scripts in ``tools/`` import ``jax``, the JAX package
``repro`` or ``ml_dtypes`` (JAX's bfloat16 dtype, which the card's
machine may lack: the port carries bf16 through int16 views), and
imports of ``repro_torch`` itself are fine.  A static AST scan, so it
holds for code paths no CPU test reaches.

This file imports no JAX, so it also holds the ``gpu`` test of the
paper-protocol round at ResNet18's full width, which the card's machine
runs with ``--noconftest``."""
import ast
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    sorted((ROOT / "examples").glob("*_torch.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "src/repro_torch/core/fedavg.py" in names
    assert "chip_smoke.py" in names and (ROOT / "chip_smoke.py").exists()
    assert {"examples/quickstart_torch.py",
            "examples/paper_experiment_torch.py"} <= names


@pytest.mark.gpu
def test_gpu_paper_round_at_full_width_launches_rows_9_and_11():
    """One paper-protocol round (rolling masks) on full-width pre-act
    ResNet18 on the card: 10 participants x K = 2 x 32 images; each of the
    56 leaves takes K masked SGD steps (TPU row 9) and one fill-in (row
    11)."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; none is present")
    from repro_torch import api
    from repro_torch.configs.resnet18_cifar import CONFIG
    from repro_torch.core.paper_protocol import PaperExperiment
    from repro_torch.kernels import _build

    exp = PaperExperiment(n_clients=100, participate=10, mb=32,
                          n_train=2000, n_test=100, rcfg=CONFIG)
    params, _ = exp.init_params()
    fed = exp.make_fed("rolling")
    trainer = api.Trainer(fed, params, rng=1)
    item = next(exp._round_batches("rolling", None))
    _build.reset_launches()
    trainer.run(iter([item]), 1)
    torch.cuda.synchronize()
    assert len(params) == 56
    assert _build.LAUNCHES.get("masked_sgd_inplace") == 2 * 56
    assert _build.LAUNCHES.get("fillin_agg_inplace") == 56
    assert np.isfinite(trainer.losses[0])
    assert all(bool(torch.isfinite(v).all()) for v in trainer.params.values())
