"""The port's facade against the reference's (``repro.api``).

The two facades export the same names, and ``fed_round``, ``Trainer`` and
``AsyncTrainer`` take the same keywords, minus the deliberate differences
of ROADMAP.md §C: the port has no ``kernel_backend=`` and no ``jit=`` (the
device decides the arm; it runs eagerly), and its entry points take
``device=``.  ``output_model`` and ``run_rounds`` run through the facade,
and ``fed_round`` takes the reference's ``mesh_agg`` values (``gather``,
``psum``) and refuses any other with its ``ValueError`` (the mesh round
itself: ``tests/test_torch_mesh.py``).
"""
import inspect

import pytest

torch = pytest.importorskip("torch")

from repro import api as ref_api  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.configs.base import (SubmodelConfig,  # noqa: E402
                                      get_reduced_config)
from repro_torch.core import fedavg  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

#: keywords only one facade has, on purpose (ROADMAP.md §C)
REF_ONLY = {"kernel_backend", "jit"}
PORT_ONLY = {"device"}
C, S = 2, 16
SCFG = dict(scheme="rolling", capacity=0.5, local_steps=1,
            clients_per_round=C, client_lr=0.1, axes=("d_ff",))


def test_the_facades_export_the_same_names():
    assert sorted(api.__all__) == sorted(ref_api.__all__)
    assert all(hasattr(api, name) for name in api.__all__)


@pytest.mark.parametrize("name", ["fed_round", "Trainer", "AsyncTrainer",
                                  "checkpoint_callback", "resolve_mode"])
def test_the_entry_points_take_the_same_keywords(name):
    want = set(inspect.signature(getattr(ref_api, name)).parameters)
    got = set(inspect.signature(getattr(api, name)).parameters)
    assert got - PORT_ONLY == want - REF_ONLY


def test_fed_round_defaults_agree_on_the_shared_keywords():
    want = inspect.signature(ref_api.fed_round).parameters
    got = inspect.signature(api.fed_round).parameters
    for k in set(want) - REF_ONLY:
        assert got[k].default == want[k].default, k


@pytest.fixture(scope="module")
def tiny():
    model = build_model(get_reduced_config("tinyllama_1_1b"))
    batch = {"tokens": torch.randint(0, 512, (1, C, 1, S),
                                     generator=torch.Generator().manual_seed(0))}
    return model, batch


def test_mesh_agg_default_builds_the_round_and_others_are_refused(tiny):
    """``gather`` and ``psum`` build the round (without a mesh they cross
    nothing: the plain round); an unknown aggregation is the reference's
    ``ValueError``."""
    model, batch = tiny
    for agg in ("gather", "psum"):
        fed = api.fed_round(model, SubmodelConfig(**SCFG), mesh_agg=agg,
                            device="cpu")
        assert fed.mesh_agg == agg and fed.mesh is None
        params = model.init(0, device="cpu")
        _, metrics = fed.round(params, batch, 0)
        assert torch.isfinite(metrics["client_loss"]).all()
    with pytest.raises(ValueError, match="unknown mesh_agg 'scatter'"):
        api.fed_round(model, SubmodelConfig(**SCFG), mesh_agg="scatter",
                      device="cpu")


def test_output_model_and_run_rounds_run_through_the_facade(tiny):
    model, batch = tiny
    assert api.output_model is fedavg.output_model
    assert api.run_rounds is fedavg.run_rounds
    fed = api.fed_round(model, SubmodelConfig(**SCFG), device="cpu")
    params = model.init(0, device="cpu")
    out = api.output_model(fed, params, batch, offsets={("d_ff", 512): [0, 0]})
    assert out.keys() == params.keys()
    assert all(torch.isfinite(v).all() for v in out.values())
    params, history = api.run_rounds(fed, params, iter([batch, batch]), 2)
    assert len(history) == 2
    assert all(torch.isfinite(h["client_loss"]).all() for h in history)
