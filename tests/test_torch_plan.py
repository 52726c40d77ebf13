"""The port's planning path against the JAX reference's: shapes, plans,
the roofline's model FLOPs and the dry-run on ``meta``.

Held exactly (no tolerance): ``ShapeConfig``, ``INPUT_SHAPES``,
``RunConfig``, ``TRAIN_CAPACITY``, ``K_LOCAL`` and ``submodel_config`` equal
the reference's field by field; ``batch_spec`` and ``serve_batch`` give the
reference's shapes and dtypes for every architecture and shape;
``active_params`` and ``model_flops`` equal the reference's for every
architecture at its full config (abstract params only, nothing built);
a world-2 plan holds half the clients and its collectives' bytes are the
ring model's for the leaves it gathers or sums.  Plans on ``meta`` of
reduced TinyLlama (a 64-token train shape, C = 4): the planned peak grows
linearly in ``n_layers`` (2, 4, 6: equal steps within 1% of a step), and a
bf16 plan's peak is below the f32 plan's.  ``resolve_device`` takes
``"meta"``, and ``"cuda"`` still raises without a card.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as ref_base  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402

ARCHS = base.list_archs()
SMALL = base.ShapeConfig("small", 64, 8, "train")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes at once, and torch's pool of a thread per core in
    each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_shapes_and_run_config_equal_the_reference():
    assert list(base.INPUT_SHAPES) == list(ref_base.INPUT_SHAPES)
    for name, shape in base.INPUT_SHAPES.items():
        assert _fields(shape) == _fields(ref_base.INPUT_SHAPES[name])
    got, want = base.RunConfig("a", "b"), ref_base.RunConfig("a", "b")
    assert {k: v for k, v in _fields(got).items() if k != "submodel"} == \
        {k: v for k, v in _fields(want).items() if k != "submodel"}
    assert _fields(got.submodel) == _fields(want.submodel)
    assert specs.TRAIN_CAPACITY == ref_specs.TRAIN_CAPACITY
    assert specs.K_LOCAL == ref_specs.K_LOCAL
    for mp in (False, True):
        assert specs.data_axes(mp) == ref_specs.data_axes(mp)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_submodel_config_equals_the_reference(multi_pod):
    for arch in ARCHS:
        assert _fields(specs.submodel_config(arch, multi_pod)) == \
            _fields(ref_specs.submodel_config(arch, multi_pod)), arch


def _ref_leaves(tree):
    return {k: (tuple(v.shape), str(v.dtype)) for k, v in tree.items()}


def _leaves(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_spec_and_serve_batch_equal_the_reference(arch):
    cfg, ref_cfg = base.get_config(arch), ref_base.get_config(arch)
    for mp in (False, True):
        scfg = specs.submodel_config(arch, mp)
        ref_scfg = ref_specs.submodel_config(arch, mp)
        for name, shape in base.INPUT_SHAPES.items():
            ref_shape = ref_base.INPUT_SHAPES[name]
            if shape.kind == "train":
                got = specs.batch_spec(cfg, shape, scfg, mp)
                want = ref_specs.batch_spec(ref_cfg, ref_shape, ref_scfg, mp)
            else:
                got = specs.serve_batch(cfg, shape)
                want = ref_specs.serve_batch(ref_cfg, ref_shape)
            assert all(v.device.type == "meta" for v in got.values())
            assert _leaves(got) == _ref_leaves(want), (arch, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_active_params_equal_the_reference(arch):
    from repro.analysis import roofline as ref_roofline
    from repro.models import build_model as ref_build
    from repro_torch.models import build_model
    cfg, ref_cfg = base.get_config(arch), ref_base.get_config(arch)
    abstract = build_model(cfg).abstract_params()
    ref_abstract = ref_build(ref_cfg).abstract_params()
    assert roofline.active_params(cfg, abstract) == \
        ref_roofline.active_params(ref_cfg, ref_abstract)
    for kind in ("train", "serve"):
        assert roofline.model_flops(cfg, abstract, 12345, kind) == \
            ref_roofline.model_flops(ref_cfg, ref_abstract, 12345, kind)


def _small_plan(n_layers=2, **kw):
    cfg = dataclasses.replace(base.get_reduced_config("tinyllama_1_1b"),
                              n_layers=n_layers)
    scfg = base.SubmodelConfig(scheme="rolling", capacity=0.5, local_steps=2,
                               clients_per_round=4, client_lr=0.05)
    return specs.make_plan("tinyllama_1_1b", SMALL, cfg=cfg, scfg=scfg,
                           **{"world": 1, **kw})


@pytest.fixture(scope="module")
def peaks():
    return {(L, dt): dryrun.count(_small_plan(L, param_dtype=dt)).peak_bytes
            for L in (2, 4, 6) for dt in (torch.float32, torch.bfloat16)}


def test_planned_peak_grows_linearly_in_layers(peaks):
    f32 = [peaks[(L, torch.float32)] for L in (2, 4, 6)]
    step = f32[1] - f32[0]
    assert step > 0
    assert abs((f32[2] - f32[1]) - step) <= 0.01 * step, f32


def test_bf16_plan_peak_is_below_f32(peaks):
    for L in (2, 4, 6):
        assert peaks[(L, torch.bfloat16)] < peaks[(L, torch.float32)]


@pytest.mark.parametrize("agg", ["gather", "psum"])
def test_world_2_plan_holds_half_the_clients_and_ring_bytes(agg):
    one = _small_plan()
    two = _small_plan(world=2, mesh_agg=agg)
    assert two.world == 2 and two.mesh is not None
    c1, c2 = dryrun.count(one), dryrun.count(two)
    # the windowed products launch once a client step for all its clients:
    # the same launches, on half the rows
    assert c2.kernels == c1.kernels
    K, C = two.scfg.local_steps, two.scfg.clients_per_round
    leaves = [math.prod(s) for s in two.model.abstract_params().values()]
    losses = C * K * 4 / 2                  # losses [K, C] f32, gathered
    if agg == "gather":       # each client's f32 change, [C/2] -> [C]
        want = {"all-gather": sum(C * n * 4 / 2 for n in leaves) + losses}
    else:                     # each rank's f32 sum, full-shaped, all-reduced
        want = {"all-gather": losses,
                "all-reduce": sum(2.0 * n * 4 * (2 - 1) / 2
                                  for n in leaves)}
    assert dict(c2.coll_by_kind) == want
    assert sum(c2.coll_counts.values()) == 1 + len(leaves)
    assert c1.coll_bytes == 0
    res = dryrun.run_one("tinyllama_1_1b", SMALL, world=2, verbose=False,
                         cfg=two.cfg, scfg=two.scfg, mesh_agg=agg)
    assert res["clients_per_rank"] == 2
    assert res["coll_bytes_per_dev"] == pytest.approx(sum(want.values()))
    assert res["t_collective_s"] == pytest.approx(
        sum(want.values()) / roofline.ICI_BW)


def test_resolve_device_takes_meta_and_cuda_still_raises():
    assert resolve_device("meta") == torch.device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
    with pytest.raises(ValueError, match="'cuda', 'cpu' or 'meta'"):
        resolve_device("mps")


def test_dry_run_records_the_reference_keys(tmp_path):
    res = dryrun.run_one("mamba2_130m", "decode_32k", verbose=False)
    for k in ("flops_per_dev", "bytes_per_dev", "coll_bytes_per_dev",
              "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
              "step_lb_s", "model_flops", "useful_ratio", "collectives",
              "collective_counts", "tokens", "argument_size_in_bytes",
              "temp_size_in_bytes", "per_device_hbm_gb", "fits", "notes"):
        assert k in res, k
    assert res["tokens"] == 128 and res["world"] == 16
    assert any("remat and fsdp" in n for n in res["notes"])
    assert np.isfinite(res["step_lb_s"]) and res["fits"]
