"""The port's mesh round, sharding rules, meshes and context-parallel
decode against the JAX reference.

The mesh round splits a round's clients over ``torch.distributed`` ranks.
Worlds of 2 and 4 are local gloo ranks (``launch.mesh.spawn``, one group
each, started together; each rank one intra-op thread), a world of 1 runs
in this process.  Every rank runs ``tests/torch_mesh_workers.py``'s cases
(``tests/test_mesh.py``'s: its tiny TinyLlama with rolling and staggered
windows through the fused and the extract client phase, server Adam with
its state, and its least-squares triple with rolling, staggered and
``full`` windows) from the reference's params and batches, its window
offsets injected (torch cannot reproduce ``jax.random``).  Held:

* inside the port, the gather arm equals the single-process (``mesh=None``)
  round bit for bit: params after each of 2 rounds, client losses, Adam's
  state; the psum arm's losses equal it exactly and its params come within
  1e-5 (the reference's own psum bound, ``tests/test_mesh.py``) after a
  round; fused gather equals extract gather bit for bit; every rank ends
  with the same params; on a 2 x 2 mesh the ranks along ``model`` train
  the same clients;
* against the reference's single-device rounds (its one-device mesh rounds
  raise on jax 0.9 and its multi-device ones need forced host devices;
  ``tests/test_mesh.py`` pins them bit-equal to these), f32 atol and rtol
  1e-5 on params and client losses, as ``tests/test_torch_round.py``;
  Adam's step amplifies the frameworks' differences near 0 (see
  ``tests/test_torch_server_opt.py``), so its first round is held there,
  its params per coordinate at that file's bound;
* context-parallel attention within 1e-5 of the reference's
  ``decode_attention``, as ``tests/test_dryrun_small.py`` holds its own;
  8 teacher-forced context-parallel decode steps of reduced TinyLlama and
  reduced DeepSeek-V3 (MLA) within 1e-5 of the port's plain decode;
* the rule tables and specs equal the reference's ``PartitionSpec``
  entries on meshes of (4, 2), (16, 16) and (2, 16, 16) (stand-in meshes
  with ``shape`` and ``axis_names``); ``parse_mesh`` and the refusals with
  the reference's messages; ``host_mesh`` raises on too small a world.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_workers as W  # noqa: E402
from repro import api as ref_api  # noqa: E402
from repro.configs.base import SubmodelConfig as RefSubmodelConfig  # noqa
from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.configs.base import get_reduced_config as ref_reduced  # noqa: E402
from repro.data.synthetic import lm_batches as ref_lm_batches  # noqa: E402
from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models.attention import decode_attention as ref_decode  # noqa
from repro.sharding import ctx as ref_ctx  # noqa: E402
from repro.sharding import policy as ref_policy  # noqa: E402
from repro.sharding import spmd as ref_spmd  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch.configs.base import SubmodelConfig, get_config  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch.specs import cache_shard  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.sharding import ctx, policy, spmd  # noqa: E402

ATOL = RTOL = 1e-5
PSUM_TOL = 1e-5
ADAM_LR, ADAM_EPS = 0.1, 1e-6
WORLDS = (1, 2, 4)
SPAWN_S = 600             # a spawned world's ranks are killed past this
GATHER = list(W.CASES)
PSUM = [n for n in W.CASES if n != "lm_stagger_extract"]
#: the reference's run of each case (the extract case is held against the
#: fused one's: the reference's own fused == extract pin)
REF_OF = {n: ("lm_stagger_fused" if n == "lm_stagger_extract" else n)
          for n in W.CASES}


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


def _ref_model(kind):
    if kind == "lm":
        cfg = dataclasses.replace(
            ref_reduced("tinyllama_1_1b"), n_layers=2, vocab=64, d_model=64,
            d_ff=128, n_heads=4, n_kv_heads=2, head_dim=16)
        return ref_build(cfg, remat=False)

    def loss(w, batch):
        r = w["w"] - batch["target"].mean(-1)
        return 0.5 * jnp.mean(r * r), {}
    return (loss, {"w": jax.ShapeDtypeStruct((8,), jnp.float32)},
            {"w": ("d_ff",)})


def _ref_fed(name, **kw):
    kind, scfg, fkw = W.CASES[name]
    return ref_api.fed_round(_ref_model(kind), RefSubmodelConfig(**scfg),
                             kernel_backend="jnp", **fkw, **kw)


@pytest.fixture(scope="module")
def inputs():
    """The reference's params and batches (numpy) and each case's window
    offsets per round, as the workers take them."""
    lm = _ref_model("lm")
    it = ref_lm_batches(64, (2, 4, 2), 16, seed=0)
    lsq_batch = {"target": np.arange(2 * 4 * 3, dtype=np.float32)
                 .reshape(2, 4, 3)}
    offsets, drawn = {}, {}
    for name, (kind, scfg, _) in W.CASES.items():
        key = (kind, scfg["scheme"], scfg.get("stagger", False))
        if key not in drawn:
            fed = _ref_fed(name)
            drawn[key] = [{k: [int(o) for o in np.asarray(v)] for k, v in
                           fed.scheme.offsets(None, r, 4).items()}
                          for r in range(W.ROUNDS)]
        offsets[name] = drawn[key]
    return dict(
        lm=dict(params=_np(jax.jit(lm.init)(jax.random.PRNGKey(0))),
                batches=[next(it) for _ in range(W.ROUNDS)]),
        lsq=dict(params={"w": np.linspace(0.0, 1.0, 8, dtype=np.float32)},
                 batches=[lsq_batch] * W.ROUNDS),
        offsets=offsets)


@pytest.fixture(scope="module")
def spawned(inputs, attn):
    """Worlds of 2 and 4 local ranks, started together as soon as the
    inputs exist (the reference's rounds are computed here meanwhile):
    their pending results."""
    with ThreadPoolExecutor(2) as pool:
        yield {n: pool.submit(mesh_lib.spawn, W.run_world, n, inputs, attn,
                              threads=1, timeout=SPAWN_S) for n in (2, 4)}


@pytest.fixture(scope="module")
def reference(inputs, spawned):
    """The reference's single-device rounds of each case: params after
    each round and client losses."""
    out = {}
    for name in set(REF_OF.values()):
        kind = W.CASES[name][0]
        fed = _ref_fed(name)
        params = jax.tree_util.tree_map(jnp.asarray, inputs[kind]["params"])
        after, losses = [], []
        if fed.server_opt is None:
            step = jax.jit(fed.round)
        else:
            state = fed.server_opt.init(params)
            adam = jax.jit(fed.round_with_server_opt)
        for r in range(W.ROUNDS):
            batch = {k: jnp.asarray(v)
                     for k, v in inputs[kind]["batches"][r].items()}
            if fed.server_opt is None:
                params, m = step(params, batch, r, jax.random.PRNGKey(1))
            else:
                params, state, m = adam(params, state, batch, r,
                                        rng=jax.random.PRNGKey(1))
            after.append(_np(params))
            losses.append(np.asarray(m["client_loss"]))
        out[name] = dict(params=after, losses=losses)
    return out


@pytest.fixture(scope="module")
def single(inputs):
    """The port's single-process (``mesh=None``) rounds of each case."""
    return {name: W.run_case(name, inputs) for name in W.CASES}


@pytest.fixture(scope="module")
def attn():
    """Decode attention inputs: q [2, 4, 8], k, v [2, 32, 2, 8], the first
    21 positions valid."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    return dict(q=rng.standard_normal((2, 4, 8)).astype(f32),
                k=rng.standard_normal((2, 32, 2, 8)).astype(f32),
                v=rng.standard_normal((2, 32, 2, 8)).astype(f32),
                valid=np.broadcast_to(np.arange(32) <= 20, (2, 32)).copy())


@pytest.fixture(scope="module")
def world1(inputs, attn):
    """A gloo world of one in this process, ended after the module: its
    results, and its mesh for the refusal tests."""
    end = mesh_lib.init_world("cpu")
    try:
        yield W.run_world(inputs, attn), mesh_lib.host_mesh("1")
    finally:
        end()


@pytest.fixture(scope="module")
def worlds(spawned, world1):
    """Every world's results: 1 in this process, 2 and 4 spawned local
    ranks."""
    out = {n: f.result() for n, f in spawned.items()}
    out[1] = world1[0]
    return out


def _tree(params):
    """The port's flat params in the reference's layout (numpy)."""
    return convert.to_reference(params)


def _assert_bits(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _assert_near_reference(params, losses, ref, r, params_tol=None):
    """The port's params and client losses after round ``r`` against the
    reference's, within ``ATOL``/``RTOL`` (params: ``params_tol`` where
    given)."""
    np.testing.assert_allclose(losses.numpy(), ref["losses"][r],
                               atol=ATOL, rtol=RTOL)
    got = dict(jax.tree_util.tree_leaves_with_path(_tree(params)))
    want = dict(jax.tree_util.tree_leaves_with_path(ref["params"][r]))
    assert got.keys() == want.keys()
    bound = (dict(jax.tree_util.tree_leaves_with_path(params_tol))
             if params_tol is not None else None)
    for k in want:
        if bound is None:
            np.testing.assert_allclose(got[k], want[k], atol=ATOL,
                                       rtol=RTOL, err_msg=str(k))
        else:
            assert np.all(np.abs(got[k] - want[k]) <= bound[k]), k


def _adam_bound(state, dd=ATOL):
    """Server Adam's first round's param bound, per coordinate (in the
    reference's layout): ``ATOL + 2 lr dd / (sqrt(v_hat) + eps)``, ``v_hat``
    its bias-corrected second moment and ``dd`` the mean delta's
    cross-framework difference (``tests/test_torch_server_opt.py``)."""
    assert state["t"] == 1
    return _tree({k: ATOL + 2 * ADAM_LR * dd / (
        torch.sqrt(v / (1 - 0.99)) + ADAM_EPS) for k, v in
        state["v"].items()})


def _ref_rounds(got):
    """The rounds held against the reference: every round, or with server
    Adam the first (its later rounds' params differ by its step bound,
    and the losses computed from them more than 1e-5), at its bound."""
    if got["states"][0] is None:
        return [(r, None) for r in range(len(got["losses"]))]
    return [(0, _adam_bound(got["states"][0]))]


# -- the port's single-process rounds against the reference -------------------


@pytest.mark.parametrize("name", GATHER)
def test_single_process_round_matches_reference(name, single, reference):
    got, ref = single[name], reference[REF_OF[name]]
    for r, tol in _ref_rounds(got):
        _assert_near_reference(got["params"][r], got["losses"][r], ref, r,
                               params_tol=tol)


# -- the gather arm: the single-process round bit for bit ---------------------


@pytest.mark.parametrize("name", GATHER)
@pytest.mark.parametrize("world", WORLDS)
def test_gather_round_is_the_single_process_round(world, name, worlds,
                                                  single, reference):
    got, want = worlds[world]["rounds"][name, "gather"], single[name]
    for r in range(W.ROUNDS):
        _assert_bits(got["params"][r], want["params"][r])
        assert torch.equal(got["losses"][r], want["losses"][r])
        if want["states"][r] is not None:
            assert got["states"][r]["t"] == want["states"][r]["t"] == r + 1
            for part in ("m", "v"):
                _assert_bits(got["states"][r][part], want["states"][r][part])
    # and so as near the reference's rounds as the single-process round
    for r, tol in _ref_rounds(got):
        _assert_near_reference(got["params"][r], got["losses"][r],
                               reference[REF_OF[name]], r, params_tol=tol)


# -- the psum arm: exact losses, params to roundoff ---------------------------


@pytest.mark.parametrize("name", PSUM)
@pytest.mark.parametrize("world", WORLDS)
def test_psum_round_has_exact_losses_and_close_params(world, name, worlds,
                                                      single, reference):
    got, want = worlds[world]["rounds"][name, "psum"], single[name]
    assert torch.equal(got["losses"][0], want["losses"][0])
    for k, w in want["params"][0].items():
        assert (got["params"][0][k] - w).abs().max().item() < PSUM_TOL, k
    (_, tol), = _ref_rounds(got)
    if tol is not None:
        tol = jax.tree_util.tree_map(lambda b: b + PSUM_TOL, tol)
    _assert_near_reference(got["params"][0], got["losses"][0],
                           reference[REF_OF[name]], 0, params_tol=tol)


@pytest.mark.parametrize("world", WORLDS)
def test_fused_gather_equals_extract_gather(world, worlds):
    rounds = worlds[world]["rounds"]
    fused = rounds["lm_stagger_fused", "gather"]
    extract = rounds["lm_stagger_extract", "gather"]
    for r in range(W.ROUNDS):
        _assert_bits(fused["params"][r], extract["params"][r])
        assert torch.equal(fused["losses"][r], extract["losses"][r])


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_ends_the_round_with_the_same_params(world, worlds):
    same = worlds[world]["same"]
    assert len(same) == len(GATHER) + len(PSUM) and all(same.values())


def test_ranks_along_model_train_the_same_clients(worlds, single):
    """A 2 x 2 mesh: the clients split over ``data``, the two ranks of
    each ``model`` row computing the same block."""
    got, want = worlds[4]["model_axis"], single["lm_stagger_fused"]
    for r in range(W.ROUNDS):
        _assert_bits(got["params"][r], want["params"][r])
        assert torch.equal(got["losses"][r], want["losses"][r])


# -- context-parallel decode ---------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_cp_decode_attention_matches_reference(world, worlds, attn):
    want = ref_decode(*(jnp.asarray(attn[k]) for k in
                        ("q", "k", "v", "valid")))
    np.testing.assert_allclose(worlds[world]["cp_attention"].numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", W.DECODE_ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_cp_decode_matches_plain_decode(world, arch, worlds):
    want = W.decode(arch)
    got = worlds[world]["decode"][arch]
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-5


class _StandIn:
    """A mesh's shape and axis names (and a rank's coordinates), as the
    pure functions read them."""

    def __init__(self, shape, names, coords=None):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))
        self.coords = dict(coords or {})

    def get_local_rank(self, name):
        return self.coords.get(name, 0)


def test_cache_shard_cuts_the_attention_caches_positions():
    caches = {"layers/0/k": torch.arange(2 * 8 * 3).reshape(2, 8, 3),
              "layers/0/c": torch.arange(2 * 8).reshape(2, 8),
              "layers/0/h": torch.arange(2 * 8).reshape(2, 8)}
    mesh = _StandIn((4, 1), ("data", "model"), {"data": 2})
    got = cache_shard(caches, mesh)
    assert torch.equal(got["layers/0/k"], caches["layers/0/k"][:, 4:6])
    assert torch.equal(got["layers/0/c"], caches["layers/0/c"][:, 4:6])
    assert got["layers/0/h"] is caches["layers/0/h"]
    with pytest.raises(ValueError, match="not a multiple"):
        cache_shard({"layers/0/v": torch.zeros(1, 6, 1)}, mesh)


# -- rule tables and specs against the reference's PartitionSpecs --------------


MESHES = {"4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _port_path_to_ref(path):
    """A port leaf's reference path and whether the reference stacks it
    (a leading layer dim)."""
    parts = path.split("/")
    j = convert._stack_at(parts)
    if j is None:
        return path, False
    return "/".join(parts[:j + 1] + parts[j + 2:]), True


def _ref_specs(arch, rules, mesh):
    model = ref_build(ref_config(arch))
    specs = ref_policy.param_specs(model.abstract_params(), model.axes(),
                                   rules, mesh)
    flat = jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(p.key) for p in path): tuple(s) for path, s in flat}


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "mixtral_8x22b",
                                  "mamba2_130m"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_specs_match_reference(mesh, arch):
    shape, names = MESHES[mesh]
    stand = _StandIn(shape, names)
    model = build_model(get_config(arch))
    abstract, axes = model.abstract_params(), model.axes()
    for fsdp in (True, False):
        multi = "pod" in names
        rules = policy.default_param_rules(multi, fsdp)
        assert rules == ref_policy.default_param_rules(multi, fsdp)
        want = _ref_specs(arch, rules, stand)
        got = policy.param_specs(abstract, axes, rules, stand)
        assert got.keys() == abstract.keys()
        for path, spec in got.items():
            ref_path, stacked = _port_path_to_ref(path)
            assert spec == want[ref_path][1 if stacked else 0:], path
            assert spec == policy.leaf_spec(tuple(abstract[path]),
                                            axes[path], rules, stand)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_activation_policy_spec_matches_reference(mesh):
    shape, names = MESHES[mesh]
    stand = _StandIn(shape, names)
    multi = "pod" in names
    for make in ("default_rules", "cp_rules"):
        rules = getattr(ctx, make)(multi)
        assert rules == getattr(ref_ctx, make)(multi)
        ours = ctx.ActivationPolicy(stand, rules)
        theirs = ref_ctx.ActivationPolicy(stand, rules)
        for axes in [("batch", "seq", "d_model"),
                     ("batch", "cache_seq", "kv_heads", None),
                     ("clients", "d_model", "d_ff"),
                     ("batch", "heads", "heads", "vocab"),
                     (None, "experts", "moe_d_ff", "ssm_heads")]:
            assert ours.spec(axes) == tuple(theirs.spec(axes)), axes


def test_round_input_specs_and_constraints_match_reference():
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    abstract = {"w": jax.ShapeDtypeStruct((8,), jnp.float32)}
    batch = {"target": np.zeros((2, 4, 3), np.float32)}
    ref_p, ref_b = ref_policy.round_input_shardings(mesh, "data", abstract,
                                                    batch)
    got_p, got_b = policy.round_input_shardings(None, "data", abstract,
                                                batch)
    assert got_p == {k: tuple(v.spec) for k, v in ref_p.items()}
    assert got_b == {k: tuple(v.spec) for k, v in ref_b.items()}
    # eager PyTorch has no partitioner: the constraints return their input
    x = {"w": torch.ones(4, 8)}
    stand = _StandIn((4, 2), ("data", "model"))
    with ctx.activation_policy(ctx.ActivationPolicy(stand,
                                                    ctx.default_rules())):
        assert ctx.current_policy().mesh is stand
        assert ctx.constrain(x["w"], "batch", "d_ff") is x["w"]
        assert policy.constrain_tree(x, {"w": ("d_ff",)}) is x
    assert ctx.current_policy() is None


def test_axis_size_and_client_axis_match_reference():
    for mesh in MESHES:
        stand = _StandIn(*MESHES[mesh])
        for name in (None, "data", "model", ("pod", "data")):
            if name is not None and not set(np.atleast_1d(name)) <= \
                    set(stand.axis_names):
                continue
            assert spmd.axis_size(stand, name) == \
                ref_spmd.axis_size(stand, name)
        assert spmd.resolve_client_axis(stand) == \
            ref_spmd.resolve_client_axis(stand) == "data"
    clients = _StandIn((2, 2), ("model", "clients"))
    assert spmd.resolve_client_axis(clients) == "clients"
    assert spmd.resolve_client_axis(_StandIn((2,), ("x",))) == "x"
    stand = _StandIn((2, 4, 2), ("pod", "data", "model"),
                     {"pod": 1, "data": 3})
    assert spmd.axis_index(stand, ("pod", "data")) == 7


# -- meshes --------------------------------------------------------------------


def test_parse_mesh_matches_reference():
    for spec in ("4", "4x2", "1", "16X16"):
        assert mesh_lib.parse_mesh(spec) == ref_mesh.parse_mesh(spec)
    for spec in ("4x2x1", "abc", "0", "4x-1"):
        with pytest.raises(ValueError) as ours:
            mesh_lib.parse_mesh(spec)
        with pytest.raises(ValueError) as theirs:
            ref_mesh.parse_mesh(spec)
        assert str(ours.value) == str(theirs.value)


def test_host_mesh_raises_and_make_host_mesh_clamps(world1):
    _, mesh = world1
    assert mesh.mesh_dim_names == ("data", "model")
    assert spmd.mesh_shape(mesh) == {"data": 1, "model": 1}
    for spec in ("2", "1x2", "64"):
        with pytest.raises(RuntimeError, match="--devices N"):
            mesh_lib.host_mesh(spec)
    assert spmd.mesh_shape(mesh_lib.make_host_mesh(4, 2)) == \
        {"data": 1, "model": 1}


# -- refusals, in the reference's words ---------------------------------------


def _refusal(fed_round, model, scfg_cls, mesh, kind, async_trainer):
    """Call ``fed_round`` the way refusal ``kind`` needs; returns the
    exception it raised."""
    lsq = dict(W.LSQ, scheme="rolling")
    kw = dict(mesh=mesh)
    if kind == "unknown_axis":
        kw["spmd_axis"] = "clients"
    elif kind == "indivisible":
        lsq["clients_per_round"] = 3
    elif kind == "mask_mode":
        lsq["scheme"] = "bernoulli"
    elif kind == "unknown_agg":
        kw["mesh_agg"] = "reduce"
    elif kind == "capacities":
        kw["capacities"] = [1.0, 0.5, 0.5, 0.25]
    with pytest.raises(ValueError) as e:
        fed = fed_round(model, scfg_cls(**lsq), **kw)
        if kind == "async":
            async_trainer(fed)
    return str(e.value)


REFUSALS = ["unknown_axis", "indivisible", "mask_mode", "unknown_agg",
            "capacities", "async"]


@pytest.mark.parametrize("kind", REFUSALS)
def test_refusals_match_reference(kind):
    ref_model = _ref_model("lsq")
    port_model = W._model("lsq")
    mesh = _StandIn((2, 1), ("data", "model"))
    theirs = _refusal(
        lambda m, s, **kw: ref_api.fed_round(m, s, kernel_backend="jnp",
                                             **kw),
        ref_model, RefSubmodelConfig, mesh, kind,
        lambda fed: ref_api.AsyncTrainer(fed, {"w": jnp.zeros(8)}))
    ours = _refusal(
        lambda m, s, **kw: api.fed_round(m, s, device="cpu", **kw),
        port_model, SubmodelConfig, mesh, kind,
        lambda fed: api.AsyncTrainer(fed, {"w": torch.zeros(8)}))
    assert ours == theirs


def test_spmd_axis_without_a_mesh_is_accepted():
    """As in the reference, where it pins the client vmap; no vmap runs
    here, so the round is the plain one."""
    fed = api.fed_round(W._model("lsq"), SubmodelConfig(
        **dict(W.LSQ, scheme="rolling")), spmd_axis="clients", device="cpu")
    assert fed.mesh is None and fed.spmd_axis == "clients"
    with pytest.raises(ValueError) as ours:
        api.fed_round(W._model("lsq"), SubmodelConfig(
            **dict(W.LSQ, scheme="bernoulli")), spmd_axis="data",
            device="cpu")
    with pytest.raises(ValueError) as theirs:
        ref_api.fed_round(_ref_model("lsq"), RefSubmodelConfig(
            **dict(W.LSQ, scheme="bernoulli")), spmd_axis="data")
    assert str(ours.value) == str(theirs.value)
