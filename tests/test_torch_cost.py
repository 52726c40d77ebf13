"""The kernels' declared costs, the eager cost counter and the round
profile, against PERF.md's bounds, ``torch.utils.flop_counter`` and the
JAX reference's compiled HLO.

* Each kernel's ``cost()`` gives PERF.md section 6's bound (H100: 3xTF32
  at 495 / 3 TFLOP/s, bf16 at 989, f32 at 67, HBM at 3.35 TB/s) at the
  kernel table's shapes, to 3 significant figures (relative 5e-4 of the
  rounded figure).
* Each declared product FLOP count equals ``torch.utils.flop_counter``'s
  count of the kernel's plain version on the CPU, exactly: rows 1-8 at
  both T and both directions; row 13 on the visible pairs (the plain
  version called row by row on the keys each query sees: the plain
  version's blocks otherwise include masked pairs; a row's P v over one
  key is a broadcast multiply flop_counter does not count, added by hand),
  its bf16 arm one P v pass more (P's two bf16 parts); row 12 less the
  upper triangle of each chunk that the plain version multiplies by zero,
  its bf16 arm ``M x`` and the state once more.
* ``visible_pairs``'s closed form equals a count of the mask pair by
  pair, exactly.
* Each wrapper's ``meta`` arm (f32 and bf16) returns outputs of the
  kernel's shapes on ``meta``, launches nothing, declares its ``cost()``
  once and refuses what the card's arm refuses; with no counter active it
  works out no cost at all.
* The counter sees a backward on the CPU (a product's two gradient
  products), and on ``meta`` the windowed products' dx kernels.
* The counter's peak counts the engine's sum of a tensor's two gradients
  as made in place (both summands, never a third buffer beside them), on
  the CPU and on ``meta``.
* At the reference profile's own config (reduced TinyLlama at 2 layers,
  head_dim 16, rolling at 0.5, C = 4, K = 2, mb 2, seq 64) the counter's
  dot FLOPs of the fused and the extract client phases equal the sum over
  the reference's compiled client-phase HLO of its ``dot`` and
  ``convolution`` instructions times their loops' trip counts
  (``hlo_cost.parse_module``, ``trip_count``; read only) within 1% (they
  agree exactly).  Its ``client_bytes_extract_over_fused`` is below 1, as
  the reference's own analyzer reads on the same HLO (0.834: the fused
  phase's full-shaped client copies, zero gradients and SGD steps move
  more than the extract phase's compact copies), and within 0.05 of it.
* ``gpu``: on the card the counter reads the same dot FLOPs and kernel
  launches of a reduced fused client phase as on ``meta``, its backward
  run by the autograd engine's worker thread; the JAX imports of this file
  sit inside the CPU tests, so the card's machine collects it without JAX.
"""
import dataclasses
import re

import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.analysis import round_profile  # noqa: E402
from repro_torch.analysis.cost import Counter  # noqa: E402
from repro_torch.analysis.roofline import bound_ms  # noqa: E402
from repro_torch.configs.base import (SubmodelConfig,  # noqa: E402
                                      get_reduced_config)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import masked_update as mu  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rolling_matmul as rm  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

BF = torch.bfloat16
N_LEAF = 4 * 2048 * 5632           # rows 9-10: the w_gate client leaf
SCFG = dict(scheme="rolling", capacity=0.5, local_steps=2,
            clients_per_round=4, client_lr=0.05)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes at once, and torch's pool of a thread per core in
    each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# PERF.md section 6's bounds (ms) at the kernel table's shapes
BOUNDS = [
    ("row 9", mu.cost("masked_sgd", N_LEAF), 0.2204),
    ("row 10", mu.cost("sgd", N_LEAF), 0.1653),
    ("row 11", mu.cost("fillin", 2048 * 5632, clients=4), 0.1377),
    ("row 5 q", rm.cost("fwd", 1, 4, 512, 2048, 1024), 0.0521),
    ("row 7", rm.cost("fwd", 2, 4, 512, 2048, 2816), 0.286),
    ("row 13", fa.cost(4, 2048, 2048, 32, 4, 64), 0.417),
    ("row 13 hd 128", fa.cost(4, 2048, 2048, 32, 8, 128), 0.833),
    ("row 12", sc.cost(8, 128, 256, 24, 64, 128), 1.304),
    ("row 12 bf16", sc.cost(8, 128, 256, 24, 64, 128, BF), 0.7650),
    ("row 9 bf16", mu.cost("masked_sgd", N_LEAF, BF), 0.1102),
    ("row 10 bf16", mu.cost("sgd", N_LEAF, BF), 0.0826),
    ("row 11 bf16", mu.cost("fillin", 2048 * 5632, BF, clients=4), 0.0689),
    ("row 13 bf16", fa.cost(4, 2048, 2048, 32, 4, 64, dtype=BF), 0.1043),
]


@pytest.mark.parametrize("tag,cost,want", BOUNDS, ids=[b[0] for b in BOUNDS])
def test_cost_reproduces_the_kernel_tables_bound(tag, cost, want):
    got, _ = bound_ms(*cost)
    assert float(f"{got:.3g}") == pytest.approx(float(f"{want:.3g}"),
                                                rel=5e-4), (tag, got)


def _counted(fn):
    with FlopCounterMode(display=False) as f:
        fn()
    return f.get_total_flops()


@pytest.mark.parametrize("kind", ["fwd", "dx"])
@pytest.mark.parametrize("T", [1, 2])
def test_product_cost_equals_flop_counter_of_plain(kind, T):
    g = torch.Generator().manual_seed(0)
    C, M, K, N, win, offs = 3, 20, 24, 40, 17, [0, 5, 23]
    x = torch.randn((C, M, K), generator=g)
    ws = [torch.randn((C, K, N), generator=g) for _ in range(T)]
    dys = [torch.randn((C, M, win), generator=g) for _ in range(T)]
    plain = (lambda: ref.rolling_matmul_batched_ref(x, ws, offs, win)) \
        if kind == "fwd" else \
        (lambda: ref.rolling_matmul_batched_dx_ref(dys, ws, offs, win))
    for dtype in (torch.float32, BF):
        flops, _, klass = rm.cost(kind, T, C, M, K, win, dtype)
        assert flops == _counted(plain)
        assert klass == ("bfloat16" if dtype == BF else "tf32x3")


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3), (False, 0),
                                           (False, 4)])
def test_flash_cost_equals_flop_counter_on_visible_pairs(causal, window):
    g = torch.Generator().manual_seed(1)
    B, S, H, KV, hd = 2, 9, 4, 2, 16
    q = torch.randn((B, S, H, hd), generator=g)
    k = torch.randn((B, S, KV, hd), generator=g)
    v = torch.randn((B, S, KV, hd), generator=g)

    one_key = []

    def row_by_row():
        for i in range(S):
            hi = i + 1 if causal else S
            lo = max(i - window + 1, 0) if window else 0
            one_key.append(hi - lo == 1)
            ref.flash_attention_ref(q[:, i:i + 1], k[:, lo:hi], v[:, lo:hi],
                                    causal=False)
    # P v over a single key is a broadcast multiply in torch.einsum, which
    # flop_counter does not count: its 2 * hd FLOPs a head are added here
    counted = _counted(row_by_row) + sum(one_key) * 2 * B * H * hd
    assert fa.cost(B, S, S, H, KV, hd, causal, window)[0] == counted
    assert fa.cost(B, S, S, H, KV, hd, causal, window, BF)[0] == \
        counted + counted // 2            # P v twice: P's two bf16 parts


@pytest.mark.parametrize("causal", [True, False])
def test_visible_pairs_closed_form_counts_the_mask(causal):
    for Sq in range(1, 11):
        for Skv in range(1, 11):
            for window in range(0, 13):
                want = sum(1 for q in range(Sq) for k in range(Skv)
                           if (not causal or k <= q)
                           and (not window or q - k < window))
                assert fa.visible_pairs(Sq, Skv, causal, window) == want, \
                    (Sq, Skv, window)


def test_ssd_cost_equals_flop_counter_less_the_masked_triangle():
    g = torch.Generator().manual_seed(2)
    Bt, nc, Q, nh, hd, N = 2, 3, 8, 4, 16, 8
    x = torch.randn((Bt, nc, Q, nh, hd), generator=g)
    dt = torch.rand((Bt, nc, Q, nh), generator=g)
    A = -torch.rand((nh,), generator=g)
    B = torch.randn((Bt, nc, Q, N), generator=g)
    C = torch.randn((Bt, nc, Q, N), generator=g)
    counted = _counted(lambda: ref.ssd_chunk_intra_ref(x, dt, A, B, C))
    pairs = Q * (Q + 1) // 2
    masked = Bt * nc * (Q * Q - pairs) * (2 * N + 2 * nh * hd)
    assert sc.cost(Bt, nc, Q, nh, hd, N)[0] == counted - masked
    rest = Bt * nc * nh * (2 * pairs * hd + 2 * Q * hd * N)
    assert sc.cost(Bt, nc, Q, nh, hd, N, BF)[0] == counted - masked + rest


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_counter_sums_a_gradient_in_place_as_the_engine(device):
    # W's two gradients (x^T g, N x N each) are summed by the engine: in
    # place into one of them without a dispatch mode, so the sum never
    # lies beside both summands; everything else here is tiny
    N = 256
    w = torch.zeros((N, N), device=device, requires_grad=True)
    x = torch.zeros((2, N), device=device)
    nw = N * N * 4
    with Counter(args=(w, x), device=device) as c:
        g, = torch.autograd.grad((x @ w).sum() + (2 * x @ w).sum(), w)
    assert 2 * nw <= c.peak_live_bytes < 2 * nw + nw // 2


def test_counter_sees_backward_on_the_cpu():
    a = torch.randn((8, 16), requires_grad=True)
    b = torch.randn((16, 4), requires_grad=True)
    with Counter(args=(a, b)) as c:
        y = (a @ b).sum()
        torch.autograd.grad(y, [a, b])
    assert c.dot_flops == 3 * 2 * 8 * 16 * 4        # forward + 2 grads
    assert c.peak_bytes >= c.argument_bytes == 4 * (8 * 16 + 16 * 4)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


META_CALLS = {
    "rows 5-8 fwd": (lambda d: rm.rolling_mm_fwd(
        _meta(3, 8, 16, dtype=d), [_meta(3, 16, 40, dtype=d)] * 2,
        rm.make_offsets([0, 4, 24], "meta"), 16),
        ((3, 8, 16),) * 2, "rolling_mm_fwd<2>",
        lambda d: rm.cost("fwd", 2, 3, 8, 16, 16, d)),
    "rows 5-8 dx": (lambda d: (rm.rolling_mm_dx(
        [_meta(3, 8, 16, dtype=d)], [_meta(3, 16, 40, dtype=d)],
        rm.make_offsets([0, 4, 24], "meta"), 16),),
        ((3, 8, 16),), "rolling_mm_dx<1>",
        lambda d: rm.cost("dx", 1, 3, 8, 16, 16, d)),
    "row 10": (lambda d: (mu.sgd_(_meta(6, 7, dtype=d), _meta(6, 7, dtype=d),
                                  0.1),),
               ((6, 7),), "sgd_inplace", lambda d: mu.cost("sgd", 42, d)),
    "row 9": (lambda d: (mu.masked_sgd_(_meta(6, 7, dtype=d),
                                        _meta(6, 7, dtype=d),
                                        _meta(6, 7, dtype=d), 0.1),),
              ((6, 7),), "masked_sgd_inplace",
              lambda d: mu.cost("masked_sgd", 42, d)),
    "row 11": (lambda d: (mu.fillin_agg_(_meta(6, 7, dtype=d),
                                         _meta(3, 6, 7, dtype=d),
                                         _meta(3, 6, 7, dtype=d)),),
               ((6, 7),), "fillin_agg_inplace",
               lambda d: mu.cost("fillin", 42, d, clients=3)),
    "row 12": (lambda d: sc.ssd_chunk_intra(
        _meta(2, 3, 8, 6, 16, dtype=d), _meta(2, 3, 8, 6, dtype=d),
        _meta(6), _meta(2, 3, 8, 4, dtype=d), _meta(2, 3, 8, 4, dtype=d),
        head_offset=1, head_win=4),
        ((2, 3, 8, 4, 16), (2, 3, 4, 16, 4)), "ssd_chunk_intra",
        lambda d: sc.cost(2, 3, 8, 4, 16, 4, d)),
    "row 13": (lambda d: (fa.flash_attention(
        _meta(2, 9, 4, 16, dtype=d), _meta(2, 9, 2, 16, dtype=d),
        _meta(2, 9, 2, 16, dtype=d), window=3),),
        ((2, 9, 4, 16),), "flash_attention",
        lambda d: fa.cost(2, 9, 9, 4, 2, 16, True, 3, d)),
}


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("row", list(META_CALLS))
def test_meta_arm_returns_shapes_and_declares_its_cost(row, dtype):
    from repro_torch.kernels import _build
    call, shapes, name, want = META_CALLS[row]
    before = dict(_build.LAUNCHES)
    with Counter(device="meta") as c:
        outs = call(dtype)
    assert [tuple(t.shape) for t in outs] == list(shapes)
    assert all(t.device.type == "meta" for t in outs)
    assert dict(_build.LAUNCHES) == before          # nothing launched
    name += "/bf16" if dtype == BF else ""
    flops, nbytes, klass = want(dtype)
    assert c.kernels == {name: 1}
    assert c.flops_by_class[klass] == flops and c.bytes >= nbytes


def _no_cost(*args, **kw):
    raise AssertionError("a cost was worked out with no counter active")


@pytest.mark.parametrize("row", list(META_CALLS))
def test_no_cost_is_worked_out_outside_a_counter(row, monkeypatch):
    # the meta arm reports as the card's arm does, beside its launch
    call, shapes, _, _ = META_CALLS[row]
    for mod in (rm, mu, sc, fa):
        monkeypatch.setattr(mod, "cost", _no_cost)
    outs = call(torch.float32)
    assert [tuple(t.shape) for t in outs] == list(shapes)


def test_meta_arm_checks_as_on_the_card():
    with pytest.raises(ValueError, match="leaves the"):
        rm.rolling_mm_fwd(_meta(2, 8, 16), [_meta(2, 16, 40)],
                          rm.make_offsets([0, 30], "meta"), 16)
    with pytest.raises(TypeError, match="one dtype"):
        mu.sgd_(_meta(4), _meta(4, dtype=BF), 0.1)
    with pytest.raises(ValueError, match="head window"):
        sc.ssd_chunk_intra(_meta(1, 1, 8, 4, 16), _meta(1, 1, 8, 4),
                           _meta(4), _meta(1, 1, 8, 4), _meta(1, 1, 8, 4),
                           head_offset=2, head_win=3)


def _reduced():
    cfg = dataclasses.replace(get_reduced_config("tinyllama_1_1b"),
                              n_layers=2, head_dim=16)
    return cfg, SubmodelConfig(**SCFG)


def _port_client_phase(arm, device="meta"):
    cfg, scfg = _reduced()
    model = build_model(cfg)
    params = model.init(seed=0, device=device)
    fed = api.fed_round(model, scfg, device=device,
                        fused_forward="on" if arm == "fused" else "off")
    offsets = fed._client_offsets(0, params)
    phase = (fed._client_phase_fused if arm == "fused"
             else fed._client_phase)
    if device == "meta":
        batch = {"tokens": torch.empty((2, 4, 2, 64), dtype=torch.int32,
                                       device="meta")}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 4, 2, 64),
                                         device=device)}
    with Counter(args=(params, batch), device=device) as c:
        phase(params, batch, offsets)
    return c


def test_counter_sees_the_windowed_products_backward_on_meta():
    c = _port_client_phase("fused")
    # q, k, v and the gate/up pair, forward and dx, K = 2 steps, 2 layers
    assert c.kernels == {"rolling_mm_fwd<1>": 12, "rolling_mm_dx<1>": 12,
                         "rolling_mm_fwd<2>": 4, "rolling_mm_dx<2>": 4,
                         "sgd_inplace": 2 * 21}


def _hlo_dot_flops(hlo):
    """The reference's compiled dot and convolution FLOPs, each times the
    trip counts of the loops around it."""
    from repro.analysis import hlo_cost
    comps = hlo_cost.parse_module(hlo)
    entry = re.search(r"ENTRY\s+%?([\w.\-]+)", hlo).group(1)
    memo = {}

    def walk(name):
        if name in memo:
            return memo[name]
        comp, total = comps.get(name), 0.0
        memo[name] = 0.0
        if comp is None:
            return 0.0
        shapes = {}
        for ins in comp.instrs:
            m = hlo_cost._SHAPE_RE.search(ins.out_text)
            shapes[ins.name] = (ins.out_elems, ins.out_bytes,
                                hlo_cost._dims(m.group(2)) if m else [])
        for ins in comp.instrs:
            if ins.opcode == "dot":
                total += hlo_cost._dot_flops(ins, shapes)
            elif ins.opcode == "convolution":
                total += hlo_cost._conv_flops(ins, shapes)
            elif ins.opcode == "while":
                body = hlo_cost._CALLED.search(ins.rest)
                cond = hlo_cost._COND.search(ins.rest)
                known = hlo_cost._TRIP_RE.search(ins.rest)
                trips = int(known.group(1)) if known else hlo_cost.trip_count(
                    comps.get(cond.group(1), hlo_cost.Computation("")))
                total += trips * walk(body.group(1))
            else:
                for called in re.findall(
                        r"(?:calls|to_apply|body|branch_computations)="
                        r"\{?%?([\w.\-]+)", ins.rest):
                    total += walk(called)
        memo[name] = total
        return total

    return walk(entry)


@pytest.fixture(scope="module")
def reference_client_phases():
    """The reference profile's compiled client phases (its own config),
    read: dot FLOPs and its analyzer's bytes, by arm."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import api as ref_api
    from repro.analysis import hlo_check, hlo_cost
    from repro.configs.base import SubmodelConfig as RefSubmodelConfig
    from repro.configs.base import get_reduced_config as ref_reduced
    from repro.data.synthetic import lm_batches
    from repro.models import build_model as ref_build
    cfg = dataclasses.replace(ref_reduced("tinyllama_1_1b"), n_layers=2,
                              head_dim=16)
    m = ref_build(cfg, remat=False, layer_unroll=True)
    params = m.init(jax.random.PRNGKey(0))
    scfg = RefSubmodelConfig(**SCFG)
    batch = {k: jnp.asarray(v) for k, v in
             next(lm_batches(cfg.vocab, (2, 4, 2), 64)).items()}
    out = {}
    for arm in ("fused", "extract"):
        fed = ref_api.fed_round(m, scfg, fused_forward="on" if arm == "fused"
                                else "off")
        offsets = fed._client_offsets(params, 0, jax.random.PRNGKey(1))
        phase = (fed._client_phase_fused if arm == "fused"
                 else fed._client_phase)
        hlo = hlo_check.compiled_text(lambda p, b, o: phase(p, b, o)[1],
                                      params, batch, offsets)
        out[arm] = (_hlo_dot_flops(hlo), hlo_cost.analyze(hlo)["bytes"])
    return out


@pytest.mark.parametrize("arm", ["fused", "extract"])
def test_client_phase_dot_flops_equal_the_reference_hlo(
        arm, reference_client_phases):
    want = reference_client_phases[arm][0]
    got = _port_client_phase(arm).dot_flops
    assert want > 0
    assert got == pytest.approx(want, rel=0.01)


def test_extract_over_fused_bytes_read_as_the_reference_reads(
        reference_client_phases):
    prof = round_profile.profile()          # the reference's config, meta
    ratio = prof["client_bytes_extract_over_fused"]
    ref_ratio = (reference_client_phases["extract"][1]
                 / reference_client_phases["fused"][1])
    assert ratio < 1 and ref_ratio < 1
    assert ratio == pytest.approx(ref_ratio, abs=0.05)
    for arm in round_profile.ARMS:
        for ph in round_profile.PHASES:
            for metric in round_profile.PHASE_METRICS:
                assert f"{arm}_{ph}_{metric}" in prof
    assert prof["fused_client_flops"] <= prof["fused_round_flops"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; none is present")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_counter_reads_the_meta_plan_on_the_card(card):
    """A reduced fused client phase on the card: the same dot FLOPs and
    kernel launches as its plan on meta, the backward's included (the
    autograd engine runs it on its worker thread)."""
    meta = _port_client_phase("fused")
    got = _port_client_phase("fused", device=card)
    assert got.kernels == meta.kernels
    assert got.dot_flops == meta.dot_flops
    assert got.kernels["rolling_mm_dx<1>"] == 12
