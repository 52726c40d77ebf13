"""The continuous batcher (``launch/batching.py``) in the port against the
JAX reference's.

- Reduced TinyLlama, Qwen3-14B (``qk_norm``) and Mixtral-8x22B (``dense``
  MoE path), params made by the reference and converted through numpy:
  the same ragged queue (``request_queue``, prompts of 5, 9, 7, 12 and 3
  tokens, 4 new tokens each) through 2 slots on a timeline of 60 gives
  the reference's tokens for every request and its ``EngineStats``, and
  the third request is admitted after a retirement.
- Mixtral on ``dropping`` at a capacity factor that holds every choice
  (the idle slot's token shares the experts' capacity, as in the
  reference; at the default factor the reference's dispatch fault moves
  its tokens, ROADMAP.md §C).
- Inside the port: every request's tokens equal a single-request greedy
  prefill + decode of its prompt (``tests/test_batching.py``'s check).
- The refusals: the SSM and hybrid families, and a timeline longer than
  the sliding window (``AssertionError``, as the reference's ``assert``);
  ``request_queue``'s prompts equal to the reference's for one seed, and
  its ``ValueError`` for codebook and vision configs.
- ``launch/serve.py --engine continuous`` completes every request.

Tokens are compared exactly: greedy argmax over float32 logits that agree
within 1e-5, on random weights whose top-2 margins lie far above that.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_reduced_config as ref_reduced  # noqa: E402
from repro.launch.batching import ContinuousBatcher as RefBatcher  # noqa
from repro.launch.specs import request_queue as ref_request_queue  # noqa
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_reduced_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.batching import (ContinuousBatcher,  # noqa: E402
                                         EngineStats, Request)
from repro_torch.launch.specs import request_queue  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

LENGTHS = (5, 9, 7, 12, 3)
MAX_NEW, SLOTS, MAX_LEN = 4, 2, 60
CASES = {"tinyllama": ("tinyllama_1_1b", "dense", {}),
         "qwen3": ("qwen3_14b", "dense", {}),
         "mixtral dense": ("mixtral_8x22b", "dense", {}),
         "mixtral dropping": ("mixtral_8x22b", "dropping",
                              {"capacity_factor": 8.0})}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, moe_over):
    rc, pc = ref_reduced(arch), get_reduced_config(arch)
    if moe_over:
        rc = dataclasses.replace(rc, moe=dataclasses.replace(rc.moe,
                                                             **moe_over))
        pc = dataclasses.replace(pc, moe=dataclasses.replace(pc.moe,
                                                             **moe_over))
    return rc, pc


@pytest.fixture(scope="module", params=list(CASES))
def served(request):
    """The queue through the reference's batcher and the port's, from the
    same params."""
    arch, path, over = CASES[request.param]
    rc, pc = _configs(arch, over)
    ref = ref_build(rc, moe_path=path, remat=False)
    ref_params = ref.init(jax.random.PRNGKey(0))
    ref_reqs = ref_request_queue(rc, LENGTHS, max_new=MAX_NEW, seed=0)
    ref_eng = RefBatcher(ref, ref_params, batch_slots=SLOTS,
                         max_len=MAX_LEN)
    for r in ref_reqs:
        ref_eng.submit(r)
    ref_eng.run()
    model = build_model(pc, moe_path=path)
    params = convert.from_reference(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    reqs = request_queue(pc, LENGTHS, max_new=MAX_NEW, seed=0)
    eng = ContinuousBatcher(model, params, batch_slots=SLOTS,
                            max_len=MAX_LEN)
    for r in reqs:
        eng.submit(r)
    eng.run()
    return dict(ref_reqs=ref_reqs, ref_eng=ref_eng, reqs=reqs, eng=eng,
                model=model, params=params)


def test_batcher_matches_reference(served):
    reqs, ref_reqs = served["reqs"], served["ref_reqs"]
    assert all(r.done for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert dataclasses.asdict(served["eng"].stats) == dataclasses.asdict(
        served["ref_eng"].stats)
    assert served["eng"].stats.completed == len(LENGTHS)
    # the third request was admitted after a retirement
    assert served["eng"].stats.prefills >= 2
    assert all(len(r.out) == MAX_NEW + 1 for r in reqs)


def _greedy(model, params, prompt, n_new):
    """Single-request greedy decode via plain prefill + decode."""
    with torch.no_grad():
        p = torch.as_tensor(prompt, dtype=torch.long)[None]
        logits, cache = model.prefill(params, p,
                                      max_len=len(prompt) + n_new + 1)
        toks = [int(torch.argmax(logits[0]))]
        for pos in range(len(prompt), len(prompt) + n_new):
            nxt, cache = model.decode_step(
                params, torch.tensor([toks[-1]]), cache, pos)
            toks.append(int(torch.argmax(nxt[0])))
    return toks


def test_batcher_matches_single_request_decode(served):
    # (on dropping the capacity holds every choice, alone and in the pool)
    for r in served["reqs"]:
        assert r.out == _greedy(served["model"], served["params"], r.prompt,
                                MAX_NEW)


@pytest.mark.parametrize("arch", ["mamba2_130m", "hymba_1_5b"])
def test_batcher_refuses_recurrent_families(arch):
    model = build_model(get_reduced_config(arch))
    params = model.init(0, device="cpu")
    with pytest.raises(AssertionError, match="generation-level batching"):
        ContinuousBatcher(model, params)


def test_batcher_refuses_a_timeline_past_the_window():
    model = build_model(get_reduced_config("mixtral_8x22b"))
    params = model.init(0, device="cpu")
    ContinuousBatcher(model, params, max_len=64)
    with pytest.raises(AssertionError, match="sliding window"):
        ContinuousBatcher(model, params, max_len=65)


def test_request_queue_matches_reference():
    want = ref_request_queue(ref_reduced("qwen3_14b"), (3, 17, 8),
                             max_new=5, seed=7)
    got = request_queue(get_reduced_config("qwen3_14b"), (3, 17, 8),
                        max_new=5, seed=7)
    assert [(r.rid, r.max_new, r.out, r.done) for r in got] == \
        [(r.rid, r.max_new, r.out, r.done) for r in want]
    for a, b in zip(got, want):
        assert isinstance(a, Request)
        np.testing.assert_array_equal(a.prompt, b.prompt)
    for over in (dict(n_codebooks=4), dict(vision_stub=True)):
        cfg = dataclasses.replace(get_reduced_config("qwen3_14b"), **over)
        with pytest.raises(ValueError, match="plain token prompts"):
            request_queue(cfg, (3,))
    assert EngineStats() == EngineStats(0, 0, 0, 0)


def test_serve_cli_continuous_engine_completes_every_request(capsys):
    eng = serve.main(["--arch", "tinyllama_1_1b", "--reduced", "--device",
                      "cpu", "--engine", "continuous"])
    out = capsys.readouterr().out
    assert eng.stats.completed == 4 and all(r is None for r in
                                            eng._slot_req)
    assert out.startswith("continuous: 4 requests, 64 tokens")
