"""Per-phase FLOP/byte/roofline profile: fused vs extract fed round.

Ports ``ARMS``, ``PHASES``, ``PHASE_METRICS``, ``profile``,
``merge_results`` and ``main`` of ``repro/analysis/round_profile.py``.
Both arms do the same products but move very different bytes (the extract
arm stacks per-client compact copies; the fused arm reads windows in
place), so each ROUND PHASE -- the client phase, the delta aggregation
and the whole round -- is counted on its own by ``analysis.cost.Counter``
and rendered as a three-term roofline at the H100's rates
(``analysis.roofline``)::

    PYTHONPATH=src python -m repro_torch.analysis.round_profile \
        [--arch tinyllama_1_1b] [--out experiments/bench_results.json]

On ``meta`` (the default) nothing runs: the counterpart of the
reference's compile-only profile.  On ``cuda`` each phase runs once on
the card while it is counted, and ``measure=True`` also reads each
phase's device time (the sum of its kernels' durations in a
``torch.profiler`` trace, ``analysis.trace``) and its share,
``step_lb / device time``; a share above :data:`SHARE_MAX` means the
count is wrong, and the profile raises.  Keys are flat,
``{arm}_{phase}_{metric}`` and ``{phase}_bytes_extract_over_fused``.
"""
from __future__ import annotations

import argparse
import json
import os

ARMS = ("fused", "extract")
PHASES = ("client", "aggregate", "round")

#: Metrics emitted per (arm, phase)
PHASE_METRICS = ("flops", "bytes", "intensity", "t_compute_us",
                 "t_memory_us", "bottleneck", "step_lb_us")
#: Metrics a measured profile adds per (arm, phase)
MEASURED_METRICS = ("device_us", "share")
#: the largest share of a measured phase a correct count allows
SHARE_MAX = 1.05
#: sequences a client step takes, the reference profile's
MB = 2


def _phase_rows(counter, chips, mflops):
    from repro_torch.analysis import roofline
    rl = roofline.Roofline(dict(counter.flops_by_class), counter.bytes,
                           counter.coll_bytes, chips, mflops)
    flops = rl.flops_per_dev
    return {
        "flops": int(flops),
        "bytes": int(counter.bytes),
        "intensity": round(flops / max(counter.bytes, 1), 3),
        "t_compute_us": round(rl.t_compute * 1e6, 3),
        "t_memory_us": round(rl.t_memory * 1e6, 3),
        "bottleneck": rl.bottleneck,
        "step_lb_us": round(rl.step_time_lower_bound * 1e6, 3),
    }


def _device_us(prof):
    from repro_torch.analysis.trace import Trace
    return 1e3 * sum(t for _, t in Trace(prof).kernels)


def profile(arch="tinyllama_1_1b", chips=1, seq=64, device="meta",
            measure=False, cfg=None, scfg=None):
    """Count (and on the card, with ``measure``, time) the fused and
    extract round phases and return a flat ``{"{arm}_{phase}_{metric}":
    value}`` dict.  The default model and plan are the reference
    profile's: ``arch``'s reduced config at 2 layers and head_dim 16,
    rolling at 0.5, C = 4, K = 2, :data:`MB` sequences of ``seq`` tokens a
    client step; ``cfg`` and ``scfg`` replace them (full width on the
    card).  Each arm starts from the same params: the aggregation steps a
    copy of them."""
    from dataclasses import replace

    import torch

    from repro_torch import api
    from repro_torch.analysis.cost import Counter
    from repro_torch.analysis.roofline import model_flops
    from repro_torch.configs.base import SubmodelConfig, get_reduced_config
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model

    dev = resolve_device(device)
    if measure and dev.type != "cuda":
        raise ValueError("measure=True times the phases on the card")
    cfg = cfg or replace(get_reduced_config(arch), n_layers=2, head_dim=16)
    scfg = scfg or SubmodelConfig(scheme="rolling", capacity=0.5,
                                  local_steps=2, clients_per_round=4,
                                  client_lr=0.05)
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    K, C = scfg.local_steps, scfg.clients_per_round
    if dev.type == "meta":
        batch = {"tokens": torch.empty((K, C, MB, seq), dtype=torch.int32,
                                       device=dev)}
    else:
        from repro_torch.data.synthetic import lm_batches
        batch = {k: torch.as_tensor(v).to(dev) for k, v in
                 next(lm_batches(cfg.vocab, (K, C, MB), seq)).items()}
    tokens = K * C * MB * seq
    mflops = model_flops(cfg, model.abstract_params(), tokens)

    def run(fn, *args):
        """``fn(*args)`` counted (and timed); returns (rows, output)."""
        prof = None
        if measure:
            from torch.profiler import ProfilerActivity
            torch.cuda.synchronize()
            prof = torch.profiler.profile(
                activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        try:
            with Counter(args=args, device=dev.type) as c:
                out = fn(*args)
            if measure:
                torch.cuda.synchronize()
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        rows = _phase_rows(c, chips, mflops)
        if measure:
            us = _device_us(prof)
            rows["device_us"] = round(us, 3)
            rows["share"] = round(rows["step_lb_us"] / max(us, 1e-9), 4)
        return rows, out

    out = {}
    for arm in ARMS:
        fed = api.fed_round(model, scfg, device=dev,
                            fused_forward="on" if arm == "fused" else "off")
        offsets = fed._client_offsets(0, params)
        phase = (fed._client_phase_fused if arm == "fused"
                 else fed._client_phase)
        agg = (fed._apply_mean_delta_fused if arm == "fused"
               else fed._apply_mean_delta)
        rows = {}
        rows["client"], (delta, _) = run(phase, params, batch, offsets)
        with torch.no_grad():
            server = {k: v.clone() for k, v in params.items()}
            rows["aggregate"], _ = run(agg, server, delta, offsets)
        del delta, server
        server = {k: v.clone() for k, v in params.items()}
        rows["round"], _ = run(
            lambda p, b: fed.round(p, b, 0, offsets=offsets), server, batch)
        del server
        for ph, r in rows.items():
            for k, v in r.items():
                out[f"{arm}_{ph}_{k}"] = v
    for ph in PHASES:
        fb, eb = out[f"fused_{ph}_bytes"], out[f"extract_{ph}_bytes"]
        out[f"{ph}_bytes_extract_over_fused"] = round(eb / max(fb, 1), 3)
    if measure:
        over = {k: v for k, v in out.items()
                if k.endswith("_share") and v > SHARE_MAX}
        if over:
            raise RuntimeError(
                f"round profile: the counted lower bound exceeds the "
                f"measured device time by more than {SHARE_MAX}: {over} "
                f"(the count is wrong)")
    return out


def merge_results(results, path):
    """Merge a ``round_profile`` entry into the results JSON at ``path``
    (read, update, write)."""
    existing = {}
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
    existing["round_profile"] = results
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(existing, f, indent=1, sort_keys=True)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--chips", type=int, default=1)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--out", default="experiments/bench_results.json")
    args = ap.parse_args(argv)
    results = profile(arch=args.arch, chips=args.chips, seq=args.seq)
    for k, v in sorted(results.items()):
        print(f"round_profile,{k},{v}")
    print("wrote", merge_results(results, args.out))


if __name__ == "__main__":
    main()
