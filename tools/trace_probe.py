#!/usr/bin/env python3
"""``analysis.trace.Trace`` (the reader ``chip_smoke.py`` uses) against
torch's own profiler event list on one profile: six linear layers, half of them inside a ``record_function``
range, forward and backward, 40 times.  Compares every kernel name's count
and device ms (``key_averages()``), the range's forward and backward
kernels by group (``events()`` and its ``cpu_children`` trees, as
``chip_smoke.py`` read them before ``Trace``), and the range's calls,
device and host ms; prints both readers' seconds and ``TRACE_PROBE ok``
or ``TRACE_PROBE FAILED`` (exit code 1).

    python3 tools/trace_probe.py           # on the card
    python3 tools/trace_probe.py --cpu     # host ops only: no kernels

On the CPU the profile holds no device kernels, so only the range's calls,
trees and host ms are compared.
"""
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke  # noqa: E402
from repro_torch.analysis.trace import Trace, kernel_group  # noqa: E402

RANGE = "blk"


def by_event_list(prof, name):
    """The kernels, and the range's reading, from torch's event list."""
    from torch.autograd import DeviceType
    kern = {e.key: (e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key != name
            and e.self_device_time_total > 0}
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]

    def tree(e):
        yield e
        for c in e.cpu_children:
            yield from tree(c)

    def groups(events):
        out = {}
        for e in events:
            for k in e.kernels:
                g = kernel_group(k.name)
                out[g] = out.get(g, 0.0) + k.duration / 1e3
        return out
    calls = [e for e in events if e.name == name]
    fwd = [d for e in calls for d in tree(e)]
    seqs = {d.sequence_nr for d in fwd if d.sequence_nr >= 0}
    bwd = [d for e in events
           if e.name.startswith("autograd::engine::evaluate_function")
           and e.sequence_nr in seqs for d in tree(e)]
    row = [e for e in prof.key_averages()
           if e.key == name and e.device_type == DeviceType.CPU][0]
    return kern, (len(calls), {"forward": groups(fwd),
                               "backward": groups(bwd)},
                  row.cpu_time_total / 1e3, len(fwd), len(bwd))


def by_trace(prof, name):
    """The same readings through ``Trace``."""
    trace = Trace(prof)
    kern, _ = trace.device(skip=(name,))
    calls, parts = chip_smoke.range_kernels(trace, name)
    fwd = [o for r in trace.roots(lambda n, _: n == name)
           for o in trace.tree(r)]
    seqs = {o[3] for o in fwd if o[3] >= 0}
    bwd = [o for r in trace.roots(
        lambda n, q: n.startswith("autograd::engine::evaluate_function")
        and q in seqs) for o in trace.tree(r)]
    return ({k: (t, n) for k, t, n in kern},
            (calls, parts, trace.host_ms(name), len(fwd), len(bwd)))


def close(a, b, rel=1e-6):
    return abs(a - b) <= rel * max(1.0, abs(b))


def main(argv):
    from torch.profiler import ProfilerActivity, profile, record_function
    dev = torch.device("cpu" if "--cpu" in argv else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    net = torch.nn.Sequential(*[torch.nn.Linear(512, 512)
                                for _ in range(6)]).to(dev)
    x = torch.randn(256, 512, device=dev)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        for _ in range(40):
            h = x
            for j, m in enumerate(net):
                if j % 2:
                    with record_function(RANGE):
                        h = torch.relu(m(h)) * 1.5
                else:
                    h = m(h).tanh()
            h.square().mean().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
    t0 = time.perf_counter()
    kt, rt = by_trace(prof, RANGE)
    t1 = time.perf_counter()
    ke, re_ = by_event_list(prof, RANGE)
    t2 = time.perf_counter()
    print(f"[trace probe] {dev.type}: Trace {t1 - t0:.3f} s, torch's event "
          f"list {t2 - t1:.3f} s")
    ok = set(kt) == set(ke) and all(
        kt[k][1] == ke[k][1] and close(kt[k][0], ke[k][0]) for k in ke)
    print(f"[trace probe] kernels: {len(kt)} names by Trace, {len(ke)} by "
          f"key_averages; counts and ms equal: {ok}")
    calls = rt[0] == re_[0] and rt[3:] == re_[3:]
    print(f"[trace probe] range {RANGE!r}: calls {rt[0]} / {re_[0]}, forward "
          f"ops {rt[3]} / {re_[3]}, backward ops {rt[4]} / {re_[4]}; host ms "
          f"{rt[2]:.3f} / {re_[2]:.3f}")
    ok &= calls and close(rt[2], re_[2])
    for part in ("forward", "backward"):
        a, b = rt[1][part], re_[1][part]
        same = set(a) == set(b) and all(close(a[g], b[g]) for g in b)
        print(f"[trace probe] range {part} by group (Trace / event list): "
              + ", ".join(f"{g} {a.get(g, 0):.4f} / {b.get(g, 0):.4f} ms"
                          for g in sorted(set(a) | set(b))))
        ok &= same and (dev.type == "cpu" or sum(b.values()) > 0)
    print(f"TRACE_PROBE {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
