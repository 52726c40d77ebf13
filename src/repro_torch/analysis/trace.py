"""What the port reads of a ``torch.profiler`` profile on the card.

:class:`Trace` takes a profile's raw kineto events by the rules of torch's
own event list: each device kernel with its ms, and each synchronous host
op with its thread, interval, autograd sequence number and the kernels
linked to it by correlation id; :func:`kernel_group` names the group a
kernel's device time counts under.  ``analysis.round_profile`` reads a
phase's device time with it, and ``chip_smoke.py`` its profiles.
"""
from __future__ import annotations

#: (substring of a kernel's name, its group), first match wins
GROUPS = (("flash_attn", "flash_attention (port)"),
          ("ssd_", "ssd_chunk_intra (port)"),
          ("rolling_mm_fwd", "rolling_mm_fwd (port)"),
          ("rolling_mm_dx", "rolling_mm_dx (port)"),
          ("masked_sgd", "masked_sgd_inplace (port)"),
          ("fillin_agg", "fillin_agg_inplace (port)"),
          ("sgd_inplace", "sgd_inplace (port)"),
          ("distribution", "random draws (masks)"),
          ("convolve", "cuDNN convolutions"),
          ("fprop", "cuDNN convolutions"),
          ("dgrad", "cuDNN convolutions"),
          ("wgrad", "cuDNN convolutions"),
          ("genericTranspose", "cuDNN layout (transpose, scale)"),
          ("scaleTensor", "cuDNN layout (transpose, scale)"),
          ("gemm", "cuBLAS gemm (bmm, addmm)"),
          ("elementwise", "elementwise"),
          ("reduce", "reductions"),
          ("Memcpy", "copies"), ("Memset", "fills"))


def kernel_group(name):
    """The group of the kernel ``name`` (``GROUPS``), else "other"."""
    for key, group in GROUPS:
        if key in name:
            return group
    return "other"


class Trace:
    """What the port reads of a ``torch.profiler`` profile, taken from
    its raw kineto events with the rules of torch's own event list: each
    device kernel with its ms, and each synchronous host op with its
    thread, interval, autograd sequence number and the kernels linked to
    it by correlation id.  Torch's list (``key_averages()``, ``events()``)
    makes a Python object and a tree for every host op first, which took
    8-30 s of host time for each full-width round's profile (PERF.md
    section 6); this reads the same fields at a small fraction of that
    (``tools/trace_probe.py`` holds the two against each other)."""

    #: host ops torch's list leaves out (``profiler_util._filter_name``)
    SKIP = frozenset(("[memory]", "[OutOfMemory]",
                      "profiler::_record_function_enter",
                      "profiler::_record_function_enter_new",
                      "profiler::_record_function_exit", "aten::is_leaf",
                      "aten::output_nr", "aten::_version"))

    def __init__(self, prof):
        from torch.autograd import DeviceType
        self._device, self._host = [], []
        for e in prof.profiler.kineto_results.events():
            kind = e.device_type()
            if kind == DeviceType.CUDA:
                self._device.append(e)
            elif kind == DeviceType.CPU:
                self._host.append(e)
        self._device = [e for e in self._device if self._kept(e)]
        # (name, ms) of every device kernel
        self.kernels = [(e.name(), (e.end_ns() - e.start_ns()) / 1e6)
                        for e in self._device]
        self._ops = None

    def _kept(self, e):
        return e.name() not in self.SKIP and not getattr(
            e, "is_hidden_event", lambda: False)()

    def _index(self):
        """The host ops by thread, built on first use: a profile read only
        for its kernels (``device``) never pays for them."""
        if self._ops is not None:
            return
        linked = {}                # correlation id -> [(name, ms)]
        for e, k in zip(self._device, self.kernels):
            if e.linked_correlation_id() > 0:
                linked.setdefault(e.linked_correlation_id(), []).append(k)
        self._calls = {}           # host op name -> count, async ones too
        self._ops = {}             # thread -> ops by (start, -end)
        for e in self._host:
            if not self._kept(e):
                continue
            name = e.name()
            self._calls[name] = self._calls.get(name, 0) + 1
            if e.is_async() or e.start_thread_id() != e.end_thread_id():
                continue
            # kernels hang on the host op whose own correlation id they
            # name, where that op links to nothing itself
            kern = (linked.get(e.correlation_id(), [])
                    if e.linked_correlation_id() == 0 else [])
            self._ops.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), -e.end_ns(), name, e.sequence_nr(), kern))
        for ops in self._ops.values():
            ops.sort(key=lambda o: (o[0], o[1]))

    def calls(self, name):
        """How many host ops are named ``name``."""
        self._index()
        return self._calls.get(name, 0)

    def device(self, skip=()):
        """``(name, device ms, count)`` of every kernel name, leaving out
        those in ``skip`` (a profiler range shows up on the device too, as
        an annotation), and their device ms summed by group."""
        ms, n = {}, {}
        for name, t in self.kernels:
            if name not in skip:
                ms[name] = ms.get(name, 0.0) + t
                n[name] = n.get(name, 0) + 1
        kern = [(name, t, n[name]) for name, t in ms.items() if t > 0]
        groups = {}
        for name, t, _ in kern:
            g = kernel_group(name)
            groups[g] = groups.get(g, 0.0) + t
        return kern, groups

    def roots(self, test):
        """The synchronous host ops whose ``(name, sequence number)``
        passes ``test``, each as ``(thread, index)``."""
        self._index()
        return [(t, i) for t, ops in self._ops.items()
                for i, o in enumerate(ops) if test(o[2], o[3])]

    def tree(self, root):
        """The host op ``root`` and every op inside its interval on its
        thread: its children, theirs and so on."""
        t, i = root
        ops = self._ops[t]
        end = -ops[i][1]
        yield ops[i]
        for j in range(i + 1, len(ops)):
            if ops[j][0] >= end:
                break
            if -ops[j][1] <= end:
                yield ops[j]

    def host_ms(self, name):
        """The host ms of the synchronous ops named ``name``, summed."""
        self._index()
        return sum(-o[1] - o[0] for ops in self._ops.values()
                   for o in ops if o[2] == name) / 1e6
