"""FLOPs, bytes, collective bytes and peak memory of eager PyTorch.

The counterpart of ``repro/analysis/hlo_cost.py`` (its per-instruction
FLOP and byte rules, and ``hlo.py``'s ring model of a collective's bytes)
and of XLA's ``memory_analysis()``, over eager execution: a
``TorchDispatchMode`` that sees every aten op a function runs, forward
and backward (the autograd engine hands the mode to its worker thread on
the card), on ``meta`` and on ``cuda`` tensors alike::

    with Counter(args=(params, batch)) as c:
        fed.round(params, batch, 0, offsets=offsets)
    c.report()["flops_by_class"], c.peak_bytes

What it counts:

* FLOPs by rate class (``analysis.roofline.PEAK_FLOPS``).  Products and
  convolutions take ``torch.utils.flop_counter``'s formulas (2 x
  prod(out) x K); f32 products count as ``float32`` (TF32 stays off in
  the port), bf16 ones as ``bfloat16``.  Every other op that computes
  counts one FLOP per output element, as ``hlo_cost.py`` counts an
  elementwise instruction; data movement (copies, casts, concatenation,
  indexing, fills) counts none.
* Bytes: each aten op that is not a view costs the bytes of its tensor
  inputs plus its outputs (what eager PyTorch moves: the port has no
  fusion); an op that only writes its first argument (``copy_``,
  ``fill_``, ``zero_``, the random fills) does not read it; views,
  ``narrow`` and allocations cost none.
* Declared kernel costs.  A kernel wrapper of ``repro_torch.kernels``
  reports its launch's ``(flops, hbm_bytes, rate_class)`` (its ``cost()``)
  through ``repro_torch.accounting.declare`` on ``meta`` and on ``cuda``
  tensors while a counter is active, so a kernel counts its own work,
  never its plain version's (on CPU tensors the wrappers run the plain
  versions, which are counted as aten ops).
* Collective bytes: ``sharding/spmd.py``'s ``all_gather``,
  ``all_reduce_sum`` and ``all_reduce_max`` report the ring model's bytes
  (``accounting.ring_bytes``, ``hlo_cost.py`` ``_collective_bytes``)
  through ``accounting.collective``: an all-gather ``out * (g - 1) /
  g``, an all-reduce ``2 * in * (g - 1) / g``, by kind and count.
* Peak live bytes: every new storage an op makes is live until it is
  freed (a weakref finalizer on the storage; a view shares its base's
  storage).  ``argument_bytes`` are the storages handed in as ``args``
  (params, optimizer state, batch); ``peak_bytes`` is their sum plus the
  largest sum of live new storages.  One rule follows the autograd
  engine: it sums two gradients of one tensor in place, into a summand it
  holds the last reference to, but out of place while any dispatch mode
  (this counter too) is on.  So a sum inside a backward whose summand's
  storage is freed before the next op is counted as the engine makes it
  without a mode: the freed summand's bytes never lie beside the sum.
"""
from __future__ import annotations

import collections
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.accounting import ACTIVE

#: ops that move or make data and compute nothing (no FLOPs); matched on
#: the op's name without its overload and trailing underscore
MOVEMENT = frozenset((
    "copy", "clone", "_to_copy", "cat", "stack", "index", "index_select",
    "gather", "scatter", "scatter_add", "index_add", "index_copy",
    "index_put", "_index_put_impl", "slice_scatter", "select_scatter",
    "as_strided_scatter", "diagonal_scatter", "fill", "zero", "empty",
    "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "new_zeros", "new_ones", "new_full", "zeros", "zeros_like", "ones",
    "ones_like", "full", "full_like", "scalar_tensor", "arange", "repeat",
    "embedding", "embedding_dense_backward", "constant_pad_nd", "roll",
    "flip", "_unsafe_index", "_unsafe_index_put", "masked_scatter",
    "normal", "uniform", "bernoulli", "random", "rand", "randn", "randint",
    "randperm", "exponential", "lift_fresh", "lift_fresh_copy",
    "_local_scalar_dense", "_unsafe_view", "alias", "set", "resize",
    "split_with_sizes_copy", "unbind_copy", "view_copy", "narrow_copy",
    "permute_copy", "t_copy", "transpose_copy", "expand_copy", "detach",
    "tril_indices", "triu_indices", "eye"))
#: ops that overwrite their first argument without reading it
WRITE_ONLY = frozenset(("copy", "fill", "zero", "normal", "uniform",
                        "bernoulli", "random", "exponential"))


def _flop_formula(func):
    """``torch.utils.flop_counter``'s formula for ``func``, also for an
    in-place variant (``baddbmm_``, ``addmm_``: the registry holds the
    functional op, and the in-place one does the same products)."""
    from torch.utils.flop_counter import flop_registry
    packet = func.overloadpacket
    if packet in flop_registry:
        return flop_registry[packet]
    name = packet.__name__
    if name.endswith("_"):
        functional = getattr(torch.ops.aten, name[:-1], None)
        return flop_registry.get(functional)
    return None


def _base_name(func) -> str:
    return func.overloadpacket.__name__.rstrip("_") or \
        func.overloadpacket.__name__


_META_OUT: Dict[tuple, object] = {}
_NO_KEY = object()
_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.memory_format, torch.layout)


def _arg_key(a):
    if isinstance(a, torch.Tensor):
        if a.device.type != "meta":
            return _NO_KEY
        return (tuple(a.shape), a.stride(), a.dtype)
    if isinstance(a, _PLAIN):
        return a
    if isinstance(a, (list, tuple)):
        ks = tuple(_arg_key(x) for x in a)
        return _NO_KEY if any(k is _NO_KEY for k in ks) else (type(a), ks)
    return _NO_KEY


def _record(out, args):
    """What to remember of a meta op's output: ``(shape, stride, dtype)``
    of each tensor (``is_list``, metas), or None when an output shares
    storage with an input (then the op always runs)."""
    outs = out if isinstance(out, (list, tuple)) else [out]
    if not all(isinstance(t, torch.Tensor) for t in outs):
        return None
    ins = {_key(t) for t in _tensors(args)}
    if any(_key(t) in ins for t in outs):
        return None
    return (isinstance(out, (list, tuple)), type(out),
            [(tuple(t.shape), t.stride(), t.dtype) for t in outs])


def _replay(hit):
    many, kind, metas = hit
    ts = [torch.empty_strided(shape, stride, dtype=dtype, device="meta")
          for shape, stride, dtype in metas]
    return kind(ts) if many else ts[0]


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class Counter(TorchDispatchMode):
    """Counts what runs under it (see the module docstring).  ``args``:
    the tensors (any nesting of dicts, lists, tuples) that exist before
    and count as arguments.  ``device``: the device type whose tensors
    count (default: the first argument's, else every tensor)."""

    def __init__(self, args=(), device=None):
        super().__init__()
        ts = _tensors(args)
        if device is None and ts:
            device = ts[0].device.type
        self.device = None if device is None else torch.device(device).type
        self.flops_by_class: Dict[str, float] = collections.defaultdict(float)
        self.dot_flops = 0.0
        self.bytes = 0.0
        self.coll_by_kind: Dict[str, float] = collections.defaultdict(float)
        self.coll_counts: Dict[str, int] = collections.defaultdict(int)
        self.kernels: Dict[str, int] = collections.Counter()
        seen = {}
        for t in ts:
            if self._counts(t):
                seen[_key(t)] = t.untyped_storage().nbytes()
        self._args = set(seen)
        self.argument_bytes = sum(seen.values())
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_live_bytes = 0
        # an engine's gradient sum whose summands' fate is not known yet:
        # ([(storage key, nbytes)] of the summands it could reuse, the live
        # bytes with the sum and its summands)
        self._pending = None

    # -- what counts --------------------------------------------------------

    def _counts(self, t):
        return self.device is None or t.device.type == self.device

    @property
    def peak_bytes(self):
        return self.argument_bytes + self.peak_live_bytes

    @property
    def coll_bytes(self):
        return float(sum(self.coll_by_kind.values()))

    def declared(self, name, flops, nbytes, klass, dot):
        """A kernel launch's declared work (``accounting.declare``)."""
        self.kernels[name] += 1
        self.flops_by_class[klass] += flops
        self.bytes += nbytes
        if dot:
            self.dot_flops += flops

    def collective(self, kind, nbytes):
        """A collective's ring-model bytes (``accounting.collective``)."""
        self.coll_by_kind[kind] += nbytes
        self.coll_counts[kind] += 1

    def _free(self, key):
        n = self._live.pop(key, None)
        if n is not None:
            self.live_bytes -= n

    def _track(self, t, peak=True):
        key = _key(t)
        if key in self._live or key in self._args:
            return
        st = t.untyped_storage()
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        if peak:
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _engine_sum(self, func, ins, outs):
        """The summands of an out-of-place ``add`` run inside a backward
        that the engine could have summed into in place (live, contiguous,
        of the sum's shape and dtype), as ``[(storage key, nbytes)]``, or
        None for any other op."""
        if func is not torch.ops.aten.add.Tensor or len(outs) != 1 or \
                torch._C._current_graph_task_id() == -1:
            return None
        o = outs[0]
        keys = [(_key(t), self._live[_key(t)]) for t in ins
                if t.shape == o.shape and t.dtype == o.dtype
                and t.is_contiguous() and _key(t) in self._live]
        return keys or None

    def _settle(self):
        """Count a pending engine sum's peak once its summands' fate is
        known: less the largest summand freed since (the engine's in-place
        sum reuses it)."""
        if self._pending is None:
            return
        keys, both = self._pending
        self._pending = None
        freed = [n for k, n in keys if k not in self._live]
        self.peak_live_bytes = max(self.peak_live_bytes,
                                   both - max(freed, default=0))

    # -- the mode -----------------------------------------------------------

    def __enter__(self):
        ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        self._settle()
        ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._settle()
        kwargs = kwargs or {}
        key = self._meta_key(func, args, kwargs)
        hit = _META_OUT.get(key) if key is not None else None
        if hit:
            out = _replay(hit)
        else:
            out = func(*args, **kwargs)
            if key is not None:
                _META_OUT[key] = _record(out, args)
        self._account(func, args, kwargs, out)
        return out

    def _meta_key(self, func, args, kwargs):
        """A hashable key of a functional op's inputs on ``meta`` (shapes,
        strides, dtypes and the other arguments), or None (a view, an
        in-place op, an op on another device): meta kernels run in Python
        and dominate a plan's time, and a functional op's outputs depend on
        nothing else, so their metadata is remembered."""
        if self.device != "meta" or func.is_view or \
                func._schema.is_mutable:
            return None
        parts = [func]
        for a in (*args, *kwargs.items()):
            k = _arg_key(a)
            if k is _NO_KEY:
                return None
            parts.append(k)
        return tuple(parts)

    def _account(self, func, args, kwargs, out):
        ins = [t for t in _tensors((args, kwargs)) if self._counts(t)]
        outs = [t for t in _tensors(out) if self._counts(t)]
        if not ins and not outs:
            return
        name = _base_name(func)
        mutable = func._schema.is_mutable
        in_keys = {_key(t) for t in ins}
        aliased = outs and all(_key(t) in in_keys for t in outs)
        if func.is_view or (aliased and not mutable) or name in (
                "empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided", "_unsafe_view", "alias", "detach",
                "lift_fresh", "set", "resize", "_local_scalar_dense"):
            for t in outs:
                self._track(t)
            return
        read = ins[1:] if name in WRITE_ONLY and args and \
            isinstance(args[0], torch.Tensor) else ins
        self.bytes += sum(_nbytes(t) for t in read) + \
            sum(_nbytes(t) for t in outs)
        formula = _flop_formula(func)
        if formula is not None:
            f = formula(*args, **kwargs, out_val=out)
            first = next((t for t in ins if t.is_floating_point()), None)
            klass = ("bfloat16" if first is not None
                     and first.dtype == torch.bfloat16 else "float32")
            self.flops_by_class[klass] += f
            self.dot_flops += f
        elif name not in MOVEMENT:
            self.flops_by_class["float32"] += sum(t.numel() for t in outs)
        summands = self._engine_sum(func, ins, outs)
        for t in outs:
            self._track(t, peak=summands is None)
        if summands is not None:
            self._pending = (summands, self.live_bytes)

    def report(self) -> dict:
        """The counts as plain numbers."""
        return {
            "flops_by_class": dict(self.flops_by_class),
            "flops": float(sum(self.flops_by_class.values())),
            "dot_flops": self.dot_flops,
            "bytes": self.bytes,
            "coll_bytes": self.coll_bytes,
            "coll_by_kind": dict(self.coll_by_kind),
            "coll_counts": dict(self.coll_counts),
            "kernels": dict(self.kernels),
            "argument_bytes": self.argument_bytes,
            "peak_bytes": self.peak_bytes,
            "temp_bytes": self.peak_live_bytes,
        }
