"""Op census of a torch program: collective bytes, op counts, bytes moved,
peak live memory (the torch counterpart of ``repro.analysis.hlo``).

The JAX package parses the compiled XLA HLO text of a step.  Eager torch
has no such text; what stands in for it is a census of the program
itself, taken by a ``TorchDispatchMode`` over every aten op it runs
(:class:`OpCensus`).  It works on ``meta`` tensors (shapes only, nothing
allocated: the one-card dry-run) as on real ones, and records per op:

  * its name (the overload packet, e.g. ``mm``, ``index_put_``);
  * its FLOPs, by the formulas of ``torch.utils.flop_counter``'s registry
    (what ``FlopCounterMode`` counts: the matrix products mm / bmm /
    addmm / baddbmm and convolutions, no elementwise work);
  * the bytes of its tensor inputs plus its tensor outputs (a view op,
    which moves nothing, counts none);
  * the live tensor bytes after it: every storage seen (arguments
    tracked up front, op outputs as they appear) counts until its last
    tensor is freed, so ``peak_bytes`` is the largest sum of live storages
    during the run, arguments included;
  * collectives: ops of the ``c10d`` / ``_c10d_functional`` namespaces,
    their output bytes by kind.  One card runs none.

:func:`op_census` keeps the JAX function's keys: ``dot`` = mm / bmm /
addmm / baddbmm, ``scatter`` = index_put / index_add / scatter*,
``gather`` = index / index_select / gather / embedding, ``sort`` = sort /
argsort / topk, ``convolution``.  ``while`` and ``fusion`` are always 0:
eager torch runs each loop iteration's ops and fuses nothing.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import Counter, defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# aten op names (trailing "_" of in-place forms dropped) per census key
_CENSUS = {
    "dot": ("mm", "bmm", "addmm", "baddbmm"),
    "scatter": ("index_put", "index_add", "scatter", "scatter_add", "scatter_reduce"),
    "gather": ("index", "index_select", "gather", "embedding"),
    "sort": ("sort", "argsort", "topk"),
    "convolution": ("convolution",),
    "fusion": (),
    "while": (),
}

# c10d op names -> the HLO collective kinds of ``repro.analysis.hlo``
_COLLECTIVE_KINDS = {
    "all_gather": "all-gather", "all_gather_into_tensor": "all-gather",
    "_allgather_base": "all-gather", "allgather": "all-gather",
    "all_reduce": "all-reduce", "allreduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "_reduce_scatter_base": "reduce-scatter",
    "reduce_scatter": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall": "all-to-all", "alltoall_base": "all-to-all",
    "send": "collective-permute", "recv": "collective-permute",
    "broadcast": "all-gather",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x, out: list) -> list:
    """The tensors of an op's arguments or results, or of a step's
    arguments (nested sequences, named tuples and dicts); a faster walk than
    the general pytree one."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


class OpCensus(TorchDispatchMode):
    """Count a program's aten ops while it runs (``with OpCensus() as c:``).

    ``track(tree)`` registers tensors that live across the whole run (the
    step's arguments) before it starts.  Fields after the run: ``ops``
    (a Counter of op names), ``flops``, ``bytes`` (input + output bytes summed over
    ops), ``peak_bytes`` / ``live_bytes`` (live storages), ``collectives``
    (kind -> [count, output bytes])."""

    def __init__(self):
        super().__init__()
        self.ops: Counter = Counter()
        self.flops = 0
        self.bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.collectives: dict = defaultdict(lambda: [0, 0])
        # storage key -> [bytes, {tensor id: weak reference}]
        self._storages: dict = {}

    def _see(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        rec = self._storages.get(key)
        if rec is None:
            rec = self._storages[key] = [st.nbytes(), {}]
            self.live_bytes += rec[0]
        tid = id(t)
        if tid not in rec[1]:
            rec[1][tid] = weakref.ref(t, lambda _, key=key, tid=tid: self._free(key, tid))

    def _free(self, key, tid) -> None:
        rec = self._storages.get(key)
        if rec is None:
            return
        rec[1].pop(tid, None)
        if not rec[1]:
            self.live_bytes -= rec[0]
            del self._storages[key]

    def track(self, tree) -> None:
        for t in _tensors(tree, []):
            self._see(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        self.ops[name] += 1
        count = flop_registry.get(packet)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        outs = _tensors(out, [])
        if not func.is_view:   # a view moves no bytes
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs), outs[:]))
        if func.namespace in ("c10d", "_c10d_functional"):
            kind = _COLLECTIVE_KINDS.get(name.rstrip("_"), name)
            self.collectives[kind][0] += 1
            self.collectives[kind][1] += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._see(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out


def count_step(step, args) -> OpCensus:
    """Run ``step(*args)`` once under an :class:`OpCensus`, ``args``
    tracked as live throughout.  On ``meta`` arguments nothing is
    allocated or computed."""
    census = OpCensus()
    census.track(args)
    with census:
        step(*args)
    return census


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def summary(self) -> dict:
        return {
            "total_bytes": self.total_bytes,
            **{f"{k}_bytes": v for k, v in sorted(self.bytes_by_kind.items())},
            **{f"{k}_count": v for k, v in sorted(self.count_by_kind.items())},
        }


def collective_stats(census: OpCensus) -> CollectiveStats:
    """Output bytes and counts of every collective the census saw, by kind."""
    return CollectiveStats({k: v[1] for k, v in census.collectives.items()},
                           {k: v[0] for k, v in census.collectives.items()})


def op_census(census: OpCensus, ops=("fusion", "dot", "convolution", "scatter",
                                     "gather", "sort", "while")) -> dict:
    """Op counts under the JAX census's keys (see the module docstring)."""
    by_name: Counter = Counter()
    for name, n in census.ops.items():
        by_name[name.rstrip("_")] += n
    return {op: sum(by_name[n] for n in _CENSUS[op]) for op in ops}
