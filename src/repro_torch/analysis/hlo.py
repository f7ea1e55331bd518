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
  * collectives: the ops of the ``c10d`` / ``_c10d_functional``
    namespaces named in ``_COLLECTIVE_KINDS``, their output bytes by kind
    and by the ranks of their process group (``collective_groups``), so
    the roofline can price each by the links its group spans.  One card
    runs none.

On a mesh (a step run as one rank of a process group, e.g. rank 0 of a
placeholder group of 256 ranks) the census is that rank's: a DTensor
argument or operand counts by its local shard, an op on DTensors by its
local tensors, and the aliases a functional collective hands back
(``_wrap_tensor_autograd``, ``wait_tensor``) share their input's storage
rather than count as a second one.

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
import torch.distributed as dist
from torch.distributed.tensor import DTensor
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

# ops that hand back their input under another tensor object: no new storage
_ALIASES = ("_wrap_tensor_autograd", "wait_tensor")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x, out: list) -> list:
    """The tensors of an op's arguments or results, or of a step's
    arguments (nested sequences, named tuples and dicts), a DTensor by its
    local shard; a faster walk than the general pytree one."""
    if isinstance(x, DTensor):
        out.append(x._local_tensor)
    elif isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _local(x):
    """``x`` with every DTensor replaced by its local shard (nested
    sequences and dicts), for counting an op on DTensors by its local work."""
    if isinstance(x, DTensor):
        return x._local_tensor
    if isinstance(x, (list, tuple)):
        return type(x)(_local(y) for y in x) if not hasattr(x, "_fields") else \
            type(x)(*(_local(y) for y in x))
    if isinstance(x, dict):
        return {k: _local(v) for k, v in x.items()}
    return x


def _group_ranks(args) -> tuple:
    """The global ranks of a collective's process group: a functional
    collective names its group by its last string argument, a ``c10d`` op
    passes the group object.  Raises when neither is there, so no
    collective goes unpriced."""
    for a in reversed(args):
        if isinstance(a, str):
            group = torch._C._distributed_c10d._resolve_process_group(a)
        elif isinstance(a, torch.ScriptObject) and \
                a._type().qualified_name().endswith(".ProcessGroup"):
            group = dist.ProcessGroup.unbox(a)
        else:
            continue
        return tuple(dist.get_process_group_ranks(group))
    raise ValueError(f"no process group among a collective's arguments {args!r}")


class OpCensus(TorchDispatchMode):
    """Count a program's aten ops while it runs (``with OpCensus() as c:``).

    ``track(tree)`` registers tensors that live across the whole run (the
    step's arguments) before it starts.  Fields after the run: ``ops``
    (a Counter of op names), ``flops``, ``bytes`` (input + output bytes summed over
    ops), ``peak_bytes`` / ``live_bytes`` (live storages), ``collectives``
    (kind -> [count, output bytes]) and ``collective_groups`` ((kind,
    group ranks) -> [count, output bytes])."""

    def __init__(self):
        super().__init__()
        self.ops: Counter = Counter()
        self.flops = 0
        self.bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.collectives: dict = defaultdict(lambda: [0, 0])
        self.collective_groups: dict = defaultdict(lambda: [0, 0])
        # storage key -> its group: [bytes, {tensor id: (weak reference,
        # the tensor's own storage key)}].  An alias's storage joins its
        # source's group; a key leaves the map when its last tensor dies
        # (its address may then be reused by a new storage), the group's
        # bytes when the group's last tensor dies.
        self._storages: dict = {}

    def _see(self, t: torch.Tensor, alias_of: torch.Tensor | None = None) -> None:
        own = t.untyped_storage()._cdata
        if alias_of is not None and own not in self._storages:
            group = self._storages.get(alias_of.untyped_storage()._cdata)
            if group is not None:
                self._storages[own] = group
        group = self._storages.get(own)
        if group is None:
            group = self._storages[own] = [t.untyped_storage().nbytes(), {}]
            self.live_bytes += group[0]
        tid = id(t)
        if tid not in group[1]:
            group[1][tid] = (weakref.ref(t, lambda _, g=group, tid=tid: self._free(g, tid)), own)

    def _free(self, group, tid) -> None:
        _, own = group[1].pop(tid, (None, None))
        if own is not None and not any(o == own for _, o in group[1].values()) \
                and self._storages.get(own) is group:
            del self._storages[own]
        if not group[1] and group[0] is not None:
            self.live_bytes -= group[0]
            group[0] = None

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
            self.flops += count(*_local(args), **_local(kwargs), out_val=_local(out))
        outs = _tensors(out, [])
        if not func.is_view:   # a view moves no bytes
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs), outs[:]))
        if func.namespace in ("c10d", "_c10d_functional"):
            kind = _COLLECTIVE_KINDS.get(name.rstrip("_"))
            if kind is not None:
                nbytes = sum(_nbytes(t) for t in outs)
                self.collectives[kind][0] += 1
                self.collectives[kind][1] += nbytes
                group = self.collective_groups[(kind, _group_ranks(args))]
                group[0] += 1
                group[1] += nbytes
        source = None
        if name in _ALIASES:
            ins = _tensors(args, [])
            source = ins[0] if ins else None
        for t in outs:
            self._see(t, source)
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
