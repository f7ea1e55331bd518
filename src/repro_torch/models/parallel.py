"""Data and tensor parallelism on a ``("data", "model")`` device mesh, or
the multi-pod ``("pod", "data", "model")`` one: the port's counterpart of
the JAX package's ``Mesh`` + ``NamedSharding`` + GSPMD, on
``torch.distributed.tensor`` (DTensor).

One process per device (gloo on the CPU, NCCL on a card).  The pieces:

  * :class:`PartitionSpec` (``P``): the JAX package's partition specs,
    one entry per tensor dim (``None``, a mesh axis name, or a tuple of
    names), and :func:`placements`, the DTensor placements a spec gives
    on a mesh (``Shard(dim)`` on each mesh dim a spec entry names,
    ``Replicate()`` elsewhere).  :func:`shard_tensor` places a tensor that
    every rank holds whole by its spec without communication: each rank
    keeps the slice the spec selects, the same slice ``jax.device_put``
    gives a device of the same mesh coordinate.
  * :class:`MeshParallel`: how one rank computes on the mesh.  Parameters
    are stored by their spec (the FSDP dim over ``"data"``, the tensor
    parallel dim over ``"model"``).  :meth:`MeshParallel.weight` gathers a
    stored parameter over the data axes and keeps (or gathers) its
    ``"model"`` shard: the FSDP all-gather, whose backward is the
    reduce-scatter of the gradient over the data axes.  The data axes are
    ``("data",)``, or ``("pod", "data")`` on the multi-pod mesh, where a
    gather or a sum over them runs over each of the two dims in turn (pod
    outermost, as a JAX spec entry ``("pod", "data")`` splits).
    Activations are local tensors with a known layout: the batch rows over
    the data axes, and over
    ``"model"`` either whole on every rank or split by heads, hidden units
    or experts.  :meth:`enter` and :meth:`exit` are Megatron's two
    operators at the edges of a split region: ``enter`` is the identity
    whose backward sums the gradient over ``"model"``, ``exit`` sums the
    partial results over ``"model"`` and passes the gradient through.
    Every op between them is an ordinary torch op on local tensors, so no
    op falls back to replicating a tensor behind the caller's back.
  * :func:`use_mesh` / :func:`current_mesh`: the mesh in use (the
    counterpart of ``jax.set_mesh``), read by the GNN's sharded
    aggregation and by the bundles' steps on a mesh.
  * :func:`place_tree`: a tree of whole (or ``meta``) tensors placed by a
    tree of specs, each leaf a DTensor holding this rank's slice (a 0-dim
    leaf, replicated by its spec ``P()``, stays a plain tensor).

On a model axis of one rank nothing is split: the layers run the
one-device code on the gathered weights, with no ``enter`` / ``exit``.  A
mesh dim of one rank moves nothing (no redistribute, no copy, forward or
backward), so on a 1 x 1 mesh every local tensor is the whole tensor, and
the arithmetic and the allocations are the one-device path's.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

POD, DATA, MODEL = "pod", "data", "model"
MESH_AXES = ((DATA, MODEL), (POD, DATA, MODEL))


class PartitionSpec(tuple):
    """A partition spec: one entry per tensor dim, ``None`` (whole), a mesh
    axis name, or a tuple of names (split over each in turn, the first
    outermost).  Dims past the last entry are whole.  A tuple of one name
    is that name, as in JAX, so a spec equals the JAX ``PartitionSpec`` of
    the same entries taken as a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec, mesh: DeviceMesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where entry d names it, else ``Replicate()``.  A tensor dim
    split over several axes must name them in the mesh's order (DTensor
    splits over the outer mesh dim first, as the JAX spec does)."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not in the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def shard_tensor(t: torch.Tensor, mesh: DeviceMesh, spec) -> DTensor:
    """``t`` (whole on every rank) placed by ``spec`` as ``distribute_tensor``
    places it, without communication: each rank keeps its slice, a copy
    (so ``t`` can be freed) unless the spec leaves ``t`` whole here."""
    mine = local_slice(t, spec, mesh)
    if mine.numel() != t.numel():
        mine = mine.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(mine, mesh, placements(spec, mesh), run_check=False,
                              shape=t.shape, stride=t.stride())


def chunk_range(n: int, size: int, index: int) -> tuple[int, int]:
    """The rows ``[lo, hi)`` of ``n`` that chunk ``index`` of ``size``
    holds (``torch.chunk``'s rule, which DTensor shards by)."""
    step = -(-n // size)
    return min(index * step, n), min((index + 1) * step, n)


def local_slice(a, spec, mesh: DeviceMesh):
    """The slice of the whole array ``a`` that this rank holds under
    ``spec`` (numpy or torch; no copy)."""
    coord = mesh.get_coordinate()
    names = list(mesh.mesh_dim_names)
    index = [slice(None)] * len(a.shape)
    for d, entry in enumerate(spec):
        lo, hi = 0, a.shape[d]
        for axis in _axes(entry):
            i = names.index(axis)
            size = mesh.size(i)
            sub_lo, sub_hi = chunk_range(hi - lo, size, coord[i])
            lo, hi = lo + sub_lo, lo + sub_hi
        index[d] = slice(lo, hi)
    return a[tuple(index)]


_MESHES: list[DeviceMesh] = []


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh):
    """Make ``mesh`` the one in use inside the block (``jax.set_mesh``)."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def current_mesh() -> DeviceMesh | None:
    """The innermost mesh of :func:`use_mesh`, or None."""
    return _MESHES[-1] if _MESHES else None


def mesh_parallel(rows=None) -> "MeshParallel | None":
    """The mesh in use (:func:`use_mesh`) as a :class:`MeshParallel`, None
    on one device; the batch rows split over the data axes where ``rows``
    (a batch leaf) is a DTensor sharded on dim 0 over one of them."""
    mesh = current_mesh()
    if mesh is None:
        return None
    split = isinstance(rows, DTensor) and any(
        pl.is_shard(0) for pl, name in zip(rows.placements, mesh.mesh_dim_names)
        if name != MODEL)
    return MeshParallel(mesh, batch_split=split)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh`` (its current card on a CUDA mesh)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _mesh_dim(mesh: DeviceMesh, name: str) -> int:
    return list(mesh.mesh_dim_names).index(name)


class MeshParallel:
    """One rank's view of a ``("data", "model")`` or ``("pod", "data",
    "model")`` mesh (see the module docstring).  ``data_axes`` are the
    mesh's axes but ``"model"``; ``dp`` / ``tp`` the sizes of the data axes
    (their product) and of ``"model"``, ``dp_rank`` / ``tp_rank`` this
    rank's coordinates (``dp_rank`` flattened over the data axes, the
    first outermost).  ``batch_split``: whether the batch rows are split
    over the data axes (False when a cell's batch is whole on every rank,
    as a JAX spec entry ``None`` leaves it)."""

    def __init__(self, mesh: DeviceMesh, batch_split: bool = True):
        names = tuple(mesh.mesh_dim_names)
        if names not in MESH_AXES:
            raise ValueError(f"a mesh has axes ('data', 'model') or ('pod', 'data', 'model'), "
                             f"not {names}")
        self.mesh = mesh
        self.data_axes = names[:-1]
        self.data = mesh[self.data_axes] if len(self.data_axes) > 1 else mesh[DATA]
        self.model = mesh[MODEL]
        self.dp, self.tp = self.data.size(), self.model.size()
        coord = mesh.get_coordinate()
        self.dp_rank = 0
        for axis in self.data_axes:
            i = names.index(axis)
            self.dp_rank = self.dp_rank * mesh.size(i) + coord[i]
        self.tp_rank = coord[-1]
        self.batch_split = batch_split

    # -- parameters -------------------------------------------------------
    def split(self, p: DTensor) -> bool:
        """Whether the stored ``p`` is split over ``"model"`` (never on a
        model axis of one rank: the code then runs as on one device)."""
        return self.tp > 1 and p.placements[_mesh_dim(self.mesh, MODEL)].is_shard()

    def weight(self, p: DTensor, keep_tp: bool = True) -> torch.Tensor:
        """The local tensor this rank computes with: ``p`` whole over the
        data axes and, with ``keep_tp``, still split over ``"model"`` as
        stored (else whole).  Its gradient is a partial sum over the data
        axes (each rank's rows), reduced back to ``p``'s placement by the
        backward (a reduce-scatter, or an all-reduce for a dim the data
        axes do not split).  A mesh dim of one rank keeps the stored
        placement both ways (its one rank holds the whole dim), so nothing
        is redistributed over it.  Take a weight once per use in the
        graph: each take's gradient is a DTensor, and two are added out of
        place."""
        m = _mesh_dim(self.mesh, MODEL)
        n = self.mesh.ndim
        compute, grad = [Replicate()] * n, [Partial()] * n
        compute[m] = grad[m] = p.placements[m] if keep_tp else Replicate()
        for i, size in enumerate(self.mesh.shape):
            if size == 1:
                compute[i] = grad[i] = p.placements[i]
        return p.redistribute(self.mesh, compute).to_local(grad_placements=grad)

    def model_range(self, n: int) -> tuple[int, int]:
        """The rows ``[lo, hi)`` of a dim of ``n`` split over ``"model"``
        that this rank holds."""
        return chunk_range(n, self.tp, self.tp_rank)

    # -- activations ------------------------------------------------------
    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Identity forward; the backward sums the gradient over
        ``"model"`` (``x`` is whole on every rank and feeds a split
        region, whose ranks each see part of its gradient)."""
        d = DTensor.from_local(x, self.model, [Replicate()], run_check=False)
        return d.to_local(grad_placements=[Partial()])

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        """Sum the partial results ``y`` of a split region over
        ``"model"``; the gradient passes through."""
        d = DTensor.from_local(y, self.model, [Partial()], run_check=False)
        return d.redistribute(self.model, [Replicate()]).to_local()

    def gather_model(self, y: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """Concatenate the ``"model"`` chunks ``y`` of a dim of ``n`` (whole
        on every rank after); the backward keeps this rank's chunk."""
        return self._gather(self.model, y, dim, n, Replicate())

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """All ranks' rows of ``x`` (dim 0) over the data axes, in rank
        order: the global batch.  The backward sums the gradient over the
        data axes and keeps this rank's rows."""
        return self._gather(self.data, x, 0, x.shape[0] * self.dp, Partial())

    def seq_split(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's ``"model"`` chunk of dim ``dim`` of ``x`` (whole and
        the same on every rank of ``"model"``): a slice, no communication;
        the backward gathers the gradient's chunks whole (Megatron's
        sequence-parallel split of the layer carry)."""
        if self.tp == 1:
            return x
        d = DTensor.from_local(x, self.model, [Replicate()], run_check=False)
        return d.redistribute(self.model, [Shard(dim)]).to_local(grad_placements=[Shard(dim)])

    def _gather(self, sub: DeviceMesh, y, dim: int, n: int, grad_pl) -> torch.Tensor:
        if sub.size() == 1:  # the whole already; no copy either way
            return y
        dim = dim % y.dim()
        shape = list(y.shape)
        shape[dim] = n
        k = sub.ndim
        d = DTensor.from_local(y, sub, [Shard(dim)] * k, run_check=False,
                               shape=torch.Size(shape), stride=_contiguous(shape))
        return d.redistribute(sub, [Replicate()] * k).to_local(grad_placements=[grad_pl] * k)

    def sum_data(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the data axes (no gradient)."""
        t = t.detach().clone()
        for i in range(self.data.ndim):
            dist.all_reduce(t, group=self.data.get_group(i))
        return t

    def model_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced by ``op`` over ``"model"`` in place (no gradient;
        the flash-decode combine across the ranks of a split cache)."""
        dist.all_reduce(t, op=op, group=self.model.get_group())
        return t


def _contiguous(shape) -> tuple[int, ...]:
    return tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, or ``t`` itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def place_tree(tree, specs, mesh: DeviceMesh):
    """``tree`` (dicts, lists, tuples and named tuples of whole tensors,
    ``meta`` ones too) placed by ``specs`` (the same structure, a
    :class:`PartitionSpec` per leaf) on ``mesh``: each leaf a DTensor of
    this rank's slice (:func:`local_slice`, a copy of its own unless the
    spec leaves the leaf whole), an
    ``nn.Parameter`` where the leaf was one and requiring grad where it
    did; a 0-dim leaf stays as it is (``P()``: whole on every rank)."""
    if isinstance(tree, dict):
        return {k: place_tree(tree[k], specs[k], mesh) for k in tree}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        items = [place_tree(t, s, mesh) for t, s in zip(tree, specs)]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    if tree.dim() == 0:
        return tree
    mine = local_slice(tree.detach(), specs, mesh)
    if mine.numel() != tree.numel():
        mine = mine.clone(memory_format=torch.contiguous_format)
    d = DTensor.from_local(mine, mesh, placements(specs, mesh), run_check=False,
                           shape=tree.shape, stride=tree.stride())
    if isinstance(tree, torch.nn.Parameter):
        return torch.nn.Parameter(d)
    return d.requires_grad_(tree.requires_grad)
