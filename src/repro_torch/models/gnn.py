"""GNN model family: EGNN, SchNet, GraphSAGE, GraphCast (torch port of
``repro.models.gnn``).

Message passing gathers node rows by edge (``h[senders]``) and sums the
messages into their receivers with ``index_add_`` (the JAX
``segment_sum``).  Functional, as the JAX package is: the parameters are
a tree of tensors in the JAX layout (``encoder`` / ``decoder`` /
``edge_encoder`` MLPs, ``layers`` stacked ``[L, ...]`` under ``_flatten2``
names such as ``"phi_e/w0"``), so :func:`load_jax_params` carries a JAX
tree across unchanged.

Batch formats (numpy from the JAX package's generators, or tensors):
  * full graph   — {x:[N,F], senders:[E], receivers:[E], (pos:[N,3]),
                    (edge_feat:[E,4]), labels:[N]}
  * molecules    — the same arrays with a leading batch axis; the JAX
                   package vmaps the forward over it, the port runs the
                   batch as one disjoint graph (edges offset by b * n) and
                   reshapes the logits to [B, n, C] (each node's incoming
                   messages are the same set in the same order)
  * minibatch    — {seed_x:[B,F], layer_x: per-hop [B, W_h, F]} blocks from
                   the fan-out sampler; aggregation is a reshape-mean

The aggregation is ``index_add_`` (:func:`_agg_dense`).  On a mesh the
parameters are DTensors placed by :func:`param_specs`
(:func:`place_params`), gathered whole for the forward.  ``remat``
checkpoints each layer (``torch.utils.checkpoint``).

The sharded path is the one of a batch placed on the mesh in use: its
leaves DTensors, placed by the JAX package's specs (``configs.gnn_family``:
node arrays over the data axes when they divide them, edges over data x
model, graphsage's minibatch over every axis, molecules by graph) or whole
on every rank.  Such a batch runs split (:class:`SplitGraph`): each
rank takes its chunk over every axis of the nodes, edges, seeds or graphs
(slicing what its placement left whole), so each piece of work is done on
one rank.  A layer gathers the node rows whole over the mesh before its
gathers by edge (the backward reduce-scatters their gradients), and the
messages of a rank's edges are summed into the node rows by a
reduce-scatter (the backward gathers their gradients).  Each rank's loss
is its share of the global mean, the parameters' gradients partial sums
over every axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.engine.streaming import resolve_device
from repro_torch.models.parallel import P, chunk_range, current_mesh, shard_tensor
from repro_torch.models.transformer import remat


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str = "gnn"
    arch: str = "graphsage"          # egnn | schnet | graphsage | graphcast
    n_layers: int = 2
    d_hidden: int = 128
    d_in: int = 128                  # input feature dim
    n_classes: int = 64              # classification head width
    aggregator: str = "mean"         # graphsage: mean; graphcast: sum
    # schnet
    n_rbf: int = 300
    cutoff: float = 10.0
    # graphcast
    d_edge: int = 4                  # raw edge-feature dim (displacement+len)
    dtype: Any = torch.float32
    remat: bool = False              # rematerialize layer bodies (big graphs)
    min_tp_dim: int = 512            # only tp-split hidden dims >= this

    def validate(self) -> None:
        if self.arch not in ("egnn", "schnet", "graphsage", "graphcast"):
            raise ValueError(f"unknown GNN arch {self.arch!r}")


def _mlp_shapes(d_in, d_hidden, d_out, t, depth=2):
    if depth == 1:
        return {"w0": ((d_in, d_out), t), "b0": ((d_out,), t)}
    return {
        "w0": ((d_in, d_hidden), t), "b0": ((d_hidden,), t),
        "w1": ((d_hidden, d_out), t), "b1": ((d_out,), t),
    }


def _mlp(p, x, act=F.silu):
    h = x @ p["w0"] + p["b0"]
    if "w1" in p:
        h = act(h) @ p["w1"] + p["b1"]
    return h


# ---------------------------------------------------------------------------
# Shapes and parameters
# ---------------------------------------------------------------------------
def shapes(cfg: GNNConfig) -> dict:
    """The parameter tree of (shape, dtype) leaves, as the JAX ``shapes``."""
    t = cfg.dtype
    d = cfg.d_hidden
    L = cfg.n_layers
    out: dict = {"encoder": _mlp_shapes(cfg.d_in, d, d, t)}
    if cfg.arch == "egnn":
        layer = {
            "phi_e": _mlp_shapes(2 * d + 1, d, d, t),
            "phi_x": _mlp_shapes(d, d, 1, t),
            "phi_h": _mlp_shapes(2 * d, d, d, t),
        }
    elif cfg.arch == "schnet":
        layer = {
            "filter": _mlp_shapes(cfg.n_rbf, d, d, t),
            "in_dense": _mlp_shapes(d, d, d, t, depth=1),
            "out_dense": _mlp_shapes(d, d, d, t),
        }
    elif cfg.arch == "graphsage":
        layer = {"w_self": ((d, d), t), "w_nbr": ((d, d), t), "b": ((d,), t)}
    else:  # graphcast interaction network
        layer = {
            "edge_mlp": _mlp_shapes(3 * d, d, d, t),
            "node_mlp": _mlp_shapes(2 * d, d, d, t),
        }
    out["layers"] = {k: ((L, *s), dt) for k, (s, dt) in _flatten2(layer).items()}
    out["decoder"] = _mlp_shapes(d, d, cfg.n_classes, t)
    if cfg.arch == "graphcast":
        out["edge_encoder"] = _mlp_shapes(cfg.d_edge, d, d, t)
    return out


def _flatten2(nested: dict) -> dict:
    """{'phi_e': {'w0': ...}} -> {'phi_e/w0': ...} (keeps stacks simple)."""
    out = {}
    for k, v in nested.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                out[f"{k}/{k2}"] = v2
        else:
            out[k] = v
    return out


def _unflatten2(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        if "/" in k:
            a, b = k.split("/", 1)
            out.setdefault(a, {})[b] = v
        else:
            out[k] = v
    return out


def _is_shape_leaf(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)


def param_specs(cfg: GNNConfig, dp=("data",), tp="model", tp_size=16) -> dict:
    """Partition specs of the parameter tree (the JAX ``param_specs``): the
    last (output) dim over ``tp`` when ``tp_size`` divides it and it is at
    least ``cfg.min_tp_dim``; the stacked layer dim stays whole."""
    del dp

    def spec_for(shape: tuple, stacked: bool) -> P:
        spec = [None] * len(shape)
        if shape and shape[-1] % tp_size == 0 and shape[-1] >= cfg.min_tp_dim:
            spec[-1] = tp
        if stacked:
            spec[0] = None
        return P(*spec)

    def rec(sub, stacked):
        return {k: rec(v, stacked or k == "layers") if not _is_shape_leaf(v)
                else spec_for(v[0], stacked) for k, v in sub.items()}

    return rec(shapes(cfg), False)


def place_params(params: dict, cfg: GNNConfig, mesh) -> dict:
    """``params`` (whole on every rank) as DTensor leaves on the ``("data",
    "model")`` ``mesh``, each placed by :func:`param_specs` (each rank
    keeps its slice), requiring grad."""
    specs = param_specs(cfg, ("data",), "model", mesh["model"].size())

    def rec(p, s):
        if isinstance(p, dict):
            return {k: rec(p[k], s[k]) for k in p}
        return shard_tensor(p.detach(), mesh, s).requires_grad_()

    return rec(params, specs)


def _whole(params: dict, partial: bool = False) -> dict:
    """The tree with each DTensor leaf gathered whole over its mesh.  When
    every rank computes the whole model, a leaf's gradient is the same on
    each and goes back to the leaf's placement as a slice; with
    ``partial`` (each rank computes its share of the loss, :class:`SplitGraph`)
    the gradients are partial sums, reduced back to the placement."""
    def rec(p):
        if isinstance(p, dict):
            return {k: rec(v) for k, v in p.items()}
        if not isinstance(p, DTensor):
            return p
        whole = [Replicate()] * p.device_mesh.ndim
        grad = [Partial()] * p.device_mesh.ndim if partial else whole
        return p.redistribute(p.device_mesh, whole).to_local(grad_placements=grad)

    return rec(params)


def init(cfg: GNNConfig, generator: torch.Generator | None = None, device=None) -> dict:
    """Random parameters by the JAX ``init`` rule: a leaf whose own key
    starts with "b" is zeros, every other normal * 1/sqrt(fan_in) with
    fan_in = shape[-2] (so the stacked layer biases, keyed "phi_e/b0" and
    the like, are drawn with fan_in = L, as in the JAX package).  Drawn in
    f32 on ``device`` (default CUDA; raises without a card unless "cpu")
    from ``generator`` (seeded 0 when None); the draws differ from JAX's.
    The leaves require grad."""
    dev = resolve_device(device)
    cfg.validate()
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def build(tree):
        out = {}
        for name, v in tree.items():
            if not _is_shape_leaf(v):
                out[name] = build(v)
                continue
            shape, dt = v
            if name.startswith("b"):
                w = torch.zeros(shape, dtype=dt, device=dev)
            else:
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                w = (torch.randn(shape, generator=generator, device=dev)
                     / math.sqrt(max(fan_in, 1))).to(dt)
            out[name] = w.requires_grad_()
        return out

    return build(shapes(cfg))


def init_abstract(cfg: GNNConfig) -> dict:
    """The parameter tree of :func:`init` as ``meta`` tensors that require
    grad (the JAX ``init_abstract``): shapes and dtypes, nothing allocated."""
    cfg.validate()

    def build(tree):
        return {name: build(v) if not _is_shape_leaf(v) else
                torch.empty(v[0], dtype=v[1], device="meta").requires_grad_()
                for name, v in tree.items()}

    return build(shapes(cfg))


def load_jax_params(params, cfg: GNNConfig, device=None) -> dict:
    """A JAX parameter tree (numpy leaves, e.g. ``jax.tree.map(np.asarray,
    repro.models.gnn.init(cfg, key))``) as the port's tree on ``device``
    (default CUDA), leaves requiring grad; the tree must match
    :func:`shapes`."""
    dev = resolve_device(device)
    want = shapes(cfg)

    def build(p, w, path):
        if _is_shape_leaf(w):
            if tuple(np.shape(p)) != w[0]:
                raise ValueError(f"{path}: shape {np.shape(p)}, the config's {w[0]}")
            t = torch.from_numpy(np.array(p, dtype=np.float32))
            return t.to(dev, w[1]).requires_grad_()
        if not isinstance(p, dict) or set(p) != set(w):
            got = sorted(p) if isinstance(p, dict) else "leaf"
            raise ValueError(f"{path or 'params'}: keys {got}, the config's {sorted(w)}")
        return {k: build(p[k], w[k], f"{path}/{k}" if path else k) for k in w}

    return build(params, want, "")


# ---------------------------------------------------------------------------
# Message-passing primitives
# ---------------------------------------------------------------------------
def _agg_dense(messages, receivers, n_nodes, kind="sum"):
    """Sum (or mean) of the messages [E, d] into their receivers [E] ->
    [n_nodes, d]; a node that receives nothing gets 0."""
    s = messages.new_zeros((n_nodes, messages.shape[1])).index_add(0, receivers, messages)
    if kind == "mean":
        cnt = torch.zeros(n_nodes, dtype=torch.float32, device=messages.device).index_add(
            0, receivers, torch.ones(receivers.shape[0], device=messages.device))
        s = s / cnt.clamp_min(1.0)[:, None]
    return s


class SplitGraph:
    """One rank's share of a batch placed on ``mesh`` (see the module
    docstring): :meth:`rows` takes this rank's chunk over every mesh axis
    (the first outermost), :meth:`full` gathers node rows whole, :meth:`agg`
    sums a rank's messages into its node rows, :meth:`sum_all` sums a
    value over every rank."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.names = list(mesh.mesh_dim_names)
        self.coord = mesh.get_coordinate()

    def rows(self, t) -> torch.Tensor:
        """This rank's chunk of dim 0 of ``t`` over every axis: the local
        shard of a DTensor split over a prefix of the axes, cut further
        over the axes its placement leaves whole."""
        if isinstance(t, DTensor):
            done = {i for i, pl in enumerate(t.placements) if pl.is_shard(0)}
            t = t.to_local()
        else:
            done = set()
        lo, hi = 0, t.shape[0]
        for i in range(self.mesh.ndim):
            if i not in done:
                a, b = chunk_range(hi - lo, self.mesh.size(i), self.coord[i])
                lo, hi = lo + a, lo + b
        return t[lo:hi]

    def full(self, h: torch.Tensor, n: int) -> torch.Tensor:
        """Every rank's node rows ``h`` gathered whole [n, ...]; the
        backward sums the gradient over the ranks and keeps this rank's
        rows."""
        k = self.mesh.ndim
        shape = (n, *h.shape[1:])
        d = DTensor.from_local(h, self.mesh, [Shard(0)] * k, run_check=False,
                               shape=torch.Size(shape),
                               stride=tuple(math.prod(shape[i + 1:]) for i in range(len(shape))))
        return d.redistribute(self.mesh, [Replicate()] * k).to_local(
            grad_placements=[Partial()] * k)

    def agg(self, messages, receivers, n_nodes, kind="sum"):
        """The sum (or mean) of this rank's messages [E_local, d] into their
        receivers, summed over every rank and split into node rows: this
        rank's rows [N_local, d]."""
        part = messages.new_zeros((n_nodes, messages.shape[1])).index_add(0, receivers, messages)
        if kind == "mean":
            cnt = messages.new_zeros(n_nodes).index_add(
                0, receivers, messages.new_ones(receivers.shape[0]))
            part = torch.cat([part, cnt[:, None]], dim=1)
        k = self.mesh.ndim
        out = DTensor.from_local(part, self.mesh, [Partial()] * k, run_check=False
                                 ).redistribute(self.mesh, [Shard(0)] * k).to_local()
        if kind == "mean":
            out, cnt = out[:, :-1], out[:, -1]
            out = out / cnt.clamp_min(1.0)[:, None]
        return out

    def sum_all(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over every rank (no gradient)."""
        import torch.distributed as dist

        t = t.detach().clone()
        for i in range(self.mesh.ndim):
            dist.all_reduce(t, group=self.mesh.get_group(i))
        return t


def split_of(batch: dict) -> SplitGraph | None:
    """The :class:`SplitGraph` of the mesh in use when ``batch``'s leaves
    are DTensors (placed by the bundle's specs), else None."""
    mesh = current_mesh()
    first = next(iter(batch.values()))
    first = first[0] if isinstance(first, (list, tuple)) else first
    if mesh is None or not isinstance(first, DTensor):
        return None
    return SplitGraph(mesh)


def rbf_expand(dist, n_rbf, cutoff):
    centers = torch.linspace(0.0, cutoff, n_rbf, device=dist.device)
    gamma = 10.0 / cutoff
    return torch.exp(-gamma * (dist[:, None] - centers) ** 2)


# ---------------------------------------------------------------------------
# Per-arch layer bodies (x/h: [N, d]; senders/receivers: [E] int64)
# ---------------------------------------------------------------------------
# ``full(h)`` gives the node rows whole for the gathers by edge (the
# identity on one device, where h is whole); ``n`` the whole node count.
def _same(h):
    return h


def egnn_layer(lp, h, pos, senders, receivers, agg=_agg_dense, full=_same, n=None):
    n = h.shape[0] if n is None else n
    hf, pf = full(h), full(pos)
    diff = pf[senders] - pf[receivers]
    d2 = torch.sum(diff * diff, dim=-1, keepdim=True)
    m = _mlp(lp["phi_e"], torch.cat([hf[senders], hf[receivers], d2], -1))
    coef = _mlp(lp["phi_x"], m)
    # normalized coordinate update keeps equivariance + numerics
    upd = agg(diff * coef / torch.sqrt(d2 + 1.0), receivers, n, "mean")
    pos = pos + upd
    magg = agg(m, receivers, n, "sum")
    h = h + _mlp(lp["phi_h"], torch.cat([h, magg], -1))
    return h, pos


def schnet_layer(lp, h, pos, senders, receivers, n_rbf, cutoff, agg=_agg_dense, full=_same,
                 n=None):
    n = h.shape[0] if n is None else n
    pf = full(pos)
    dist = torch.sqrt(torch.sum((pf[senders] - pf[receivers]) ** 2, -1) + 1e-9)
    w = _mlp(lp["filter"], rbf_expand(dist, n_rbf, cutoff))
    x = full(_mlp(lp["in_dense"], h))
    m = x[senders] * w
    out = agg(m, receivers, n, "sum")
    return h + _mlp(lp["out_dense"], out), pos


def graphsage_layer(lp, h, senders, receivers, kind="mean", agg=_agg_dense, full=_same,
                    n=None):
    n = h.shape[0] if n is None else n
    nbr = agg(full(h)[senders], receivers, n, kind)
    return torch.relu(h @ lp["w_self"] + nbr @ lp["w_nbr"] + lp["b"])


def graphcast_layer(lp, h, e, senders, receivers, agg=_agg_dense, full=_same, n=None):
    n = h.shape[0] if n is None else n
    hf = full(h)
    e = e + _mlp(lp["edge_mlp"], torch.cat([e, hf[senders], hf[receivers]], -1))
    out = agg(e, receivers, n, "sum")
    h = h + _mlp(lp["node_mlp"], torch.cat([h, out], -1))
    return h, e


# ---------------------------------------------------------------------------
# Forward passes and the loss
# ---------------------------------------------------------------------------
def _tensor(x, device) -> torch.Tensor:
    return x.to(device) if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x)).to(device)


def forward(params: dict, batch: dict, cfg: GNNConfig) -> torch.Tensor:
    """Node logits [N, n_classes] for a (full or sampled-flat) graph; on a
    batch placed on the mesh in use (:func:`split_of`), this rank's node
    rows."""
    sp = split_of(batch)
    params = _whole(params, partial=sp is not None)
    dev = params["encoder"]["w0"].device
    pick = (lambda k: sp.rows(batch[k])) if sp is not None else (lambda k: batch[k])
    x = _tensor(pick("x"), dev).to(cfg.dtype)
    senders = _tensor(pick("senders"), dev).long()
    receivers = _tensor(pick("receivers"), dev).long()
    h = _mlp(params["encoder"], x)
    if sp is None:
        agg, kw = _agg_dense, {}
    else:
        N = batch["x"].shape[0]
        agg, kw = sp.agg, {"full": lambda t: sp.full(t, N), "n": N}
    L = cfg.n_layers
    # one unbind per stacked leaf: its backward stacks the L gradients into
    # one [L, ...] tensor, where L selects would each write a zero-filled one
    per_layer = {k: v.unbind(0) for k, v in params["layers"].items()}
    layers = [_unflatten2({k: v[i] for k, v in per_layer.items()}) for i in range(L)]

    def run(body, carry):
        for lp in layers:
            carry = remat(body, lp, *carry) if cfg.remat else body(lp, *carry)
        return carry

    if cfg.arch == "egnn":
        pos = _tensor(pick("pos"), dev).to(cfg.dtype)
        h, _ = run(lambda lp, h, pos: egnn_layer(lp, h, pos, senders, receivers, agg, **kw),
                   (h, pos))
    elif cfg.arch == "schnet":
        pos = _tensor(pick("pos"), dev).to(cfg.dtype)
        h, _ = run(lambda lp, h, pos: schnet_layer(lp, h, pos, senders, receivers,
                                                   cfg.n_rbf, cfg.cutoff, agg, **kw), (h, pos))
    elif cfg.arch == "graphsage":
        (h,) = run(lambda lp, h: (graphsage_layer(lp, h, senders, receivers,
                                                  cfg.aggregator, agg, **kw),), (h,))
    else:  # graphcast
        if "edge_feat" in batch:
            ef = _tensor(pick("edge_feat"), dev).to(cfg.dtype)
        else:
            ef = torch.zeros((senders.shape[0], cfg.d_edge), dtype=cfg.dtype, device=dev)
        e = _mlp(params["edge_encoder"], ef)
        h, _ = run(lambda lp, h, e: graphcast_layer(lp, h, e, senders, receivers, agg, **kw),
                   (h, e))
    return _mlp(params["decoder"], h)


def forward_minibatch(params: dict, batch: dict, cfg: GNNConfig) -> torch.Tensor:
    """Fan-out minibatch forward (GraphSAGE-style; regular blocks).

    batch: seed_x [B, F]; layer_x: list of [B, W_h, F] with W_h =
    prod(fanouts[:h+1]); layer_mask: list of [B, W_h] validity.
    Aggregation bottom-up: hop H-1 aggregates hop H by a reshape-mean over
    the fan-out."""
    params = _whole(params)
    dev = params["encoder"]["w0"].device
    hops = [batch["seed_x"]] + list(batch["layer_x"])
    masks = [None] + list(batch.get("layer_mask", [None] * (len(hops) - 1)))
    hs = [_mlp(params["encoder"], _tensor(h, dev).to(cfg.dtype)) for h in hops]
    layers = params["layers"]
    for li in range(len(hops) - 1):
        lp = {k: v[li] for k, v in layers.items()}
        new_hs = []
        for depth in range(len(hs) - 1):
            cur, child = hs[depth], hs[depth + 1]
            B = cur.shape[0]
            W_cur = 1 if cur.dim() == 2 else cur.shape[1]
            child3 = child.reshape(B, W_cur, -1, child.shape[-1])
            m = masks[depth + 1]
            if m is not None:
                m3 = _tensor(m, dev).reshape(B, W_cur, -1, 1).to(cfg.dtype)
                nbr = (child3 * m3).sum(2) / m3.sum(2).clamp_min(1.0)
            else:
                nbr = child3.mean(2)
            if cur.dim() == 2:
                nbr = nbr[:, 0]
            new_hs.append(torch.relu(cur @ lp["w_self"] + nbr @ lp["w_nbr"] + lp["b"]))
        hs = new_hs
    return _mlp(params["decoder"], hs[0])


def _molecule_forward(params: dict, batch: dict, cfg: GNNConfig) -> torch.Tensor:
    """Logits [B, n, C] of a batch of small graphs ([B, n, F] nodes, [B, e]
    graph-local edges), run as one disjoint graph."""
    dev = params["encoder"]["w0"].device
    x = _tensor(batch["x"], dev)
    B, n = x.shape[:2]
    off = (torch.arange(B, device=dev) * n)[:, None]
    flat = {"x": x.reshape(B * n, -1),
            "senders": (_tensor(batch["senders"], dev).long() + off).reshape(-1),
            "receivers": (_tensor(batch["receivers"], dev).long() + off).reshape(-1)}
    if "pos" in batch:
        flat["pos"] = _tensor(batch["pos"], dev).reshape(B * n, -1)
    if "edge_feat" in batch:
        flat["edge_feat"] = _tensor(batch["edge_feat"], dev).reshape(-1, cfg.d_edge)
    return forward(params, flat, cfg).reshape(B, n, -1)


def _local_batch(batch: dict, sp: SplitGraph) -> dict:
    """This rank's seeds (or graphs) of a minibatch or molecule batch:
    every leaf's chunk over every axis, as plain tensors."""
    return {k: [sp.rows(t) for t in v] if isinstance(v, (list, tuple)) else sp.rows(v)
            for k, v in batch.items()}


def loss_fn(params, batch, cfg: GNNConfig) -> torch.Tensor:
    """The JAX ``loss_fn``: node classification (cross entropy over labels
    >= 0) on a full or sampled graph, or, for a molecule batch, the
    node-mean readout against float targets (squared error).  On a batch
    placed on the mesh in use (:func:`split_of`) this rank's share of the
    global loss, whose sum over every rank is the loss."""
    sp = split_of(batch)
    params = _whole(params, partial=sp is not None)
    dev = params["encoder"]["w0"].device
    x = batch["seed_x"] if "seed_x" in batch else batch["x"]
    graphs = "seed_x" in batch or (x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)) == 3
    if sp is not None and graphs:
        # seeds or graphs are independent: this rank's run alone
        batch = _local_batch(batch, sp)
    if "seed_x" in batch:
        logits = forward_minibatch(params, batch, cfg)
    elif graphs:  # batched small graphs (molecule)
        logits = _molecule_forward(params, batch, cfg).mean(dim=1)  # graph-level readout
    else:
        logits = forward(params, batch, cfg)
    labels = _tensor(batch["labels"] if sp is None or graphs else sp.rows(batch["labels"]), dev)
    if labels.is_floating_point():
        # regression (molecule targets)
        sq = (logits[..., 0] - labels) ** 2
        if sp is None:
            return torch.mean(sq)
        return torch.sum(sq) / sp.sum_all(torch.tensor(float(sq.shape[0]), device=dev))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = labels >= 0
    count = mask.sum() if sp is None else sp.sum_all(mask.sum())
    return torch.sum((logz - gold) * mask) / count.clamp_min(1)
