"""The production meshes, the bundles' shardings and the per-rank census.

  * every cell's ``shardings(shape, multi_pod)`` equals the JAX package's
    leaf for leaf (36 cells x the single- and multi-pod meshes; the LM
    parameters keyed as the port's ``named_parameters()``, the stacked
    layer axis dropped), covering parameters, AdamW moments, batch,
    cache and outputs; every split dim divides by its mesh axes and each
    spec tree has one spec per argument leaf (``test_arch_smoke``'s
    check, ported);
  * ``make_production_mesh`` on placeholder groups of 256 and 512 ranks:
    shapes and names; a ``ValueError`` on 4 ranks;
  * the census on placeholder (2, 2) and (2, 2, 2) meshes (one spawned
    process each): a DTensor argument counts by its local shard, the
    gathers' collective bytes and the FSDP gathers of one layer equal
    their closed forms, ``_wrap_tensor_autograd`` is not a collective,
    and a pure data-parallel step's matmul FLOPs per rank are one
    device's over dp;
  * the dry-run rows of a few pod cells (single and multi) are "ok", with
    a collective term priced by the links each group spans.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)

import math

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_mesh_serve_ranks as SR
from repro.configs import get_arch as j_get_arch
from repro_torch.analysis import roofline as RF
from repro_torch.analysis.hlo import _group_ranks
from repro_torch.configs import arch_ids, get_arch
from repro_torch.models.parallel import P
from repro_torch.optim.adamw import AdamWState

CELLS = [(a, s) for a in arch_ids() for s in get_arch(a).shape_ids()]


def _norm(entry):
    return entry[0] if isinstance(entry, tuple) and len(entry) == 1 else entry


def _leaves(tree, path=()) -> dict:
    """path -> spec entries of a tree of specs (either package's)."""
    if isinstance(tree, (JP, P)):
        return {path: tuple(_norm(e) for e in tree)}
    if hasattr(tree, "_fields"):
        return {k: v for f in tree._fields for k, v in _leaves(getattr(tree, f), path + (f,)).items()}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _leaves(sub, path + (i,)).items()}
    raise TypeError(type(tree))


def _jax_by_port_name(leaves: dict, cfg) -> dict:
    """JAX LM leaves with each stacked layer leaf given to every port layer
    of its stack (``layers.<i>.<name>``), the layer axis dropped."""
    nd = cfg.n_dense_layers if cfg.is_moe else 0
    out = {}
    for path, spec in leaves.items():
        stack = next((i for i, p in enumerate(path) if p in ("layers", "dense_layers")), None)
        if stack is None:
            out[path] = spec
            continue
        assert spec[0] is None, (path, spec)
        layers = range(nd) if path[stack] == "dense_layers" else range(nd, cfg.n_layers)
        for i in layers:
            out[path[:stack] + (f"layers.{i}.{path[stack + 1]}",)] = spec[1:]
    return out


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_shardings_equal_jax(arch, shape, multi_pod):
    b = get_arch(arch)
    got = _leaves(b.shardings(shape, multi_pod))
    want = _leaves(j_get_arch(arch).shardings(shape, multi_pod))
    if b.family == "lm":
        want = _jax_by_port_name(want, b.config)
    assert set(got) == set(want)
    for path in got:
        assert got[path] == want[path], (path, got[path], want[path])
    if b.cells[shape].kind == "train":
        assert isinstance(b.shardings(shape, multi_pod)[0][1], AdamWState)


SIZES = {"data": 16, "model": 16, "pod": 2}


def _arg_leaves(tree, path=()):
    if hasattr(tree, "shape"):
        return {path: tuple(tree.shape)}
    if hasattr(tree, "_fields"):
        return {k: v for f in tree._fields for k, v in _arg_leaves(getattr(tree, f),
                                                                   path + (f,)).items()}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _arg_leaves(sub, path + (key,)).items()}
    return {k: v for i, sub in enumerate(tree) for k, v in _arg_leaves(sub, path + (i,)).items()}


@pytest.mark.parametrize("arch", arch_ids())
def test_shardings_match_args(arch):
    """Each argument leaf has a spec no longer than its shape, and every
    split dim divides by the product of its axes' sizes."""
    b = get_arch(arch)
    for multi_pod in (False, True):
        for shape in b.shape_ids():
            args = _arg_leaves(b.abstract_args(shape, multi_pod))
            specs = _leaves(b.shardings(shape, multi_pod)[0])
            assert set(args) == set(specs), (arch, shape)
            for path, dims in args.items():
                spec = specs[path]
                assert len(spec) <= len(dims), (arch, shape, path, spec, dims)
                for dim, axis in zip(dims, spec):
                    if axis is None:
                        continue
                    axes = axis if isinstance(axis, tuple) else (axis,)
                    total = math.prod(SIZES[a] for a in axes)
                    assert dim % total == 0, (arch, shape, path, dim, axes)


@pytest.mark.parametrize("n", [256, 512, 4])
def test_make_production_mesh(n):
    got = SR.alone("production_meshes", n)
    if n == 4:
        assert got[False][0] == got[True][0] == "ValueError"
        assert "256" in got[False][1] and "512" in got[True][1]
        return
    single, multi = got[False], got[True]
    if n == 256:
        assert single[:3] == ((16, 16), ("data", "model"), (0, 0))
        assert multi[0] == "ValueError"
    else:
        assert multi[:3] == ((2, 16, 16), ("pod", "data", "model"), (0, 0, 0))
        assert single[0] == "ValueError"


@pytest.fixture(scope="module", params=[((2, 2), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data", "model"))],
                ids=["2x2", "2x2x2"])
def census(request):
    shape, names = request.param
    return SR.alone("census_invariants", shape, names)


def test_dtensor_argument_counts_by_its_local_shard(census):
    g = census["gather"]
    # the [1024, 512] f32 argument split over every mesh dim (dim 0 over
    # ("pod", "data") on (2, 2, 2)): 1 / ranks of it
    assert g["local_bytes"] == 1024 * 512 * 4 // math.prod(census["shape"])
    assert g["live_after_track"] == g["local_bytes"] + 512 * 64 * 4


def test_gathered_storage_is_freed_with_its_alias(census):
    """A gathered tensor and the alias the functional collective hands back
    (``_wrap_tensor_autograd``) are one storage, freed with the last of
    them: four gathers in turn peak as one does, plus the sum's two
    [1024, 64] products, and the run ends with the arguments alone."""
    g = census["gather"]
    assert g["many_live_end"] == g["live_after_track"]
    assert g["many_peak"] <= g["peak"] + 2 * 1024 * 64 * 4


def test_gather_collectives_closed_form(census):
    g = census["gather"]
    k = len(census["shape"])
    # rank 0's shard [512, 256] gathered whole [1024, 512]: one all-gather
    # per mesh dim the shard is split over (2 on (2, 2), 3 on (2, 2, 2)
    # where dim 0 splits over ("pod", "data")), each writing its output
    count, nbytes = g["collectives"]["all-gather"]
    assert set(g["collectives"]) == {"all-gather"}
    assert count == k
    if k == 2:
        assert nbytes == 1024 * 256 * 4 + 1024 * 512 * 4
    else:
        assert nbytes == 512 * 256 * 4 + 1024 * 256 * 4 + 1024 * 512 * 4
    assert g["ops"].get("_wrap_tensor_autograd", 0) == k
    # matmul on the gathered [1024, 512] by [512, 64]
    assert g["flops"] == 2 * 1024 * 512 * 64
    # each collective's group is recorded by its ranks (rank 0 in each)
    assert sum(v[0] for v in g["groups"].values()) == k
    for key in g["groups"]:
        assert "(0," in key


def test_fsdp_gathers_closed_form(census):
    """One layer's weights under the training layout: each weight split
    over the data axes on its FSDP dim is all-gathered over them (its
    "model" shard kept); the output bytes are the whole-over-data,
    model-local tensor, once per data dim gathered over."""
    f = census["fsdp"]
    dp, tp = f["dp"], f["tp"]
    k = len(census["shape"]) - 1           # data dims
    want_bytes, want_count = 0, 0
    for name, (shape, spec) in f["shapes"].items():
        spec = eval(spec, {"P": P})
        if not any(e is not None and e != "model" for e in spec):
            continue                        # nothing over the data axes
        local = list(shape)
        for d, e in enumerate(spec):
            if e == "model" or (isinstance(e, tuple) and "model" in e):
                local[d] //= tp
        # the gathers of each data dim in turn: the outer dim's first
        size = math.prod(local) * 4
        if k == 1:
            want_bytes += size
        else:
            want_bytes += size // 2 + size
        want_count += k
    assert f["collectives"]["all-gather"] == [want_count, want_bytes]


def test_data_parallel_flops_per_rank(census):
    ranked, one, dp = census["dp_flops"]
    assert one % dp == 0 and ranked == one // dp


def test_link_bandwidth_by_node():
    assert RF.link_bw(range(8)) == RF.NVLINK_BW
    assert RF.link_bw(range(16)) == RF.IB_BW
    assert RF.link_bw((0, 16, 32)) == RF.IB_BW


def test_collective_without_a_group_raises():
    # a collective the census cannot price by its group is an error, not IB
    with pytest.raises(ValueError, match="no process group"):
        _group_ranks((torch.empty(4), 4))


POD_CELLS = [("graphsage-reddit", "minibatch_lg", "single"), ("mind", "serve_p99", "multi"),
             ("egnn", "molecule", "multi"), ("qwen2-7b", "decode_32k", "single")]


def test_pod_rows_are_ok():
    rows = SR.alone("pod_rows", POD_CELLS, timeout=280)
    for (arch, shape, mesh), row in zip(POD_CELLS, rows):
        assert row["status"] == "ok"
        assert (row["arch"], row["shape"]) == (arch, shape)
        assert row["mesh"] == {"single": "h100x16x16", "multi": "h100x2x16x16"}[mesh]
        assert row["chips"] == (256 if mesh == "single" else 512)
        assert row["collective_bytes"] > 0 and row["t_collective_s"] > 0
        # every collective of the production meshes crosses nodes
        assert math.isclose(row["t_collective_s"], row["collective_bytes"] / RF.IB_BW,
                            rel_tol=1e-9)
        assert row["fits_80gb"] and np.isfinite(row["peak_mem_gb"])
