"""The port's architecture bundles against the JAX package's, on the CPU.

The registry (ten archs, 36 cells and 4 skips with the same reasons), each
family's ``SHAPES``; every ``abstract_args`` leaf a ``meta`` tensor, the
batch and cache leaves equal to the JAX ``ShapeDtypeStruct``s key by key
(shape and dtype), the parameter element count per dtype equal; the GNN
``cfg_for_cell`` fields; ``smoke_batch`` from the same ``default_rng(0)``;
each arch's ``make_train_step`` (one AdamW step on the SMOKE config, the
JAX init carried across) against the JAX step's loss and grad norm at
1e-5 relative; ``smoke_step`` finite with JAX's output shapes; ``real_args``
holding the abstract leaves' shapes.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import dataclasses
from collections import Counter

import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.configs import gnn_family as j_gnn
from repro.configs import lm_family as j_lm
from repro.configs import recsys_family as j_rec
from repro.models import gnn as JG
from repro.models import recsys as JR
from repro.models import transformer as JT
import repro_torch.configs as C
from repro_torch.configs import gnn_family, lm_family, recsys_family
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T

CELLS = [(a, s) for a in C.arch_ids() for s in C.get_arch(a).shape_ids()]
TOL = 1e-5


def _dt(x) -> str:
    """A dtype's name in either package ("bfloat16", "int32", "bool")."""
    if isinstance(x, torch.dtype):
        return str(x).rsplit(".", 1)[-1]
    return np.dtype(x).name


def _leaves(tree, prefix=""):
    """(path, leaf) pairs of a nested dict / list / (named) tuple."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _per_dtype(tree) -> Counter:
    out: Counter = Counter()
    for _, x in _leaves(tree):
        out[_dt(x.dtype)] += int(np.prod(x.shape))
    return out


def test_registry_equals_jax():
    assert C.arch_ids() == JC.arch_ids() and len(C.arch_ids()) == 10
    n_cells = n_skips = 0
    for a in C.arch_ids():
        b, jb = C.get_arch(a), JC.get_arch(a)
        assert b.family == jb.family
        assert b.shape_ids() == jb.shape_ids()
        assert b.skip_shapes == jb.skip_shapes
        n_cells += len(b.cells)
        n_skips += len(b.skip_shapes)
    assert (n_cells, n_skips) == (36, 4) == (len(CELLS), 4)


@pytest.mark.parametrize("mods", [(lm_family, j_lm), (gnn_family, j_gnn),
                                  (recsys_family, j_rec)], ids=["lm", "gnn", "recsys"])
def test_shapes_equal_jax(mods):
    port, jax_mod = mods
    assert list(port.SHAPES) == list(jax_mod.SHAPES)
    for k, cell in port.SHAPES.items():
        j = jax_mod.SHAPES[k]
        assert (cell.shape_id, cell.kind, cell.meta) == (j.shape_id, j.kind, j.meta)
    assert recsys_family.N_CANDIDATES_ONLINE == j_rec.N_CANDIDATES_ONLINE
    assert recsys_family.N_CANDIDATES_RETRIEVAL == j_rec.N_CANDIDATES_RETRIEVAL


@pytest.mark.parametrize("arch,shape", CELLS)
def test_abstract_args_equal_jax(arch, shape):
    """Every leaf is a ``meta`` tensor; the batch / cache leaves equal the
    JAX ``ShapeDtypeStruct``s key by key; the parameters hold as many
    elements of each dtype as the JAX tree; the AdamW state (train cells) is
    an int32 step and f32 moments over the same elements."""
    args = C.get_arch(arch).abstract_args(shape)
    jargs = JC.get_arch(arch).abstract_args(shape, False)
    assert len(args) == len(jargs)
    for path, leaf in _leaves(args):
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "meta", path
    params, jparams = args[0], jargs[0]
    assert _per_dtype(params) == _per_dtype(jparams)
    rest, jrest = args[1:], jargs[1:]
    if len(args) == 3 and hasattr(args[1], "step"):   # train: the AdamW state
        opt, jopt = args[1], jargs[1]
        assert tuple(opt.step.shape) == () and opt.step.dtype == torch.int32
        for moments in (opt.m, opt.v):
            assert _per_dtype(moments) == Counter({"float32": sum(_per_dtype(params).values())})
        assert _per_dtype(jopt.m) == _per_dtype(opt.m)
        rest, jrest = args[2:], jargs[2:]
    got = dict(_leaves(rest))
    want = dict(_leaves(jrest))
    assert list(got) == list(want)
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert _dt(got[k].dtype) == _dt(want[k].dtype), k


@pytest.mark.parametrize("arch", sorted(C.GNN_CONFIGS))
def test_cfg_for_cell_equals_jax(arch):
    b, jb = C.get_arch(arch), JC.get_arch(arch)
    for shape in b.shape_ids():
        got = dataclasses.asdict(gnn_family.cfg_for_cell(b, shape))
        want = dataclasses.asdict(j_gnn.cfg_for_cell(jb, shape))
        shared = set(got) & set(want)
        assert shared >= {"d_in", "n_classes", "remat", "n_layers", "d_hidden", "arch"}
        for k in shared:
            if k == "dtype":
                assert _dt(got[k]) == _dt(want[k])
            else:
                assert got[k] == want[k], (shape, k)
        assert got["remat"] == (shape == "ogb_products")


@pytest.mark.parametrize("arch", C.arch_ids())
def test_smoke_batch_equals_jax(arch):
    got = C.get_arch(arch).smoke_batch(np.random.default_rng(0), device="cpu")
    want = JC.get_arch(arch).smoke_batch(np.random.default_rng(0))
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert _dt(got[k].dtype) == _dt(np.asarray(want[k]).dtype)


def _carried_params(bundle, jparams):
    """The JAX SMOKE init carried across as the port's parameter tree."""
    cfg = bundle.smoke_config
    host = jax.tree.map(np.asarray, jparams)
    if bundle.family == "lm":
        model = T.Transformer(cfg, device="cpu")
        T.load_jax_params(model, host)
        return dict(model.named_parameters())
    if bundle.family == "gnn":
        return G.load_jax_params(host, cfg, device="cpu")
    model = R.MIND(cfg, device="cpu")
    R.load_jax_params(model, host)
    return dict(model.named_parameters())


_FAMILY = {"lm": (lm_family, j_lm, JT), "gnn": (gnn_family, j_gnn, JG),
           "recsys": (recsys_family, j_rec, JR)}


@pytest.mark.parametrize("arch", C.arch_ids())
def test_train_step_matches_jax(arch):
    """Each family's ``make_train_step`` on the SMOKE config: two steps from
    the JAX init carried across, loss and grad norm within 1e-5 relative."""
    b, jb = C.get_arch(arch), JC.get_arch(arch)
    fam, jfam, jmodel = _FAMILY[b.family]
    jparams = jmodel.init(jb.smoke_config, jax.random.key(1))
    params = _carried_params(b, jparams)
    batch = b.smoke_batch(np.random.default_rng(0), device="cpu")
    jbatch = jb.smoke_batch(np.random.default_rng(0))
    if b.family == "recsys":
        keep = ("hist", "hist_mask", "user_feats", "target")
        batch = {k: batch[k] for k in keep}
        jbatch = {k: jbatch[k] for k in keep}
    step = fam.make_train_step(b.smoke_config)
    jstep = jax.jit(jfam.make_train_step(jb.smoke_config))
    opt, jopt = fam.OPT.init(params), jfam.OPT.init(jparams)
    for _ in range(2):
        params, opt, m = step(params, opt, batch)
        jparams, jopt, jm = jstep(jparams, jopt, jbatch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=TOL, err_msg=key)


@pytest.mark.parametrize("arch", C.arch_ids())
def test_smoke_step_is_finite(arch):
    b = C.get_arch(arch)
    out = b.smoke_step()(b.smoke_batch(np.random.default_rng(0), device="cpu"))
    cfg = b.smoke_config
    if b.family == "lm":
        shapes = {"loss": (), "logits_prefill": (2, cfg.vocab), "logits_decode": (2, cfg.vocab)}
    elif b.family == "gnn":
        shapes = {"loss": (), "logits": (24, cfg.n_classes)}
    else:
        shapes = {"loss": (), "scores": (8, 16)}
    assert {k: tuple(v.shape) for k, v in out.items()} == shapes
    for k, v in out.items():
        assert torch.isfinite(v).all(), k


@pytest.mark.parametrize("arch,shape", [("qwen2-7b", "decode_32k"), ("egnn", "molecule"),
                                        ("graphsage-reddit", "minibatch_lg"),
                                        ("mind", "retrieval_cand")])
def test_real_args_hold_the_abstract_leaves(arch, shape):
    """``real_args`` gives the abstract leaves' shapes and dtypes on the
    device, with ids inside their tables (a cut config keeps this cheap)."""
    b = C.get_arch(arch)
    if b.family == "lm":
        b.config = dataclasses.replace(b.smoke_config, n_layers=1)
        b.cells = {shape: dataclasses.replace(b.cells[shape], meta={"seq": 32, "batch": 2})}
    elif b.family == "recsys":
        b.config = b.smoke_config
    real = b.real_args(shape, device="cpu")
    abstract = b.abstract_args(shape)
    got, want = dict(_leaves(real)), dict(_leaves(abstract))
    assert list(got) == list(want)
    for k in got:
        assert got[k].device.type == "cpu", k
        assert (tuple(got[k].shape), got[k].dtype) == (tuple(want[k].shape), want[k].dtype), k
    out = b.step_fn(shape)(*real)
    for _, leaf in _leaves(out):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            assert torch.isfinite(leaf).all()
