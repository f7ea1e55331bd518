"""The port's GNN family against the JAX package, on the CPU.

The four archs (EGNN, SchNet, GraphSAGE, GraphCast) with the JAX init
carried across by ``load_jax_params``, on graphs from seeded numpy
generators: ``forward`` on a full graph, GraphSAGE's ``forward_minibatch``
on fan-out blocks with padding, and ``loss_fn`` with every gradient on
the full graph (labels < 0 masked), on the minibatch and on a molecule
batch (the JAX package vmaps it; the port runs it as one disjoint graph),
also with ``remat``: f32, atol = rtol = 1e-5.  Then the checks of
``tests/test_models.py``: EGNN's equivariance under a rotation and a
shift, and isolated nodes without NaN.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import egnn as j_egnn
from repro.configs import graphcast as j_graphcast
from repro.configs import graphsage_reddit as j_graphsage
from repro.configs import schnet as j_schnet
from repro.models import gnn as JG
from repro_torch.configs import GNN_CONFIGS
from repro_torch.models import gnn as G

JAX_SMOKE = {"egnn": j_egnn, "schnet": j_schnet, "graphsage-reddit": j_graphsage,
             "graphcast": j_graphcast}
TOL = 1e-5


def _carried(name, seed=0, **changes):
    jcfg = dataclasses.replace(JAX_SMOKE[name].SMOKE, **changes)
    tcfg = dataclasses.replace(GNN_CONFIGS[name].SMOKE, **changes)
    params = JG.init(jcfg, jax.random.key(seed))
    return jcfg, tcfg, params, G.load_jax_params(jax.tree.map(np.asarray, params), tcfg, "cpu")


def _graph(cfg, N=24, E=70, seed=1, labels=True):
    rng = np.random.default_rng(seed)
    b = {"x": rng.normal(size=(N, cfg.d_in)).astype(np.float32),
         "senders": rng.integers(0, N, E).astype(np.int32),
         "receivers": rng.integers(0, N, E).astype(np.int32),
         "pos": rng.normal(size=(N, 3)).astype(np.float32),
         "edge_feat": rng.normal(size=(E, 4)).astype(np.float32)}
    if labels:
        b["labels"] = rng.integers(0, cfg.n_classes, N).astype(np.int32)
        b["labels"][:4] = -1
    return b


def _molecules(cfg, B=5, n=7, e=12, seed=2):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(B, n, cfg.d_in)).astype(np.float32),
            "senders": rng.integers(0, n, (B, e)).astype(np.int32),
            "receivers": rng.integers(0, n, (B, e)).astype(np.int32),
            "pos": rng.normal(size=(B, n, 3)).astype(np.float32),
            "edge_feat": rng.normal(size=(B, e, 4)).astype(np.float32),
            "labels": rng.normal(size=(B,)).astype(np.float32)}


def _minibatch(cfg, B=6, fan=(4, 3), seed=3):
    rng = np.random.default_rng(seed)
    w1, w2 = fan[0], fan[0] * fan[1]
    masks = [rng.random((B, w1)) > 0.2, rng.random((B, w2)) > 0.3]
    masks[1][0] = False                                   # a seed's hop with no neighbour
    return {"seed_x": rng.normal(size=(B, cfg.d_in)).astype(np.float32),
            "layer_x": [rng.normal(size=(B, w, cfg.d_in)).astype(np.float32) for w in (w1, w2)],
            "layer_mask": masks,
            "labels": rng.integers(0, cfg.n_classes, B).astype(np.int32)}


def _jax_batch(b):
    return jax.tree.map(jnp.asarray, b)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _check_loss_and_grads(jcfg, tcfg, params, tparams, batch):
    lj, gj = jax.value_and_grad(JG.loss_fn)(params, _jax_batch(batch), jcfg)
    loss = G.loss_fn(tparams, batch, tcfg)
    leaves = _leaves(tparams)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    _close(loss, lj)
    want = _leaves(jax.tree.map(np.asarray, gj))
    assert set(want) == set(leaves)
    for name, g in zip(leaves, grads):
        _close(torch.zeros_like(leaves[name]) if g is None else g, want[name])


@pytest.mark.parametrize("name", list(JAX_SMOKE))
def test_forward_matches_jax(name):
    jcfg, tcfg, params, tparams = _carried(name)
    batch = _graph(tcfg)
    want = JG.forward(params, _jax_batch(batch), jcfg)
    with torch.no_grad():
        got = G.forward(tparams, batch, tcfg)
    assert got.shape == (24, tcfg.n_classes)
    _close(got, want)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", list(JAX_SMOKE))
def test_full_graph_loss_and_gradients_match_jax(name, remat):
    jcfg, tcfg, params, tparams = _carried(name, remat=remat)
    _check_loss_and_grads(jcfg, tcfg, params, tparams, _graph(tcfg))


@pytest.mark.parametrize("name", list(JAX_SMOKE))
def test_molecule_loss_and_gradients_match_jax(name):
    """A molecule batch (float targets, node-mean readout): JAX vmaps the
    forward over the graphs, the port runs them as one disjoint graph."""
    jcfg, tcfg, params, tparams = _carried(name, n_classes=1)
    _check_loss_and_grads(jcfg, tcfg, params, tparams, _molecules(tcfg))


def test_minibatch_forward_loss_and_gradients_match_jax():
    jcfg, tcfg, params, tparams = _carried("graphsage-reddit")
    batch = _minibatch(tcfg)
    with torch.no_grad():
        _close(G.forward_minibatch(tparams, batch, tcfg),
               JG.forward_minibatch(params, _jax_batch(batch), jcfg))
    _check_loss_and_grads(jcfg, tcfg, params, tparams, batch)


def test_init_follows_the_jax_rule_and_load_checks_the_tree():
    cfg = dataclasses.replace(GNN_CONFIGS["egnn"].FULL, d_hidden=256)
    p = G.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    j = JG.shapes(JG.GNNConfig(**{**dataclasses.asdict(cfg), "dtype": jnp.float32}))
    assert jax.tree.map(lambda s: s[0], j, is_leaf=JG._is_shape_leaf) == \
        {k: {kk: shape for kk, (shape, _) in v.items()} for k, v in G.shapes(cfg).items()}
    assert torch.all(p["encoder"]["b0"] == 0) and torch.all(p["decoder"]["b1"] == 0)
    for w, fan_in in ((p["encoder"]["w0"], 32), (p["layers"]["phi_e/w0"], 2 * 256 + 1),
                      (p["layers"]["phi_h/b0"], cfg.n_layers)):   # stacked biases: fan_in L
        assert abs(float(w.detach().std()) * fan_in ** 0.5 - 1.0) < 0.1
    assert all(t.requires_grad for t in _leaves(p).values())
    jp = jax.tree.map(np.asarray, JG.init(JAX_SMOKE["egnn"].SMOKE, jax.random.key(0)))
    jp["layers"].pop("phi_x/b1")
    with pytest.raises(ValueError, match="keys"):
        G.load_jax_params(jp, GNN_CONFIGS["egnn"].SMOKE, "cpu")


def test_egnn_equivariance():
    """tests/test_models.py::test_egnn_equivariance in the port."""
    cfg = G.GNNConfig(arch="egnn", n_layers=3, d_hidden=16, d_in=6, n_classes=4)
    params = G.init(cfg, device="cpu")
    batch = _graph(cfg, N=20, E=50, labels=False)
    th = 0.5
    rot = np.asarray([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]],
                     np.float32)
    moved = dict(batch, pos=(batch["pos"] @ rot.T + np.asarray([3., -1., 2.], np.float32)))
    with torch.no_grad():
        _close(G.forward(params, batch, cfg), G.forward(params, moved, cfg), 1e-4)


def test_isolated_nodes_no_nan():
    """tests/test_models.py::test_gnn_isolated_nodes_no_nan in the port, for
    every arch: mean aggregation over zero-degree nodes must not NaN."""
    for name in JAX_SMOKE:
        cfg = GNN_CONFIGS[name].SMOKE
        params = G.init(cfg, device="cpu")
        batch = dict(_graph(cfg, N=5, E=2), senders=np.array([0, 1], np.int32),
                     receivers=np.array([1, 0], np.int32))    # nodes 2-4 isolated
        loss = G.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, list(_leaves(params).values()), allow_unused=True)
        assert torch.isfinite(loss) and all(g is None or torch.isfinite(g).all() for g in grads)
