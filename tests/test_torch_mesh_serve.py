"""Serving, MIND and the GNNs on a mesh of gloo ranks, against one device
and the JAX package.

  * the five LM SMOKE configs (f32) under their serving layout (the
    parameters by ``param_specs``, FSDP for the MoE archs as their FULL
    serving cells have it) and ``cache_specs`` (the positions over
    "model"): ``prefill`` of a [4, 12] prompt into 16 slots (h2o-danube's
    window-8 ring wraps), then 4 decode steps, on a (2, 2) and a (1, 4)
    mesh of four ranks: each rank's logits (its rows and vocabulary
    columns) within 1e-5 of one device's and of the JAX package's
    unsharded ``prefill`` / ``decode_step`` (weights carried by
    ``load_jax_params``), and each rank's cache equal to the matching
    slice of one device's;
  * MIND's SMOKE config on (2, 2): ``serve_score`` (the users over
    "data"), ``retrieval_score`` (the corpus over every axis), the loss
    and its gradients within 1e-5 of one device and of the JAX package;
  * the four GNNs on (2, 2) with their batch placed by the JAX package's
    rules (node arrays over "data", edges over ("data", "model"),
    graphsage's seeds over every axis, molecules by graph): the loss and
    every gradient within 1e-5 of the dense one-device step.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_serve_ranks as SR
import torch_sharded_ranks as R
from repro.configs import get_arch as j_get_arch
from repro.models import recsys as JR
from repro.models import transformer as JT
from repro_torch.configs import GNN_CONFIGS, LM_CONFIGS, get_arch
from repro_torch.models import gnn as G
from repro_torch.models import recsys as RS
from repro_torch.models import transformer as T
from repro_torch.models.parallel import chunk_range

TOL = 1e-5


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


# ---------------------------------------------------------------------------
# The LMs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lm_runs(tmp_path_factory):
    """Per arch: the JAX init and prompt, JAX's unsharded logits, one
    device's logits and cache, and every rank's run on both meshes."""
    tmp = tmp_path_factory.mktemp("mesh_serve")
    arrays, ref = {}, {}
    for arch in SR.ARCHS:
        cfg = LM_CONFIGS[arch].SMOKE
        jcfg = j_get_arch(arch).smoke_config
        jparams = JT.init(jcfg, jax.random.key(1))
        rng = np.random.default_rng(7)
        toks = rng.integers(0, cfg.vocab, (SR.B, SR.S)).astype(np.int64)
        nxt = rng.integers(0, cfg.vocab, (SR.B, SR.DECODE)).astype(np.int64)
        jcache, jl = JT.prefill(jparams, jnp.asarray(toks, jnp.int32), jcfg, SR.MAX_LEN)
        jlogits = [np.asarray(jl)]
        for i in range(SR.DECODE):
            jcache, jl = JT.decode_step(jparams, jcache, jnp.asarray(nxt[:, i], jnp.int32), jcfg)
            jlogits.append(np.asarray(jl))
        model = T.Transformer(cfg, device="cpu")
        T.load_jax_params(model, jax.tree.map(np.asarray, jparams))
        cache, lg = model.prefill(torch.from_numpy(toks), SR.MAX_LEN)
        logits = [lg.numpy().copy()]
        for i in range(SR.DECODE):
            cache, lg = model.decode_step(cache, torch.from_numpy(nxt[:, i]))
            logits.append(lg.numpy().copy())
        for name, p in model.named_parameters():
            arrays[f"w/{arch}/{name}"] = p.detach().numpy()
        arrays[f"tokens/{arch}"] = toks
        arrays[f"next/{arch}"] = nxt
        ref[arch] = {"jax": jlogits, "one": logits,
                     "cache": {k: v.numpy().copy() for k, v in cache.items()
                               if isinstance(v, torch.Tensor)}}
    path = str(tmp / "serve.npz")
    np.savez(path, **arrays)
    return ref, SR_spawn("serve_lm", tmp, path)


def SR_spawn(fn, tmp, *args):
    """``torch_mesh_serve_ranks.<fn>`` on four gloo ranks."""
    return R.spawn(f"torch_mesh_serve_ranks:{fn}", 4, tmp, *args, timeout=280)


def _rank_slices(coord, dp, tp, n_rows, n_cols):
    rows = slice(*chunk_range(n_rows, dp, coord[0]))
    cols = slice(*chunk_range(n_cols, tp, coord[1]))
    return rows, cols


@pytest.mark.parametrize("mesh", SR.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", SR.ARCHS)
def test_prefill_decode_on_a_mesh_match_one_device_and_jax(lm_runs, arch, mesh):
    ref, ranks = lm_runs
    dp, tp = mesh
    cfg = LM_CONFIGS[arch].SMOKE
    for got in ranks:
        run = got[(dp, tp, arch)]
        rows, cols = _rank_slices(run["coord"], dp, tp, SR.B, cfg.vocab)
        assert run["index"] == SR.S + SR.DECODE
        for step, lg in enumerate(run["logits"]):
            _close(lg, ref[arch]["one"][step][rows, cols], f"{arch} {mesh} step {step} one")
            _close(lg, ref[arch]["jax"][step][rows, cols], f"{arch} {mesh} step {step} jax")
        for key, whole in ref[arch]["cache"].items():
            slots = slice(*chunk_range(whole.shape[2], tp, run["coord"][1]))
            _close(run["cache"][key], whole[:, rows, slots], f"{arch} {mesh} cache {key}")


def test_every_rank_reported(lm_runs):
    _, ranks = lm_runs
    assert len(ranks) == 4
    assert sorted(r[(2, 2, "qwen2-7b")]["coord"] for r in ranks) == [(0, 0), (0, 1), (1, 0),
                                                                     (1, 1)]


# ---------------------------------------------------------------------------
# MIND
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mind_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_mind")
    cfg = get_arch("mind").smoke_config
    jcfg = j_get_arch("mind").smoke_config
    jparams = JR.init(jcfg, jax.random.key(2))
    rng = np.random.default_rng(3)
    Bm = 8
    batch = {
        "hist": rng.integers(-1, cfg.n_items, (Bm, cfg.hist_len)).astype(np.int64),
        "hist_mask": rng.random((Bm, cfg.hist_len)) < 0.8,
        "user_feats": rng.integers(0, cfg.n_user_feats, (Bm, cfg.user_feat_len)).astype(np.int64),
        "candidates": rng.integers(0, cfg.n_items, (Bm, 16)).astype(np.int64),
        "target": rng.integers(0, cfg.n_items, Bm).astype(np.int64),
        "candidate_ids": rng.integers(0, cfg.n_items, 64).astype(np.int64),
    }
    model = RS.MIND(cfg, device="cpu")
    RS.load_jax_params(model, jax.tree.map(np.asarray, jparams))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    user1 = {k: tb[k][:1] for k in ("hist", "hist_mask", "user_feats")}
    one = {"serve": model.serve_score(tb).numpy(),
           "retrieval": model.retrieval_score({**user1,
                                               "candidate_ids": tb["candidate_ids"]}).numpy()}
    loss = RS.loss_fn(model, tb)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    one["loss"] = float(loss.detach())
    one["grads"] = {n: g.numpy() for (n, _), g in zip(model.named_parameters(), grads)}
    jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
          for k, v in batch.items()}
    jax_out = {"serve": np.asarray(JR.serve_score(jparams, jb, jcfg)),
               "retrieval": np.asarray(JR.retrieval_score(
                   jparams, {**{k: jb[k][:1] for k in ("hist", "hist_mask", "user_feats")},
                             "candidate_ids": jb["candidate_ids"]}, jcfg))}
    jl, jg = jax.value_and_grad(lambda p: JR.loss_fn(p, jb, jcfg))(jparams)
    jax_out["loss"] = float(jl)
    jax_out["grads"] = {k: np.asarray(v) for k, v in jg.items()}
    arrays = {f"w/{n}": p.detach().numpy() for n, p in model.named_parameters()}
    arrays.update({f"b/{k}": v for k, v in batch.items()})
    path = str(tmp / "mind.npz")
    np.savez(path, **arrays)
    return one, jax_out, SR_spawn("mind_on_mesh", tmp, path)


@pytest.mark.parametrize("ref", ["one", "jax"])
def test_mind_on_a_mesh(mind_runs, ref):
    one, jax_out, ranks = mind_runs
    want = one if ref == "one" else jax_out
    for got in ranks:
        d, m = got["coord"]
        rows = slice(*chunk_range(8, 2, d))
        _close(got["serve"], want["serve"][rows], f"serve {ref}")
        chunk = slice(*chunk_range(64, 4, 2 * d + m))
        _close(got["retrieval"], want["retrieval"][:, chunk], f"retrieval {ref}")
        _close(got["loss"], want["loss"], f"loss {ref}")
        for name, g in got["grads"].items():
            _close(g, want["grads"][name], f"grad {name} {ref}")


# ---------------------------------------------------------------------------
# The GNNs
# ---------------------------------------------------------------------------
def _gnn_batches(arch: str, cfg) -> dict:
    """The forms each GNN runs: a graph of 24 nodes / 64 edges, 8
    molecules of 6 nodes / 10 edges, and graphsage's minibatch of 8 seeds
    with fan-outs 3 and 2."""
    rng = np.random.default_rng(11)
    F = cfg.d_in
    pos = arch in ("egnn", "schnet")
    graph = {"x": rng.normal(size=(24, F)).astype(np.float32),
             "senders": rng.integers(0, 24, 64), "receivers": rng.integers(0, 24, 64),
             "labels": rng.integers(-1, cfg.n_classes, 24)}
    mol = {"x": rng.normal(size=(8, 6, F)).astype(np.float32),
           "senders": rng.integers(0, 6, (8, 10)), "receivers": rng.integers(0, 6, (8, 10)),
           "labels": rng.normal(size=8).astype(np.float32)}
    if pos:
        graph["pos"] = rng.normal(size=(24, 3)).astype(np.float32)
        mol["pos"] = rng.normal(size=(8, 6, 3)).astype(np.float32)
    if arch == "graphcast":
        graph["edge_feat"] = rng.normal(size=(64, 4)).astype(np.float32)
        mol["edge_feat"] = rng.normal(size=(8, 10, 4)).astype(np.float32)
    out = {"graph": graph, "molecule": mol}
    if arch == "graphsage":
        out["minibatch"] = {
            "seed_x": rng.normal(size=(8, F)).astype(np.float32),
            "layer_x": [rng.normal(size=(8, 3, F)).astype(np.float32),
                        rng.normal(size=(8, 6, F)).astype(np.float32)],
            "layer_mask": [rng.random((8, 3)) < 0.8, rng.random((8, 6)) < 0.8],
            "labels": rng.integers(0, cfg.n_classes, 8)}
    return out


@pytest.fixture(scope="module")
def gnn_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_gnn")
    arrays, dense = {}, {}
    for name in sorted(GNN_CONFIGS):
        cfg = GNN_CONFIGS[name].SMOKE
        for form, batch in _gnn_batches(cfg.arch, cfg).items():
            pre = f"{name}/{form}"
            params = G.init(cfg, torch.Generator().manual_seed(5), device="cpu")
            leaves = [t for sub in params.values() for t in sub.values()]
            tb = {k: [torch.from_numpy(t) for t in v] if isinstance(v, list)
                  else torch.from_numpy(v) for k, v in batch.items()}
            loss = G.loss_fn(params, tb, cfg)
            dense[(name, form)] = (float(loss.detach()),
                                   [g.numpy() for g in torch.autograd.grad(loss, leaves)])
            for k, sub in params.items():
                for n, t in sub.items():
                    arrays[f"{pre}/p/{k}/{n}"] = t.detach().numpy()
            for k, v in batch.items():
                if isinstance(v, list):
                    for i, t in enumerate(v):
                        arrays[f"{pre}/b/{k}.{i}"] = t
                else:
                    arrays[f"{pre}/b/{k}"] = v
    path = str(tmp / "gnn.npz")
    np.savez(path, **arrays)
    return dense, SR_spawn("gnn_on_mesh", tmp, path)


@pytest.mark.parametrize("name", sorted(GNN_CONFIGS))
def test_gnn_split_inputs_match_dense(gnn_runs, name):
    dense, ranks = gnn_runs
    forms = [f for (n, f) in dense if n == name]
    assert forms
    for got in ranks:
        for form in forms:
            loss, grads = got[(name, form)]
            want_loss, want_grads = dense[(name, form)]
            _close(loss, want_loss, f"{name} {form} loss")
            assert len(grads) == len(want_grads)
            for i, (g, w) in enumerate(zip(grads, want_grads)):
                _close(g, w, f"{name} {form} grad {i}")


# ---------------------------------------------------------------------------
# The train cells' sequence-split carry
# ---------------------------------------------------------------------------
def test_act_seq_carry_matches_the_whole_carry(tmp_path):
    """``act_seq`` (the layer carry split on the sequence over "model"
    between layers, each checkpoint half the size on (2, 2)) gives the
    whole carry's losses and gradient norms within 1e-5."""
    got = SR_spawn("act_seq_steps", tmp_path)
    for rank in got:
        for arch, runs in rank.items():
            _close(np.array(runs[True]), np.array(runs[False]), f"{arch} act_seq")
