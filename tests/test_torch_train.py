"""The port's LM training path against the JAX package, on the CPU.

``loss_fn`` and every gradient against ``jax.value_and_grad`` of
``repro.models.transformer.loss_fn`` for the SMOKE configs of qwen2-7b
(dense), qwen3-moe-235b-a22b (MoE) and deepseek-v2-236b (MLA + MoE), with
the JAX init carried across by ``load_jax_params`` and tokens and labels
(some masked, < 0) from seeded numpy generators: f32, atol = rtol = 1e-5,
also with ``remat`` (blocks of 2) and a chunked head.  The same checks
as ``tests/test_models.py`` for remat blocks and ``loss_chunk``; the flash
kernel refused under grad in both packages; serving outputs without a
graph; one whole train step (loss, gradients, AdamW with the cosine
schedule) against the JAX package's by loss, norm and moments;
``train_lm`` restart-exact after an
injected failure.  The SMOKE MoE configs route every token well clear of a
near-tie in f32 (trap h): a flipped route would show as a gradient gap.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_v2_236b as j_deepseek
from repro.configs import qwen2_7b as j_qwen2
from repro.configs import qwen3_moe_235b_a22b as j_qwen3_moe
from repro.models import transformer as JT
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as j_cosine
from repro_torch import configs as C
from repro_torch.configs import mind as M
from repro_torch.launch import train_lm
from repro_torch.launch.train import make_train_step
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, cosine_schedule

SMOKE = {"qwen2-7b": j_qwen2, "qwen3-moe-235b-a22b": j_qwen3_moe,
         "deepseek-v2-236b": j_deepseek}
HEADS = {"plain": {}, "remat_chunked": dict(remat=True, remat_block=2, loss_chunk=16)}
TOL = 1e-5


def _carried(name, seed=3, **changes):
    jcfg = dataclasses.replace(SMOKE[name].SMOKE, **changes)
    tcfg = dataclasses.replace(C.LM_CONFIGS[name].SMOKE, **changes)
    params = JT.init(jcfg, jax.random.key(seed))
    model = T.Transformer(tcfg, device="cpu")
    T.load_jax_params(model, jax.tree.map(np.asarray, params))
    return jcfg, params, model


def _named(tree, model) -> dict:
    """A JAX parameter (or gradient) tree keyed by the port's parameter
    names: the ``[L, ...]`` stacks (``dense_layers`` first) unstacked."""
    out = {k: np.asarray(tree[k]) for k in ("embed", "ln_f", "lm_head")}
    i = 0
    for key in ("dense_layers", "layers"):
        if key not in tree:
            continue
        stack = {k: np.asarray(v) for k, v in tree[key].items()}
        n = next(iter(stack.values())).shape[0]
        for j in range(n):
            out.update({f"layers.{i + j}.{k}": v[j] for k, v in stack.items()})
        i += n
    assert set(out) == {n for n, _ in model.named_parameters()}
    return out


def _batch(vocab, B=2, S=16, seed=7):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[0, :3] = -1                                   # masked positions
    return toks, labels


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("head", list(HEADS))
@pytest.mark.parametrize("name", list(SMOKE))
def test_loss_and_gradients_match_jax(name, head):
    jcfg, params, model = _carried(name, **HEADS[head])
    toks, labels = _batch(jcfg.vocab)
    loss_j, grads_j = jax.value_and_grad(JT.loss_fn)(
        params, jnp.asarray(toks), jnp.asarray(labels), jcfg)
    loss = T.loss_fn(model, torch.from_numpy(toks), torch.from_numpy(labels))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    _close(loss.detach(), loss_j)
    want = _named(grads_j, model)
    for n, g in zip(names, grads):
        assert np.abs(want[n]).max() > 0, n    # every leaf gets a gradient
        _close(g, want[n])


def test_remat_block_equivalent():
    """tests/test_models.py::test_remat_block_equivalent in the port: the
    gradients with one checkpoint per layer equal those of blocks of 2
    (with the inner per-layer checkpoint) and of no remat."""
    cfg = dataclasses.replace(C.qwen2_7b.SMOKE, n_layers=4, vocab=97)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 97, (2, 8)).astype(np.int32))
    ref = T.Transformer(cfg, device="cpu")
    grads = {}
    for kw in (dict(remat=False), dict(remat=True, remat_block=1),
               dict(remat=True, remat_block=2), dict(remat=True, remat_block=3)):
        m = T.Transformer(dataclasses.replace(cfg, **kw), device="cpu")
        m.load_state_dict(ref.state_dict())
        grads[str(kw)] = torch.autograd.grad(T.loss_fn(m, toks, toks), list(m.parameters()))
    base = grads.pop(str(dict(remat=False)))
    for gs in grads.values():
        for a, b in zip(gs, base):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_loss_chunk_equivalent():
    """tests/test_models.py::test_loss_chunk_equivalent in the port, with
    the gradients too; a chunk that does not divide T takes the unchunked
    head, as in the JAX package."""
    cfg = dataclasses.replace(C.qwen2_7b.SMOKE, vocab=97)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 97, (4, 8)).astype(np.int32))
    ref = T.Transformer(cfg, device="cpu")
    loss0 = T.loss_fn(ref, toks, toks)
    g0 = torch.autograd.grad(loss0, list(ref.parameters()))
    for ck in (8, 16, 5):
        m = T.Transformer(dataclasses.replace(cfg, loss_chunk=ck), device="cpu")
        m.load_state_dict(ref.state_dict())
        loss = T.loss_fn(m, toks, toks)
        torch.testing.assert_close(loss, loss0, atol=1e-5, rtol=1e-5)
        for a, b in zip(torch.autograd.grad(loss, list(m.parameters())), g0):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_flash_under_grad_raises_in_both_packages():
    """Neither package differentiates the flash kernel: JAX raises
    differentiating its Pallas call, the port raises rather than return an
    output without a gradient.  Under no_grad the port's flash forward
    runs and equals the torch-op one."""
    jcfg, params, model = _carried("qwen2-7b", use_flash_prefill=True)
    toks, labels = _batch(jcfg.vocab, S=128)
    with pytest.raises(Exception):
        jax.value_and_grad(JT.loss_fn)(params, jnp.asarray(toks), jnp.asarray(labels), jcfg)
    tt, tl = torch.from_numpy(toks), torch.from_numpy(labels)
    with pytest.raises(RuntimeError, match="no backward"):
        T.loss_fn(model, tt, tl)
    with pytest.raises(RuntimeError, match="no backward"):
        model(tt)
    with torch.no_grad():
        flash = model(tt)
        model.cfg = dataclasses.replace(model.cfg, use_flash_prefill=False)
        for lay in model.layers:
            lay.cfg = model.cfg
        torch.testing.assert_close(flash, model(tt), atol=1e-4, rtol=1e-4)


def test_serving_outputs_carry_no_graph():
    """prefill / decode_step and MIND's scores run without a graph (their
    caches are written in place); forward and the losses keep one."""
    model = T.Transformer(C.qwen2_7b.SMOKE, device="cpu")
    toks = torch.randint(0, 256, (2, 8), generator=torch.Generator().manual_seed(0))
    assert model(toks).grad_fn is not None
    cache, lg = model.prefill(toks, max_len=12)
    assert lg.grad_fn is None and not cache["k"].requires_grad
    cache, lg = model.decode_step(cache, toks[:, 0])
    assert lg.grad_fn is None and not cache["v"].requires_grad
    assert all(p.requires_grad for p in model.parameters())
    mind = R.MIND(M.SMOKE, device="cpu")
    batch = {"hist": torch.zeros(2, 10, dtype=torch.int32),
             "hist_mask": torch.ones(2, 10, dtype=torch.bool),
             "user_feats": torch.zeros(2, 4, dtype=torch.int32),
             "candidates": torch.ones(2, 5, dtype=torch.int32),
             "candidate_ids": torch.arange(7, dtype=torch.int32),
             "target": torch.tensor([3, 4], dtype=torch.int32)}
    assert mind.serve_score(batch).grad_fn is None
    assert mind.retrieval_score(batch).grad_fn is None
    assert R.loss_fn(mind, batch).grad_fn is not None


@pytest.mark.parametrize("name", ["qwen2-7b", "qwen3-moe-235b-a22b"])
def test_train_step_matches_jax(name):
    """Three whole steps of the slice (loss, gradients, global norm, AdamW
    with the cosine schedule, clipping and decay) against the JAX
    package's train step on the same parameters and batches: each step's
    loss (taken on the parameters the previous updates left) and norm at
    1e-5, and the first step's moments m and v at 1e-5 of each leaf's
    largest.  The parameters themselves are held to JAX's optimizer on
    equal gradients in tests/test_torch_optim.py: Adam divides each entry
    by its own gradient scale, so an entry whose gradients are near zero
    turns the ~1e-8 gradient differences into a visible share of one step,
    and the next step's gradients and moments follow those parameters."""
    jcfg, params, model = _carried(name)
    jopt = JAdamW(lr=j_cosine(3e-3, 1, 100), grad_clip=0.5)
    topt = AdamW(lr=cosine_schedule(3e-3, 1, 100), grad_clip=0.5)
    jstate = jopt.init(params)
    tparams = dict(model.named_parameters())
    tstate = topt.init(tparams)
    step = make_train_step(lambda p, b: T.loss_fn(model, b["tokens"], b["labels"]), topt)
    for seed in (1, 2, 3):
        toks, labels = _batch(jcfg.vocab, seed=seed)
        loss_j, g = jax.value_and_grad(JT.loss_fn)(
            params, jnp.asarray(toks), jnp.asarray(labels), jcfg)
        params, jstate, gn_j = jopt.update(g, jstate, params)
        _, tstate, metrics = step(tparams, tstate, {"tokens": torch.from_numpy(toks),
                                                    "labels": torch.from_numpy(labels)})
        _close(metrics["loss"], loss_j)
        _close(metrics["grad_norm"], gn_j)
        if seed == 1:  # later moments follow parameters the first update set apart
            for moment, want in ((tstate.m, jstate.m), (tstate.v, jstate.v)):
                for n, w in _named(want, model).items():
                    err = float(np.abs(moment[n].numpy() - w).max())
                    assert err <= TOL * float(np.abs(w).max()), n
    assert int(tstate.step) == int(jstate.step) == 3


def test_train_lm_restart_exact(tmp_path):
    """train_lm with a checkpoint every 2 steps and a failure injected
    after step 5's update: the rerun restores step 3 and its losses equal
    the uninterrupted run's from step 4 on, exactly."""
    full = train_lm("qwen2-7b", steps=8, batch=2, seq=16, device="cpu", log_every=100)
    assert full["steps"] == 8 and all(np.isfinite(full["losses"]))
    ck = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="injected failure"):
        train_lm("qwen2-7b", steps=8, batch=2, seq=16, ckpt_dir=ck, ckpt_every=2, fail_at=5,
                 device="cpu", log_every=100)
    again = train_lm("qwen2-7b", steps=8, batch=2, seq=16, ckpt_dir=ck, ckpt_every=2,
                     device="cpu", log_every=100)
    assert again["restored_from"] == 4
    assert again["losses"] == full["losses"][4:]
