"""The port's MIND model against the JAX package, on the CPU.

The weights are the JAX package's own init (``repro.models.recsys.init``)
carried across with ``load_jax_params``; batches come from seeded numpy
generators in ``repro.configs.recsys_family``'s layout (``hist``,
``hist_mask``, ``user_feats``, ``candidates`` / ``candidate_ids``), with
users whose history mask is all False; the training loss and its
gradients too.  Configs: MIND's SMOKE and a mid size (FULL's widths,
2^16 items).  Tolerance: f32 at 1e-5 (the largest
difference seen is ~3e-8).  Each JAX reference is computed once per module.

The test marked ``cuda`` holds the model on the card against the same
weights on the CPU and skips without one:
``PYTHONPATH=src python -m pytest -q tests/test_torch_recsys.py -m cuda``.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import mind as M
from repro_torch.models import recsys as R

MID = dataclasses.replace(M.FULL, name="mind-mid", n_items=1 << 16, n_user_feats=1 << 12)
CONFIGS = {"smoke": M.SMOKE, "mid": MID}
TOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import mind as j_mind
    from repro.models import recsys as JR
    return types.SimpleNamespace(jax=jax, jnp=jnp, JR=JR, mind=j_mind)


def _jcfg(jx, cfg):
    return jx.JR.MINDConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"})


def _batch(cfg, B: int, C: int, N: int, seed: int) -> dict:
    """A serve / retrieval batch; the first 3 users have no history."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, cfg.hist_len + 1, B)
    lens[:3] = 0
    hist = rng.integers(0, cfg.n_items, (B, cfg.hist_len)).astype(np.int32)
    mask = np.arange(cfg.hist_len)[None] < lens[:, None]
    hist[~mask & (rng.random((B, cfg.hist_len)) < 0.5)] = -1   # padding ids
    return {"hist": hist, "hist_mask": mask,
            "user_feats": rng.integers(0, cfg.n_user_feats, (B, cfg.user_feat_len)).astype(np.int32),
            "candidates": rng.integers(0, cfg.n_items, (B, C)).astype(np.int32),
            "candidate_ids": rng.integers(0, cfg.n_items, N).astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def case(jx):
    """size -> the JAX params, a port model holding them, a batch and the
    JAX user tower, serve and retrieval scores, computed once."""
    memo = {}

    def get(size):
        if size not in memo:
            cfg = CONFIGS[size]
            jcfg = _jcfg(jx, cfg)
            params = jx.JR.init(jcfg, jx.jax.random.key(1))
            model = R.MIND(cfg, device="cpu")
            R.load_jax_params(model, jx.jax.tree.map(np.asarray, params))
            batch = _batch(cfg, B=40, C=100, N=4096, seed=len(size))
            jb = {k: jx.jnp.asarray(v) for k, v in batch.items()}
            memo[size] = types.SimpleNamespace(
                cfg=cfg, jcfg=jcfg, params=params, model=model, batch=batch,
                **{fn: np.asarray(getattr(jx.JR, fn)(params, jb, jcfg))
                   for fn in ("user_tower", "serve_score", "retrieval_score")})
        return memo[size]
    return get


@pytest.mark.parametrize("fn", ["user_tower", "serve_score", "retrieval_score"])
@pytest.mark.parametrize("size", list(CONFIGS))
def test_scores_match_jax(case, size, fn):
    c = case(size)
    with torch.no_grad():
        got = getattr(c.model, fn)(_torch_batch(c.batch))
    want = getattr(c, fn)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want)
    if fn == "user_tower":   # the users without history: profile-only interests
        assert np.isfinite(want[:3]).all()
        _close(got[:3], want[:3])


@pytest.mark.parametrize("size", list(CONFIGS))
def test_multi_interest_and_attention_match_jax(jx, case, size):
    c = case(size)
    rng = np.random.default_rng(3)
    B, H, d = 12, c.cfg.hist_len, c.cfg.embed_dim
    behav = rng.standard_normal((B, H, d)).astype(np.float32)
    mask = rng.random((B, H)) < 0.6
    mask[:2] = False
    want = jx.JR.multi_interest(c.params, jx.jnp.asarray(behav), jx.jnp.asarray(mask), c.jcfg)
    got = R.multi_interest(c.model.bilinear, torch.from_numpy(behav), torch.from_numpy(mask),
                           c.cfg)
    _close(got, want)
    tgt = rng.standard_normal((B, d)).astype(np.float32)
    _close(R.label_aware_attention(got, torch.from_numpy(tgt)),
           jx.JR.label_aware_attention(jx.jnp.asarray(np.asarray(want)), jx.jnp.asarray(tgt)))
    x = rng.standard_normal((5, 7, d)).astype(np.float32)
    x[0] = 0.0
    _close(R.squash(torch.from_numpy(x)), jx.JR.squash(jx.jnp.asarray(x)))


@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_embedding_bags_match_jax(jx, mode):
    """Both bags against the JAX package's: the ragged one with an empty
    bag, a bag at the end and positions before the first offset; the dense
    one with all-masked rows and padding ids."""
    rng = np.random.default_rng(5)
    table = rng.standard_normal((300, 16)).astype(np.float32)
    indices = rng.integers(0, 300, 50).astype(np.int32)
    offsets = np.array([2, 2, 9, 20, 41, 49], np.int32)
    want = jx.JR.embedding_bag(jx.jnp.asarray(table), jx.jnp.asarray(indices),
                               jx.jnp.asarray(offsets), mode)
    got = R.embedding_bag(torch.from_numpy(table), torch.from_numpy(indices),
                          torch.from_numpy(offsets), mode)
    _close(got, want)
    assert torch.all(got[0] == 0)
    ids = rng.integers(-1, 300, (9, 6)).astype(np.int32)
    mask = (ids >= 0) & (rng.random((9, 6)) < 0.8)
    mask[:2] = False
    want = jx.JR.embedding_bag_dense(jx.jnp.asarray(table), jx.jnp.asarray(ids),
                                     jx.jnp.asarray(mask), mode)
    got = R.embedding_bag_dense(torch.from_numpy(table), torch.from_numpy(ids),
                                torch.from_numpy(mask), mode)
    _close(got, want)
    assert torch.all(got[:2] == 0)


def test_configs_and_shapes_match_jax(jx):
    for size in ("FULL", "SMOKE"):
        j = dataclasses.asdict(getattr(jx.mind, size))
        t = dataclasses.asdict(getattr(M, size))
        assert {k: v for k, v in j.items() if k != "dtype"} == \
            {k: v for k, v in t.items() if k != "dtype"}
        assert jx.jnp.dtype(j["dtype"]).name == str(t["dtype"]).split(".")[-1]
    cfg = M.SMOKE
    assert R.shapes(cfg) == {k: s for k, (s, _) in jx.JR.shapes(_jcfg(jx, cfg)).items()}
    assert M.FULL.n_items == 2 ** 26 and M.FULL.n_user_feats == 2 ** 20


def test_init_follows_the_jax_rule_and_load_checks_the_tree(jx):
    cfg = dataclasses.replace(M.SMOKE, n_items=4000, embed_dim=64, d_hidden=128)
    m = R.MIND(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    assert m.item_embed.requires_grad and torch.all(m.b_hidden == 0)
    for w, std in ((m.item_embed, 0.1), (m.user_embed, 0.1), (m.bilinear, 64 ** -0.5),
                   (m.w_hidden, 128 ** -0.5), (m.w_out, 128 ** -0.5)):
        assert abs(float(w.std()) / std - 1.0) < 0.1
    params = jx.jax.tree.map(np.asarray, jx.JR.init(_jcfg(jx, M.SMOKE), jx.jax.random.key(0)))
    with pytest.raises(ValueError, match="does not match"):
        R.load_jax_params(m, params)
    with pytest.raises(ValueError):
        R.MIND(dataclasses.replace(M.SMOKE, capsule_iters=0), device="cpu")


@pytest.mark.parametrize("size", list(CONFIGS))
def test_loss_and_gradients_match_jax(jx, case, size):
    """loss_fn (label-aware attention against the target, then the sampled
    softmax over the batch's targets) and every gradient against
    ``jax.value_and_grad`` of the JAX ``loss_fn``, users without history
    included, at 1e-5."""
    c = case(size)
    batch = dict(c.batch, target=np.random.default_rng(11).integers(
        0, c.cfg.n_items, c.batch["hist"].shape[0]).astype(np.int32))
    loss_j, grads_j = jx.jax.value_and_grad(jx.JR.loss_fn)(
        c.params, {k: jx.jnp.asarray(v) for k, v in batch.items()}, c.jcfg)
    named = dict(c.model.named_parameters())
    loss = R.loss_fn(c.model, _torch_batch(batch))
    grads = torch.autograd.grad(loss, list(named.values()))
    _close(loss.detach(), loss_j)
    for (name, _), g in zip(named.items(), grads):
        _close(g, grads_j[name])


# --- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_mind_on_the_card_matches_the_cpu():
    """MID on the card (f32, TF32 off) against the same weights on the CPU:
    user tower, serve and retrieval scores at 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = R.MIND(MID, device="cpu", generator=torch.Generator().manual_seed(4))
    card = R.MIND(MID, device="cuda")
    card.load_state_dict(cpu.state_dict())
    batch = _torch_batch(_batch(MID, B=64, C=100, N=1 << 16, seed=9))
    on_card = {k: v.cuda() for k, v in batch.items()}
    with torch.no_grad():
        for fn in ("user_tower", "serve_score", "retrieval_score"):
            _close(getattr(card, fn)(on_card).cpu(), getattr(cpu, fn)(batch), 1e-4)
