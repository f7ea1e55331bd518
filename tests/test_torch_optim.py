"""The port's optimizer, gradient compression and data pipeline against
the JAX package, on the CPU.

AdamW from the same parameters and gradients (numpy seeds) for one and
three steps under a constant rate and the cosine schedule: f32 parameters
and moments within 1e-6, bf16 parameters within one bf16 ulp; the clip
and its pre-clip norm, the schedule's values.  ``compress`` /
``decompress`` bit for bit (deterministic rounding); ``compressed_psum``
against JAX's under a one-device ``shard_map``, through a world-1 gloo
group, and over four gloo ranks against JAX's over four ``vmap``
participants.  ``lm_batch_fn`` / ``gnn_batch_fn`` batches equal to JAX's;
the ``Prefetcher`` restart of ``tests/test_optim.py``.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, PartitionSpec as P

import repro.optim as JO
from repro.data import gnn_batch_fn as j_gnn_batch_fn
from repro.data import lm_batch_fn as j_lm_batch_fn
from repro.graph.generators import ogb_like as j_ogb_like
from repro_torch import optim as O
from repro_torch.data import Prefetcher, gnn_batch_fn, lm_batch_fn, shard_batch
from repro_torch.graph import ogb_like

SHAPES = {"w": (33, 17), "b": (17,), "emb": (50, 8)}


def _tree(rng, dtype=np.float32):
    return {k: rng.normal(size=s).astype(dtype) for k, s in SHAPES.items()}


def _torch_tree(tree, dtype=torch.float32):
    """Tensors holding copies: the update writes the parameters in place, and
    ``np.asarray`` of a JAX array would share the JAX buffer."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dtype) for k, v in tree.items()}


def _run_both(jopt, topt, steps, dtype=jnp.float32, seed=0):
    """Both optimizers from the same parameters through the same gradient
    sequence; -> (JAX params, JAX state, norms), (port ...)."""
    rng = np.random.default_rng(seed)
    params = {k: jnp.asarray(v, dtype) for k, v in _tree(rng).items()}
    tparams = _torch_tree(jax.tree.map(np.asarray, params),
                          torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    jstate, tstate = jopt.init(params), topt.init(tparams)
    jn, tn = [], []
    for _ in range(steps):
        g = {k: v * 3.0 for k, v in _tree(rng).items()}
        params, jstate, n1 = jopt.update({k: jnp.asarray(v, dtype) for k, v in g.items()},
                                         jstate, params)
        _, tstate, n2 = topt.update(_torch_tree(g, tparams["w"].dtype), tstate, tparams)
        jn.append(float(n1))
        tn.append(float(n2))
    return (params, jstate, jn), (tparams, tstate, tn)


LRS = {"constant": (1e-2, 1e-2), "cosine": (JO.cosine_schedule(1e-2, 2, 10),
                                            O.cosine_schedule(1e-2, 2, 10))}


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("lr", list(LRS))
@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_f32_matches_jax(steps, lr, clip):
    jl, tl = LRS[lr]
    (jp, js, jn), (tp, ts, tn) = _run_both(JO.AdamW(lr=jl, grad_clip=clip),
                                           O.AdamW(lr=tl, grad_clip=clip), steps)
    np.testing.assert_allclose(tn, jn, rtol=1e-6)
    assert int(ts.step) == int(js.step) == steps
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(ts.m[k].numpy(), np.asarray(js.m[k]), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(ts.v[k].numpy(), np.asarray(js.v[k]), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_bf16_params_within_one_ulp(steps):
    """bf16 parameters keep f32 moments; after the update's f32 arithmetic
    each parameter rounds to bf16 within one ulp of JAX's."""
    (jp, js, _), (tp, ts, _) = _run_both(JO.AdamW(lr=1e-2), O.AdamW(lr=1e-2), steps,
                                         dtype=jnp.bfloat16)
    for k in SHAPES:
        assert tp[k].dtype == torch.bfloat16 and ts.m[k].dtype == torch.float32
        got, want = tp[k].float().numpy(), np.asarray(jp[k], np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp), k


def test_adamw_clip_reports_the_norm_before_clipping():
    opt = O.AdamW(lr=0.0, grad_clip=1.0)
    params = {"w": torch.zeros(3)}
    _, state, gnorm = opt.update({"w": torch.full((3,), 100.0)}, opt.init(params), params)
    assert float(gnorm) > 100 and float(state.m["w"].abs().max()) <= 0.1 / 3 ** 0.5 + 1e-7
    assert float(O.global_norm({"a": torch.tensor([3.0]), "b": {"c": torch.tensor([4.0])}})) == 5.0


def test_adamw_converges_quadratic():
    """tests/test_optim.py::test_adamw_converges_quadratic in the port."""
    opt = O.AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0, 1.5], requires_grad=True)}
    state = opt.init(params)
    for _ in range(200):
        g = torch.autograd.grad((params["w"] ** 2).sum(), [params["w"]])[0]
        params, state, _ = opt.update({"w": g}, state, params)
    assert float(params["w"].detach().abs().max()) < 1e-2


def test_cosine_schedule_matches_jax():
    js, ts = JO.cosine_schedule(1e-3, 10, 100), O.cosine_schedule(1e-3, 10, 100)
    for i in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        assert float(ts(torch.tensor(i, dtype=torch.int32))) == pytest.approx(
            float(js(jnp.int32(i))), rel=1e-6, abs=1e-12)
    assert float(ts(torch.tensor(0))) == 0.0


@pytest.mark.parametrize("n", [1, 1024, 5000])
def test_compress_decompress_bit_equal(n):
    x = np.random.default_rng(n).normal(size=(n,)).astype(np.float32) * 10
    x[: min(n, 1024) // 2] = 0.0        # a half-zero block: scale 0 where n is small
    jc = JO.compress(jnp.asarray(x))
    tc = O.compress(torch.from_numpy(x))
    assert tc.n == jc.n == n
    np.testing.assert_array_equal(tc.q.numpy(), np.asarray(jc.q))
    np.testing.assert_array_equal(tc.scale.numpy(), np.asarray(jc.scale))
    np.testing.assert_array_equal(O.decompress(tc, (n,)).numpy(),
                                  np.asarray(JO.decompress(jc, (n,))))


def test_stochastic_rounding_uses_the_generator():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(4096,)).astype(np.float32))
    a = O.compress(x, stochastic=True, generator=torch.Generator().manual_seed(5))
    b = O.compress(x, stochastic=True, generator=torch.Generator().manual_seed(5))
    det = O.compress(x)
    assert torch.equal(a.q, b.q) and not torch.equal(a.q, det.q)
    assert int((a.q.int() - det.q.int()).abs().max()) <= 1
    err = (O.decompress(a, x.shape) - x).abs()
    assert float(err.max()) <= float(a.scale.max()) * 1.01
    with pytest.raises(ValueError, match="generator"):
        O.compress(x, stochastic=True)


def test_compressed_psum_one_participant_matches_jax_shard_map(tmp_path):
    x = np.random.default_rng(2).normal(size=(3000,)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:1]), ("i",))
    want = jax.shard_map(lambda v: JO.compressed_psum(v, "i"), mesh=mesh, in_specs=P(),
                         out_specs=P())(jnp.asarray(x))
    got = O.compressed_psum(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        got_group = O.compressed_psum(torch.from_numpy(x), group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got_group.numpy(), np.asarray(want))


def _psum_rank(rank: int, store: str, rows: np.ndarray, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=len(rows))
    try:
        got = O.compressed_psum(torch.from_numpy(rows[rank]), group=dist.group.WORLD)
        out.put((rank, got.numpy()))
    finally:
        dist.destroy_process_group()


def test_compressed_psum_four_ranks_matches_jax(tmp_path):
    """Four gloo processes against JAX's four vmap participants (pmax and
    psum over an axis): every rank's result equals JAX's bit for bit."""
    rows = np.random.default_rng(3).normal(size=(4, 3000)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda v: JO.compressed_psum(v, "i"), axis_name="i")(
        jnp.asarray(rows)))
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_psum_rank, args=(r, str(tmp_path / "store"), rows, out))
             for r in range(4)]
    for p in procs:
        p.start()
    got = dict(out.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    for r in range(4):
        np.testing.assert_array_equal(got[r], want[r])
    exact = rows.sum(0)
    assert float(np.abs(got[0] - exact).max() / np.abs(exact).max()) < 0.05


def test_lm_batches_equal_jax():
    for step in (0, 3, 17):
        a, b = lm_batch_fn(97, 4, 16)(step), j_lm_batch_fn(97, 4, 16)(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_gnn_batches_equal_jax():
    """The same minibatch from the port's sampler on the port's graph as
    from the JAX package's on its own (both graphs numpy, seeded)."""
    g, jg = ogb_like(3000, mean_deg=8, seed=1), j_ogb_like(3000, mean_deg=8, seed=1)
    for step in (0, 5):
        a = gnn_batch_fn(g, (4, 3), 16, 6, 5)(step)
        b = j_gnn_batch_fn(jg, (4, 3), 16, 6, 5)(step)
        assert set(a) == set(b)
        for k in ("seed_x", "labels"):
            assert np.array_equal(a[k], b[k])
        for k in ("layer_x", "layer_mask"):
            assert len(a[k]) == len(b[k]) == 2
            assert all(np.array_equal(x, y) for x, y in zip(a[k], b[k]))


def test_prefetcher_deterministic_restart():
    """tests/test_optim.py::test_prefetcher_deterministic_restart in the port."""
    mk = lm_batch_fn(vocab=50, batch=2, seq=8)
    p1 = Prefetcher(mk, start_step=0)
    it = iter(p1)
    next(it)
    s1, b1 = next(it)
    p1.close()
    p2 = Prefetcher(mk, start_step=1)
    s1b, b1b = next(iter(p2))
    p2.close()
    assert s1 == s1b == 1
    assert np.array_equal(b1["tokens"], b1b["tokens"])
    assert not p1._thread.is_alive() and not p2._thread.is_alive()


def test_shard_batch_places_the_tree():
    batch = gnn_batch_fn(ogb_like(500, mean_deg=4), (3, 2), 4, 5, 3)(0)
    out = shard_batch(batch, "cpu")
    assert isinstance(out["layer_x"], list) and out["layer_x"][1].shape == (4, 6, 5)
    assert out["layer_mask"][0].dtype == torch.bool and out["labels"].dtype == torch.int32
    assert np.array_equal(out["seed_x"].numpy(), batch["seed_x"])
