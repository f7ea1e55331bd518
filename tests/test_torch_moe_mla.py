"""The port's MoE and MLA transformer against the JAX package, on the CPU.

The weights are the JAX package's own init (``repro.models.transformer.init``)
carried across with ``load_jax_params``; inputs come from seeded numpy
generators.  Configs: the ``moe`` and ``mla_moe`` variants of
``tests/test_models.py``, an MLA-only variant (dense FFN), and the SMOKE
configs of qwen3-moe-235b-a22b and deepseek-v2-236b.  Tolerances:
``forward`` 1e-4 in f32 with and without ``use_flash_prefill`` (MLA never
takes the flash branch); prefill and decode logits 2e-3; the dispatch plan
(``e_sorted``, ``t_sorted``, ``pos_in_e``, ``keep``) bit for bit against
the JAX package's own jnp steps; bf16 as stated in its test.  Each JAX
reference is computed once per module (``jax_ref``).

JAX is imported inside fixtures, so that on a machine without it (the
card's) only the tests marked ``cuda`` run; they hold the flash kernel at
qwen3-moe's group (KV 4, G 16, hd 128) against its plain version and the
port's MoE / MLA models on the card against the same models on the CPU:
``PYTHONPATH=src python -m pytest -q tests/test_torch_moe_mla.py -m cuda``.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import configs as C
from repro_torch.kernels import flash_prefill as fp
from repro_torch.models import transformer as T

BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=97, remat=False)
VARIANTS = {
    "moe": dict(n_layers=3, n_experts=8, top_k=2, moe_d_ff=96),
    "mla_moe": dict(n_layers=3, n_experts=8, top_k=2, moe_d_ff=96, n_shared_experts=1,
                    n_dense_layers=1, mla_kv_lora=32, mla_q_lora=24, mla_rope_dim=8,
                    mla_nope_dim=16, mla_v_dim=16, n_kv_heads=4),
    "mla": dict(mla_kv_lora=32, mla_rope_dim=8, mla_nope_dim=16, mla_v_dim=16),
}
SMOKE = ("qwen3-moe-235b-a22b", "deepseek-v2-236b")
S_PRE = 12  # prefill length of the serve tests


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import deepseek_v2_236b, qwen3_moe_235b_a22b
    from repro.models import transformer as JT
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, JT=JT,
        smoke={"qwen3-moe-235b-a22b": qwen3_moe_235b_a22b, "deepseek-v2-236b": deepseek_v2_236b})


def _cfgs(jx, dtype="float32", **kw):
    jdt, tdt = {"float32": (jx.jnp.float32, torch.float32),
                "bfloat16": (jx.jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = {**BASE, **kw}
    return jx.JT.TransformerConfig(**kw, dtype=jdt), T.TransformerConfig(**kw, dtype=tdt)


def _np(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _model(jx, tcfg, params, device="cpu"):
    model = T.Transformer(tcfg, device=device)
    T.load_jax_params(model, jx.jax.tree.map(np.asarray, params))
    return model


@pytest.fixture(scope="module")
def jax_ref(jx):
    """name -> the JAX side of a case, computed once: configs, params,
    tokens [2, 128] and the JAX forward, prefill (S_PRE) and decode."""
    memo = {}

    def get(name):
        if name not in memo:
            if name in VARIANTS:
                jcfg, tcfg = _cfgs(jx, **VARIANTS[name])
            else:
                jcfg, tcfg = jx.smoke[name].SMOKE, C.LM_CONFIGS[name].SMOKE
            params = jx.JT.init(jcfg, jx.jax.random.key(3))
            toks = np.random.default_rng(7).integers(0, tcfg.vocab, (2, 128)).astype(np.int32)
            tj = jx.jnp.asarray(toks)
            j_cache, lg_pre = jx.JT.prefill(params, tj[:, :S_PRE], jcfg, max_len=S_PRE + 4)
            _, lg_dec = jx.JT.decode_step(params, j_cache, tj[:, S_PRE], jcfg)
            memo[name] = types.SimpleNamespace(
                jcfg=jcfg, tcfg=tcfg, params=params, toks=torch.from_numpy(toks),
                forward=np.asarray(jx.JT.forward(params, tj, jcfg)),
                hidden=np.asarray(jx.JT.hidden_states(params, tj, jcfg)),
                cache={k: np.asarray(v) for k, v in j_cache.items()},
                prefill=np.asarray(lg_pre), decode=np.asarray(lg_dec))
        return memo[name]
    return get


# --- forward, prefill, decode ------------------------------------------------


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("name", list(VARIANTS) + list(SMOKE))
def test_forward_matches_jax(jx, jax_ref, name, flash):
    ref = jax_ref(name)
    model = _model(jx, dataclasses.replace(ref.tcfg, use_flash_prefill=flash), ref.params)
    before = fp.LAUNCHES
    with torch.no_grad():
        got = model(ref.toks)
        hidden = model.hidden_states(ref.toks)
    assert fp.LAUNCHES == before  # CPU tensors: the plain version, never a launch
    assert got.dtype == torch.float32 and got.shape == (2, 128, ref.tcfg.vocab)
    _close(got, ref.forward, 1e-4)
    _close(hidden, ref.hidden, 1e-4)


@pytest.mark.parametrize("name", list(VARIANTS) + list(SMOKE))
def test_prefill_and_decode_match_jax(jx, jax_ref, name):
    """prefill(S) then decode(token S): logits and every cache entry
    against JAX (MLA: c_kv and k_rope across the dense and MoE layers)."""
    ref = jax_ref(name)
    model = _model(jx, ref.tcfg, ref.params)
    with torch.no_grad():
        cache, got_pre = model.prefill(ref.toks[:, :S_PRE], max_len=S_PRE + 4)
        _close(got_pre, ref.prefill, 2e-3)
        assert cache["index"] == int(ref.cache["index"]) == S_PRE
        assert set(cache) == set(ref.cache)
        for key in set(cache) - {"index"}:
            assert cache[key].shape == ref.cache[key].shape
            _close(cache[key], ref.cache[key], 1e-4)
        cache, got_dec = model.decode_step(cache, ref.toks[:, S_PRE])
    _close(got_dec, ref.decode, 2e-3)
    assert cache["index"] == S_PRE + 1


@pytest.mark.parametrize("name", ["moe", "mla_moe"])
def test_decode_steps_follow_forward(jx, jax_ref, name):
    """Prefill 12 tokens, decode the next 8 one at a time: each step's
    logits equal the port's and JAX's full forward at that position (no
    token is dropped: capacity covers every token at T = 256)."""
    ref = jax_ref(name)
    model = _model(jx, ref.tcfg, ref.params)
    toks = ref.toks[:, :20]
    with torch.no_grad():
        full = model(toks)
        cache, lg = model.prefill(toks[:, :S_PRE], max_len=20)
        _close(lg, full[:, S_PRE - 1], 2e-3)
        for i in range(S_PRE, 20):
            cache, lg = model.decode_step(cache, toks[:, i])
            _close(lg, full[:, i], 2e-3)
    _close(full, ref.forward[:, :20], 2e-3)


def _routes(plan: T.DispatchPlan, K: int) -> np.ndarray:
    """Each token's K experts, ascending, from a dispatch plan: [T, K]."""
    return plan.e_sorted[torch.argsort(plan.t_sorted, stable=True)].view(-1, K).numpy()


def _jax_layerwise(jx, params, toks, jcfg):
    """The JAX forward layer by layer (``layer_fwd`` over ``dense_layers``
    then ``layers``, the final norm and ``lm_head``), with each MoE layer's
    top-k experts per token recomputed from its router input.  (The JAX
    package's scan forward rounds elsewhere in bf16 and may route a
    near-tied token differently again.)"""
    JT, jnp, jax = jx.JT, jx.jnp, jx.jax
    B, S = toks.shape
    x = params["embed"][toks].astype(jcfg.dtype)
    pos = jnp.arange(S)
    routes = []
    for key in ("dense_layers", "layers"):
        for i in range(params[key]["ln_attn"].shape[0] if key in params else 0):
            lp = jax.tree.map(lambda a: a[i], params[key])
            if "router" in lp:
                h = JT.rms_norm(x, lp["ln_attn"], jcfg.norm_eps)
                q, k, v = JT._qkv_gqa(h, lp, jcfg, pos)
                attn = JT.attention(q, k, v, pos, pos, jcfg.sliding_window,
                                    jcfg.attn_block_q, jcfg.blockwise_from)
                h2 = JT.rms_norm(x + attn.reshape(B, S, -1) @ lp["wo"], lp["ln_mlp"],
                                 jcfg.norm_eps).reshape(B * S, -1)
                gates = jax.nn.softmax(h2.astype(jnp.float32) @ lp["router"], axis=-1)
                routes.append(np.sort(np.asarray(jax.lax.top_k(gates, jcfg.top_k)[1]), 1))
            x = JT.layer_fwd(x, lp, jcfg, pos)
    logits = (JT.rms_norm(x, params["ln_f"], jcfg.norm_eps) @ params["lm_head"])
    return np.asarray(logits.astype(jnp.float32)), routes


def test_bf16_forward_matches_jax(jx, monkeypatch):
    """bf16 weights and activations, MoE with a leading dense layer and a
    shared expert; the router stays f32 on both sides.  The port and JAX
    round at other places (matmul kernels, fused elementwise ops), so a
    token whose K-th and (K+1)-th gates are near-tied may take another
    expert in each: a discrete change of that token's output.  Every
    token that no MoE layer routes differently agrees at atol = rtol =
    0.1, the tolerance of the dense bf16 test (0.094 here); 9 of the 512
    (token, layer) choices differ, each in a token beyond that tolerance.
    (MLA in bf16 has no JAX reference here: the JAX CPU backend refuses
    its bf16 x bf16 -> f32 dots.)"""
    jcfg, tcfg = _cfgs(jx, "bfloat16", **VARIANTS["moe"], n_shared_experts=1, n_dense_layers=1)
    params = jx.JT.init(jcfg, jx.jax.random.key(0))
    model = _model(jx, tcfg, params)
    assert model.layers[1].router.dtype == torch.float32
    assert model.layers[1].we1.dtype == torch.bfloat16
    toks = np.random.default_rng(11).integers(0, tcfg.vocab, (2, 128)).astype(np.int32)
    want, j_routes = _jax_layerwise(jx, params, jx.jnp.asarray(toks), jcfg)
    plans = []
    plan_fn = T.moe_dispatch_plan
    monkeypatch.setattr(T, "moe_dispatch_plan", lambda *a: plans.append(plan_fn(*a)) or plans[-1])
    with torch.no_grad():
        got = _np(model(torch.from_numpy(toks)))
    assert np.isfinite(got).all() and float(np.abs(want).max()) > 0.5
    assert len(plans) == len(j_routes) == tcfg.n_moe_layers
    flips = [(_routes(p, tcfg.top_k) != r).any(1) for p, r in zip(plans, j_routes)]
    flipped = np.logical_or.reduce(flips)
    assert 0 < sum(int(f.sum()) for f in flips) <= 0.02 * flipped.size * len(flips)
    keep = ~flipped.reshape(toks.shape)
    _close(got[keep], want[keep], 0.1)


# --- the MoE dispatch ----------------------------------------------------------


def _jax_plan(jx, x, router, cfg):
    """The dispatch plan from the JAX package's own jnp steps
    (``repro.models.transformer._moe_ffn_chunk``) on the same router input."""
    jnp = jx.jnp
    T_, K, E = x.shape[0], cfg.top_k, cfg.n_experts
    C_ = max(int(T_ * K / E * cfg.capacity_factor), 1)
    if T_ <= 256:
        C_ = max(C_, T_)
    gates = jx.jax.nn.softmax(jnp.asarray(x).astype(jnp.float32) @ jnp.asarray(router), axis=-1)
    _, top_e = jx.jax.lax.top_k(gates, K)
    flat_e = top_e.reshape(-1)
    flat_t = jnp.repeat(jnp.arange(T_), K)
    order = jnp.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    counts = jnp.bincount(flat_e, length=E)
    starts = jnp.cumsum(counts) - counts
    pos_in_e = jnp.arange(T_ * K) - starts[e_sorted]
    return (np.asarray(e_sorted), np.asarray(flat_t[order]), np.asarray(pos_in_e),
            np.asarray(pos_in_e < C_), C_)


@pytest.mark.parametrize("cf,T_", [(0.5, 300), (1.25, 300), (1.25, 200), (1.0, 1000)])
def test_dispatch_plan_equals_jax(jx, cf, T_):
    """The plan is integer data: equal to JAX's bit for bit.  At a low
    capacity factor assignments are dropped (keep False); at T <= 256 the
    capacity covers every token and none is."""
    jcfg, tcfg = _cfgs(jx, **VARIANTS["moe"], capacity_factor=cf)
    rng = np.random.default_rng(int(cf * 100) + T_)
    x = rng.standard_normal((T_, tcfg.d_model)).astype(np.float32)
    router = (rng.standard_normal((tcfg.d_model, tcfg.n_experts)) / 8).astype(np.float32)
    plan = T.moe_dispatch_plan(torch.from_numpy(x), torch.from_numpy(router), tcfg)
    want = _jax_plan(jx, x, router, jcfg)
    for got, w in zip((plan.e_sorted, plan.t_sorted, plan.pos_in_e, plan.keep), want[:4]):
        np.testing.assert_array_equal(got.numpy(), w)
    assert plan.capacity == want[4] == T.moe_capacity(T_, tcfg)
    dropped = int((~plan.keep).sum())
    if T_ <= 256:
        assert dropped == 0 and plan.capacity >= T_
    elif cf < 1:
        assert dropped > 0
    np.testing.assert_allclose(plan.gates.reshape(-1).numpy().sum(), T_, rtol=1e-5)


@pytest.mark.parametrize("chunk,cf,S", [(0, 1.25, 64), (16, 1.25, 64), (300, 0.5, 150),
                                        (32768, 0.5, 150)])
def test_moe_ffn_matches_jax(jx, chunk, cf, S):
    """moe_ffn on one layer's weights, with the dispatch chunked over the
    sequence (moe_chunk 16 over B = 4, S = 64: 16 chunks of 64 tokens;
    300 over S = 150: 2 chunks of 300) and not, at a factor that drops
    assignments (0.5; chunks above 256 tokens) and one that keeps most:
    f32 at 1e-5."""
    jcfg, tcfg = _cfgs(jx, **VARIANTS["mla_moe"], moe_chunk=chunk, capacity_factor=cf)
    params = jx.JT.init(jcfg, jx.jax.random.key(5))
    model = _model(jx, tcfg, params)
    lp = jx.jax.tree.map(lambda a: a[0], params["layers"])
    B = 4
    x = np.random.default_rng(chunk).standard_normal((B * S, tcfg.d_model)).astype(np.float32)
    want = np.asarray(jx.JT.moe_ffn(jx.jnp.asarray(x), lp, jcfg, (B, S)))
    with torch.no_grad():
        got = T.moe_ffn(torch.from_numpy(x), model.layers[1], tcfg, (B, S))
    _close(got, want, 1e-5)
    if cf < 1:
        s_ck = max(chunk // B, 1) if B * S > chunk else S
        first = x.reshape(B, S, -1)[:, :s_ck].reshape(B * s_ck, -1)
        plan = T.moe_dispatch_plan(torch.from_numpy(first), model.layers[1].router, tcfg)
        assert int((~plan.keep).sum()) > 0


def test_combine_adds_in_expert_order_in_bf16(jx):
    """The bf16 combine equals the JAX package's scatter-add bit for bit
    on the same contributions: each token's K entries summed in ascending
    expert order, one rounding per add (f32 accumulation would differ)."""
    jnp = jx.jnp
    jcfg, tcfg = _cfgs(jx, "bfloat16", **{**VARIANTS["moe"], "top_k": 4})
    params = jx.JT.init(jcfg, jx.jax.random.key(2))
    model = _model(jx, tcfg, params)
    lp = jx.jax.tree.map(lambda a: a[0], params["layers"])
    x32 = np.random.default_rng(4).standard_normal((64, tcfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x32).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    # the experts' outputs replaced by one shared table, so the products
    # (which round differently in the two packages) drop out
    E, C_, d = tcfg.n_experts, T.moe_capacity(64, tcfg), tcfg.d_model
    y_tab = np.random.default_rng(5).standard_normal((E, C_, d)).astype(np.float32)
    plan = T.moe_dispatch_plan(xt, model.layers[0].router, tcfg)
    e_s, t_s, p_s, keep, _ = _jax_plan(jx, np.asarray(xj.astype(jnp.float32)),
                                       np.asarray(lp["router"]), jcfg)
    g = plan.gates.detach().numpy()
    contrib = jnp.asarray(y_tab).astype(jnp.bfloat16)[jnp.where(keep, e_s, 0),
                                                      jnp.where(keep, p_s, 0)]
    contrib = contrib * jnp.asarray(g * keep).astype(jnp.bfloat16)[:, None]
    want = np.asarray(jnp.zeros((64, d), jnp.bfloat16).at[t_s].add(contrib).astype(jnp.float32))
    ct = torch.from_numpy(np.array(contrib.astype(jnp.float32))).bfloat16()
    per_token = torch.argsort(plan.t_sorted, stable=True).view(64, tcfg.top_k)
    y = ct[per_token[:, 0]]
    for j in range(1, tcfg.top_k):
        y = y + ct[per_token[:, j]]
    np.testing.assert_array_equal(y.float().numpy(), want)
    once = ct.float()[per_token].sum(1).bfloat16().float().numpy()
    assert (once != want).any()


def _moe_ffn_chunk_boolean(x, lp, cfg):
    """The dispatch as it was written before the sync-free form: a store at
    the boolean-indexed kept assignments (a ``nonzero`` each)."""
    T_, d = x.shape
    K = cfg.top_k
    plan = T.moe_dispatch_plan(x, lp.router, cfg)
    keep = plan.keep
    buf = x.new_zeros((cfg.n_experts, plan.capacity, d))
    buf[plan.e_sorted[keep], plan.pos_in_e[keep]] = x[plan.t_sorted[keep]]
    h = torch.nn.functional.silu(torch.bmm(buf, lp.we1)) * torch.bmm(buf, lp.we3)
    y_e = torch.bmm(h, lp.we2)
    contrib = y_e[torch.where(keep, plan.e_sorted, 0), torch.where(keep, plan.pos_in_e, 0)]
    contrib = contrib * (plan.gates * keep).to(contrib.dtype)[:, None]
    per_token = torch.argsort(plan.t_sorted, stable=True).view(T_, K)
    y = contrib[per_token[:, 0]]
    for j in range(1, K):
        y = y + contrib[per_token[:, j]]
    if cfg.n_shared_experts:
        y = y + T.swiglu(x, lp.ws1, lp.ws3, lp.ws2)
    return y.to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", SMOKE)
def test_sync_free_dispatch_equals_boolean_index(name, dtype):
    """``_moe_ffn_chunk``'s scatter-add dispatch (no ``nonzero``, so no host
    sync and a ``meta`` form) equals the boolean-index store exactly, in
    f32 and bf16, on 300 tokens at capacity factor 0.5 (assignments
    dropped): the output, and the gradients of x and every expert weight."""
    cfg = dataclasses.replace(C.LM_CONFIGS[name].SMOKE, dtype=dtype, capacity_factor=0.5)
    lp = T.Transformer(cfg, device="cpu").layers[-1]
    assert lp.kind == "moe"
    x0 = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (300, cfg.d_model)).astype(np.float32)).to(dtype)
    assert not T.moe_dispatch_plan(x0, lp.router, cfg).keep.all()
    weights = [lp.we1, lp.we3, lp.we2] + ([lp.ws1] if cfg.n_shared_experts else [])
    outs = []
    for fn in (T._moe_ffn_chunk, _moe_ffn_chunk_boolean):
        x = x0.clone().requires_grad_()
        y = fn(x, lp, cfg)
        grads = torch.autograd.grad(y.float().square().sum(), [x] + weights)
        outs.append([y.detach()] + list(grads))
    for got, want in zip(*outs):
        assert got.dtype == want.dtype and torch.equal(got, want)
    meta = T._moe_ffn_chunk(x0.to("meta"), T.Transformer(cfg, device="meta").layers[-1], cfg)
    assert meta.shape == x0.shape and meta.dtype == dtype


# --- parameters, cache, config -------------------------------------------------


def test_load_jax_params_unstacks_dense_then_moe(jx):
    jcfg, tcfg = _cfgs(jx, "bfloat16", **VARIANTS["mla_moe"])
    params = jx.jax.tree.map(np.asarray, jx.JT.init(jcfg, jx.jax.random.key(1)))
    assert set(params) == {"embed", "ln_f", "lm_head", "dense_layers", "layers"}
    model = _model(jx, tcfg, params)
    assert [lay.kind for lay in model.layers] == ["dense", "moe", "moe"]
    lay0, lay2 = model.layers[0], model.layers[2]
    np.testing.assert_array_equal(lay0.w1.detach().float().numpy(),
                                  params["dense_layers"]["w1"][0].astype(np.float32))
    np.testing.assert_array_equal(lay2.we2.detach().float().numpy(),
                                  params["layers"]["we2"][1].astype(np.float32))
    assert lay2.router.dtype == torch.float32 and params["layers"]["router"].dtype == np.float32
    np.testing.assert_array_equal(lay2.router.detach().numpy(), params["layers"]["router"][1])
    assert not hasattr(lay0, "router") and not hasattr(lay2, "w1")
    dense_only = dict(params, layers=params["dense_layers"])
    with pytest.raises(ValueError, match="does not match"):
        T.load_jax_params(model, dense_only)
    no_dense = {k: v for k, v in params.items() if k != "dense_layers"}
    with pytest.raises(ValueError, match="does not match"):
        T.load_jax_params(model, no_dense)


@pytest.mark.parametrize("name", list(VARIANTS) + list(SMOKE))
def test_shapes_and_cache_init_match_jax(jx, name):
    """Per-layer shapes and dtypes (the router f32 in a bf16 model) and
    the cache's keys and shapes equal the JAX package's."""
    if name in VARIANTS:
        jcfg, tcfg = _cfgs(jx, "bfloat16", **VARIANTS[name])
    else:
        jcfg, tcfg = jx.smoke[name].SMOKE, C.LM_CONFIGS[name].SMOKE
    j = jx.JT.shapes(jcfg)
    stacks = [("dense_layers", "dense", tcfg.n_dense_layers)] if "dense_layers" in j else []
    stacks.append(("layers", "moe" if tcfg.is_moe else "dense",
                   tcfg.n_moe_layers or tcfg.n_layers))
    for key, kind, n in stacks:
        got = {k: ((n, *s), str(T.param_dtype(k, tcfg)).split(".")[-1])
               for k, s in T.layer_shapes(tcfg, kind).items()}
        assert got == {k: (s, jx.jnp.dtype(dt).name) for k, (s, dt) in j[key].items()}
    c = T.cache_init(tcfg, 3, 20, device="cpu")
    js = jx.JT.cache_shapes(jcfg, 3, 20)
    assert set(c) == set(js) and c["index"] == 0
    for key in set(js) - {"index"}:
        assert c[key].shape == js[key][0] and c[key].dtype == tcfg.dtype
        assert torch.all(c[key] == 0)


def test_init_follows_the_jax_rule():
    cfg = T.TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, vocab=300,
                              n_experts=8, top_k=2, moe_d_ff=96, n_shared_experts=1,
                              n_dense_layers=1, mla_kv_lora=32, mla_q_lora=24,
                              mla_rope_dim=8, mla_nope_dim=16, mla_v_dim=16)
    m = T.Transformer(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    moe = m.layers[1]
    assert moe.router.dtype == torch.float32 and moe.we1.dtype == torch.bfloat16
    assert moe.we1.requires_grad and torch.all(moe.ln_attn == 1)
    for w, fan_in in ((moe.router, 64), (moe.we1, 64), (moe.we2, 96), (moe.ws2, 96),
                      (moe.w_uk, 32), (moe.w_dq, 64), (m.layers[0].w1, 64)):
        assert abs(float(w.float().std()) * fan_in ** 0.5 - 1.0) < 0.1


@pytest.mark.parametrize("kw", [
    dict(n_experts=8, top_k=9, moe_d_ff=32),
    dict(n_experts=8, top_k=0, moe_d_ff=32),
    dict(n_experts=8, top_k=2, moe_d_ff=32, n_dense_layers=2),
    dict(n_kv_heads=3),
], ids=["top_k_past_E", "top_k_0", "all_dense", "heads"])
def test_invalid_configs_raise_value_error(kw):
    """The JAX package's validate rules (there: asserts)."""
    cfg = T.TransformerConfig(**{**BASE, **kw}, dtype=torch.float32)
    with pytest.raises(ValueError):
        T.Transformer(cfg, device="cpu")


def test_smoke_configs_match_jax_fields(jx):
    for arch in SMOKE:
        for size in ("FULL", "SMOKE"):
            j = dataclasses.asdict(getattr(jx.smoke[arch], size))
            t = dataclasses.asdict(getattr(C.LM_CONFIGS[arch], size))
            assert {k: v for k, v in j.items() if k != "dtype"} == \
                {k: v for k, v in t.items() if k != "dtype"}
    full = C.LM_CONFIGS["deepseek-v2-236b"].FULL
    assert full.layer_kinds() == ["dense"] + ["moe"] * 59 and full.n_moe_layers == 59


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _row_scaled_err(got, want) -> float:
    """max |got - want| over the rms of ``want`` across hd, per (query row,
    head): the output's scale falls along the sequence, so a tolerance at
    the early rows' scale would miss a late row that lost a key tile."""
    rms = want.float().pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
    return float(((got.float() - want.float()).abs() / rms).max())


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1024, 4096])
def test_flash_prefill_at_qwen3_moe_group(cuda, S):
    """qwen3-moe's attention shape (KV 4, G 16, hd 128) in bf16 takes the
    wgmma kernel and agrees with the plain version computed in f32 on the
    same values to 2^-5 of each output row's rms; the last query rows with
    one middle key tile dropped would not."""
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn((1, S, 4, 16, 128), generator=g, device=cuda).bfloat16()
    k = torch.randn((1, S, 4, 128), generator=g, device=cuda).bfloat16()
    v = torch.randn((1, S, 4, 128), generator=g, device=cuda).bfloat16()
    tc = fp.TC_LAUNCHES
    got = fp.flash_prefill(q, k, v)
    torch.cuda.synchronize()
    assert fp.TC_LAUNCHES == tc + 1
    for h in range(4):
        want = fp.flash_prefill_plain(q[:, :, h:h + 1].float(), k[:, :, h:h + 1].float(),
                                      v[:, :, h:h + 1].float())
        assert _row_scaled_err(got[:, :, h:h + 1], want) <= 2.0 ** -5
    # the last 8 positions (one 128-row query tile) without keys S/2 .. S/2 + 63
    s = torch.einsum("bqgh,bth->bgqt", q[:, S - 8:, 3].float(), k[:, :, 3].float()) / 128 ** 0.5
    later = torch.arange(S, device=cuda)[None, :] > torch.arange(S - 8, S, device=cuda)[:, None]
    s = s.masked_fill(later, -1e30)
    s[..., S // 2:S // 2 + 64] = -1e30
    dropped = torch.einsum("bgqt,bth->bqgh", torch.softmax(s, -1), v[:, :, 3].float())
    assert _row_scaled_err(dropped.bfloat16(), want[:, S - 8:, 0]) > 2.0 ** -5


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SMOKE))
def test_smoke_models_on_the_card_match_the_cpu(cuda, name):
    """The SMOKE model (f32, TF32 off) on the card against the same
    weights on the CPU: forward through the flash kernel (qwen3-moe) or
    MLA at 1e-4, prefill and decode at 2e-3."""
    tcfg = dataclasses.replace(C.LM_CONFIGS[name].SMOKE, use_flash_prefill=True)
    cpu = T.Transformer(tcfg, device="cpu", generator=torch.Generator().manual_seed(1))
    card = T.Transformer(tcfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, tcfg.vocab, (2, 128)))
    with torch.no_grad():
        _close(card(toks.to(cuda)).cpu(), cpu(toks), 1e-4)
        c_card, lg_card = card.prefill(toks[:, :S_PRE].to(cuda), max_len=S_PRE + 4)
        c_cpu, lg_cpu = cpu.prefill(toks[:, :S_PRE], max_len=S_PRE + 4)
        _close(lg_card.cpu(), lg_cpu, 2e-3)
        _, d_card = card.decode_step(c_card, toks[:, S_PRE].to(cuda))
        _, d_cpu = cpu.decode_step(c_cpu, toks[:, S_PRE])
        _close(d_card.cpu(), d_cpu, 2e-3)
