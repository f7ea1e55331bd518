"""The port's dense transformer LM against the JAX package, on the CPU.

The weights are the JAX package's own init (``repro.models.transformer.init``)
carried across with ``load_jax_params``; tokens come from a seeded numpy
generator.  Configs are the dense ``LM_VARIANTS`` of ``tests/test_models.py``
(dense, bias, swa, partial_rope) and the SMOKE configs of qwen2-7b,
h2o-danube-3-4b, chatglm3-6b, qwen3-moe-235b-a22b and deepseek-v2-236b
(the MoE / MLA variants in depth: ``tests/test_torch_moe_mla.py``).
Tolerances: ``forward`` 1e-4 in f32 with
and without ``use_flash_prefill``; prefill and decode logits 2e-3 (those of
``tests/test_models.py``); bf16 as stated in its test.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import chatglm3_6b as j_chatglm
from repro.configs import deepseek_v2_236b as j_deepseek
from repro.configs import h2o_danube_3_4b as j_danube
from repro.configs import qwen2_7b as j_qwen2
from repro.configs import qwen3_moe_235b_a22b as j_qwen3_moe
from repro.models import transformer as JT
from repro_torch import configs as C
from repro_torch.models import transformer as T

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=97, remat=False)
VARIANTS = {
    "dense": {},
    "bias": dict(qkv_bias=True),
    "swa": dict(sliding_window=8, n_kv_heads=4),
    "partial_rope": dict(rotary_pct=0.5),
}


def _cfgs(dtype="float32", **kw):
    jdt, tdt = DTYPES[dtype]
    kw = {**BASE, **kw}
    return JT.TransformerConfig(**kw, dtype=jdt), T.TransformerConfig(**kw, dtype=tdt)


def _carried(jcfg, tcfg, seed=0):
    """JAX params and a port model holding the same weights."""
    params = JT.init(jcfg, jax.random.key(seed))
    model = T.Transformer(tcfg, device="cpu")
    T.load_jax_params(model, jax.tree.map(np.asarray, params))
    return params, model


def _np(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _tokens(rng, vocab, shape):
    toks = rng.integers(0, vocab, shape).astype(np.int32)
    return jnp.asarray(toks), torch.from_numpy(toks)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_matches_jax(name, flash, rng):
    jcfg, tcfg = _cfgs(**VARIANTS[name])
    params, model = _carried(jcfg, tcfg)
    if flash:
        model = T.Transformer(dataclasses.replace(tcfg, use_flash_prefill=True), device="cpu")
        T.load_jax_params(model, jax.tree.map(np.asarray, params))
    tj, tt = _tokens(rng, tcfg.vocab, (2, 128))
    want = JT.forward(params, tj, jcfg)
    with torch.no_grad():
        got = model(tt)
        hidden = model.hidden_states(tt)
    assert got.dtype == torch.float32 and got.shape == (2, 128, tcfg.vocab)
    _close(got, want, 1e-4)
    _close(hidden, JT.hidden_states(params, tj, jcfg), 1e-4)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefill_and_decode_match_jax(name, rng):
    """prefill(S) then decode(token S): logits and cache against JAX."""
    jcfg, tcfg = _cfgs(**VARIANTS[name])
    params, model = _carried(jcfg, tcfg, seed=1)
    S = 12
    tj, tt = _tokens(rng, tcfg.vocab, (2, S + 1))
    j_cache, lg_pre = JT.prefill(params, tj[:, :S], jcfg, max_len=S + 4)
    cache, got_pre = model.prefill(tt[:, :S], max_len=S + 4)
    _close(got_pre, lg_pre, 2e-3)
    assert cache["index"] == int(j_cache["index"])
    for key in ("k", "v"):
        assert cache[key].shape == j_cache[key].shape
        _close(cache[key], j_cache[key], 1e-4)
    _, lg_dec = JT.decode_step(params, j_cache, tj[:, S], jcfg)
    cache, got_dec = model.decode_step(cache, tt[:, S])
    _close(got_dec, lg_dec, 2e-3)
    assert cache["index"] == S + 1


def test_swa_ring_decode_past_the_window(rng):
    """Decode 14 tokens past a prefix of 10 with a window of 8 and a ring
    of 8 slots: every step's logits equal the full forward at that
    position, in the port and in JAX."""
    jcfg, tcfg = _cfgs(**VARIANTS["swa"])
    params, model = _carried(jcfg, tcfg, seed=2)
    S_total, prefix = 24, 10
    tj, tt = _tokens(rng, tcfg.vocab, (1, S_total))
    full_j = np.asarray(JT.forward(params, tj, jcfg))
    with torch.no_grad():
        full_t = model(tt)
    cache, lg = model.prefill(tt[:, :prefix], max_len=S_total)
    assert cache["k"].shape[2] == 8
    _close(lg, full_j[:, prefix - 1], 2e-3)
    for i in range(prefix, S_total):
        cache, lg = model.decode_step(cache, tt[:, i])
        _close(lg, full_j[:, i], 2e-3)
        _close(lg, full_t[:, i], 2e-3)


@pytest.mark.parametrize("extra", [{"n_kv_heads": 2}, {"sliding_window": 32, "n_kv_heads": 4}])
def test_flash_prefill_inside_model_forward(extra, rng):
    """use_flash_prefill swaps the attention op without changing the
    model's outputs (the port's counterpart of the JAX package's test)."""
    cfg = T.TransformerConfig(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=97,
                              dtype=torch.float32, remat=False, **extra)
    cfg_f = dataclasses.replace(cfg, use_flash_prefill=True)
    a_model = T.Transformer(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    b_model = T.Transformer(cfg_f, device="cpu", generator=torch.Generator().manual_seed(0))
    toks = torch.from_numpy(rng.integers(0, 97, (2, 128)).astype(np.int32))
    with torch.no_grad():
        _close(b_model(toks), a_model(toks), 1e-4)


def test_bf16_forward_matches_jax(rng):
    """bf16 weights and activations: the port and JAX round at other
    places (matmul kernels, fused elementwise ops), so the logits (spread
    ~1, largest ~4) agree at atol = rtol = 0.1; the largest difference
    seen here is 0.066.  The flash branch, which keeps softmax weights in
    f32 where the torch-op branch casts them to bf16, agrees with the
    torch-op branch at the same tolerance (0.073 seen)."""
    jcfg, tcfg = _cfgs("bfloat16", qkv_bias=True)
    params, model = _carried(jcfg, tcfg)
    model_f = T.Transformer(dataclasses.replace(tcfg, use_flash_prefill=True), device="cpu")
    T.load_jax_params(model_f, jax.tree.map(np.asarray, params))
    assert model.layers[0].wq.dtype == torch.bfloat16
    tj, tt = _tokens(rng, tcfg.vocab, (2, 128))
    want = np.asarray(JT.forward(params, tj, jcfg))
    with torch.no_grad():
        got, got_f = model(tt), model_f(tt)
    assert np.isfinite(_np(got)).all() and float(np.abs(want).max()) > 0.5
    _close(got, want, 0.1)
    _close(got_f, got, 0.1)


JAX_CONFIGS = {"qwen2-7b": j_qwen2, "h2o-danube-3-4b": j_danube, "chatglm3-6b": j_chatglm,
               "qwen3-moe-235b-a22b": j_qwen3_moe, "deepseek-v2-236b": j_deepseek}


@pytest.mark.parametrize("arch", list(JAX_CONFIGS))
def test_configs_match_jax(arch):
    """FULL and SMOKE carry every field of the JAX config; only the dtype
    type differs."""
    for size in ("FULL", "SMOKE"):
        j = dataclasses.asdict(getattr(JAX_CONFIGS[arch], size))
        t = dataclasses.asdict(getattr(C.LM_CONFIGS[arch], size))
        assert {k: v for k, v in j.items() if k != "dtype"} == \
            {k: v for k, v in t.items() if k != "dtype"}
        assert str(t["dtype"]).split(".")[-1] == jnp.dtype(j["dtype"]).name


@pytest.mark.parametrize("arch", list(JAX_CONFIGS))
def test_smoke_configs_match_jax(arch, rng):
    """Each SMOKE model with carried weights: forward (torch-op and flash
    branches), prefill and one decode step against JAX."""
    jcfg, tcfg = JAX_CONFIGS[arch].SMOKE, C.LM_CONFIGS[arch].SMOKE
    params, model = _carried(jcfg, tcfg, seed=3)
    model_f = T.Transformer(dataclasses.replace(tcfg, use_flash_prefill=True), device="cpu")
    T.load_jax_params(model_f, jax.tree.map(np.asarray, params))
    tj, tt = _tokens(rng, tcfg.vocab, (2, 128))
    want = np.asarray(JT.forward(params, tj, jcfg))
    with torch.no_grad():
        _close(model(tt), want, 1e-4)
        _close(model_f(tt), want, 1e-4)
    j_cache, lg_pre = JT.prefill(params, tj[:, :127], jcfg, max_len=130)
    cache, got_pre = model.prefill(tt[:, :127], max_len=130)
    _close(got_pre, lg_pre, 2e-3)
    _, got_dec = model.decode_step(cache, tt[:, 127])
    _close(got_dec, want[:, 127], 2e-3)


def test_init_follows_the_jax_rule():
    cfg = T.TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                              vocab=300, qkv_bias=True, dtype=torch.bfloat16)
    m = T.Transformer(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    again = T.Transformer(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    lay = m.layers[1]
    assert torch.all(lay.ln_attn == 1) and torch.all(m.ln_f == 1)
    assert torch.all(lay.bq == 0) and torch.all(lay.bv == 0)
    assert lay.w2.dtype == torch.bfloat16 and lay.w2.requires_grad
    for w, fan_in in ((lay.wq, 64), (lay.w2, 128), (m.embed, 300), (m.lm_head, 64)):
        assert abs(float(w.float().std()) * fan_in ** 0.5 - 1.0) < 0.1
    assert torch.equal(m.layers[0].wk, again.layers[0].wk)
    j = JT.shapes(JT.TransformerConfig(**{**dataclasses.asdict(cfg), "dtype": jnp.bfloat16}))
    assert {k: (cfg.n_layers, *s) for k, s in T.layer_shapes(cfg).items()} == \
        {k: s for k, (s, _) in j["layers"].items()}
    assert T.top_shapes(cfg) == {k: j[k][0] for k in ("embed", "ln_f", "lm_head")}


def test_cache_init_matches_jax_shapes():
    for kw in ({}, {"sliding_window": 8}):
        jcfg, tcfg = _cfgs(**kw)
        c = T.cache_init(tcfg, 3, 20, device="cpu")
        j = JT.cache_shapes(jcfg, 3, 20)
        assert c["k"].shape == j["k"][0] and c["v"].shape == j["v"][0] and c["index"] == 0
        assert torch.all(c["k"] == 0)


@pytest.mark.parametrize("kw", [
    dict(n_layers=3, n_experts=8, top_k=2, moe_d_ff=96),
    dict(n_layers=3, n_experts=8, top_k=2, moe_d_ff=96, n_shared_experts=1,
         n_dense_layers=1, mla_kv_lora=32, mla_q_lora=24, mla_rope_dim=8,
         mla_nope_dim=16, mla_v_dim=16, n_kv_heads=4),
    dict(mla_kv_lora=32, mla_rope_dim=8, mla_nope_dim=16, mla_v_dim=16),
], ids=["moe", "mla_moe", "mla"])
def test_moe_and_mla_raise(kw, rng):
    """MoE and MLA configs raise only where the JAX package's validate
    rules refuse them (ValueError; until the port had these layers they
    raised NotImplementedError): each builds, loads JAX's weights and
    matches JAX's forward at 1e-4, and the same config with a top_k past
    n_experts (or, MLA only, 3 kv heads for 4 heads) raises ValueError.
    The full MoE / MLA parity suite is tests/test_torch_moe_mla.py."""
    jcfg, tcfg = _cfgs(**kw)
    params, model = _carried(jcfg, tcfg, seed=4)
    tj, tt = _tokens(rng, tcfg.vocab, (2, 32))
    with torch.no_grad():
        _close(model(tt), JT.forward(params, tj, jcfg), 1e-4)
    bad = dict(top_k=9) if "n_experts" in kw else dict(n_kv_heads=3)
    with pytest.raises(ValueError):
        T.Transformer(dataclasses.replace(tcfg, **bad), device="cpu")


def test_load_rejects_a_mismatched_tree():
    jcfg, tcfg = _cfgs()
    params = jax.tree.map(np.asarray, JT.init(jcfg, jax.random.key(0)))
    bias_model = T.Transformer(dataclasses.replace(tcfg, qkv_bias=True), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        T.load_jax_params(bias_model, params)
