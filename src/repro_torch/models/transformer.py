"""Dense GQA transformer LM: forward, prefill and decode (torch port).

The port of ``repro.models.transformer`` for the dense decoders (qwen2-7b,
h2o-danube-3-4b, chatglm3-6b): GQA attention with RoPE (full or partial
rotary), optional QKV bias and sliding window, SwiGLU MLP, a KV cache with
a ring layout under a sliding window.  The parameter layout is the JAX
package's (``x @ w`` with ``w`` [in, out]; head h = kv * G + g), one
``DecoderLayer`` module per layer instead of ``[L, ...]`` scan stacks, so
:func:`load_jax_params` carries a JAX parameter tree across unchanged.

``layer_fwd`` takes the ``flash_prefill`` kernel when
``cfg.use_flash_prefill`` and S % 128 == 0, as the JAX package does;
``prefill`` and ``decode_step`` compute attention with torch ops whatever
the flag says, as the JAX package's versions do.  Sharding constraints
(``_wsc``) and rematerialisation have no meaning on one card and are not
ported; the config keeps their fields.  MoE and MLA layers are a later
slice of the port and raise ``NotImplementedError``.

The parameters do not require gradients: this slice serves only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.engine.streaming import resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 1024                 # dense-MLP hidden
    vocab: int = 1024
    head_dim: int | None = None      # default d_model // n_heads
    max_seq: int = 2048
    # --- MoE (not ported yet) ---
    n_experts: int = 0               # 0 = dense
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    n_dense_layers: int = 0
    capacity_factor: float = 1.25
    moe_chunk: int = 32768
    # --- MLA (not ported yet) ---
    mla_kv_lora: int = 0             # 0 = standard GQA
    mla_q_lora: int = 0
    mla_rope_dim: int = 64
    mla_nope_dim: int = 128
    mla_v_dim: int = 128
    # --- attention variants ---
    sliding_window: int = 0          # 0 = full attention
    qkv_bias: bool = False
    rotary_pct: float = 1.0          # chatglm: 0.5 (2d RoPE)
    rope_theta: float = 1e4
    # --- numerics / execution ---
    dtype: Any = torch.bfloat16
    # training and multi-device fields of the JAX config, kept so configs
    # carry over field for field; the serving path does not read them
    remat: bool = True
    scan_unroll: int = 1
    remat_block: int = 1
    act_dp: tuple = ()
    act_tp: str = "model"
    act_seq: bool = False
    tp_size: int = 16
    attn_block_q: int = 1024         # blockwise attention chunk
    blockwise_from: int = 8192       # use blockwise attention above this S
    loss_chunk: int = 0
    use_flash_prefill: bool = False  # the flash_prefill kernel for full-seq attention
    norm_eps: float = 1e-6

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.mla_kv_lora > 0

    def validate(self) -> None:
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads {self.n_heads} is not a multiple of "
                             f"n_kv_heads {self.n_kv_heads}")
        if self.is_moe:
            raise NotImplementedError("MoE layers are not ported yet (a later slice)")
        if self.is_mla:
            raise NotImplementedError("MLA attention is not ported yet (a later slice)")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def layer_shapes(cfg: TransformerConfig) -> dict[str, tuple[int, ...]]:
    """Shapes of one dense decoder layer (the JAX ``_layer_shapes`` without
    the leading layer axis)."""
    d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    sh = {"ln_attn": (d,), "ln_mlp": (d,), "wo": (H * hd, d),
          "wq": (d, H * hd), "wk": (d, KV * hd), "wv": (d, KV * hd)}
    if cfg.qkv_bias:
        sh.update(bq=(H * hd,), bk=(KV * hd,), bv=(KV * hd,))
    sh.update(w1=(d, cfg.d_ff), w3=(d, cfg.d_ff), w2=(cfg.d_ff, d))
    return sh


def top_shapes(cfg: TransformerConfig) -> dict[str, tuple[int, ...]]:
    return {"embed": (cfg.vocab, cfg.d_model), "ln_f": (cfg.d_model,),
            "lm_head": (cfg.d_model, cfg.vocab)}


def _param(shape, cfg, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device=device),
                        requires_grad=False)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Random init as the JAX ``init``: ``ln_*`` ones, ``b*`` zeros, every
    other weight normal * 1/sqrt(fan_in) (fan_in = shape[-2]) drawn in f32
    and cast to the parameter's dtype.  The draws differ from JAX's."""
    for full, p in model.named_parameters():
        name = full.rsplit(".", 1)[-1]
        if name.startswith("ln_"):
            p.fill_(1.0)
        elif name.startswith("b"):
            p.zero_()
        else:
            fan_in = p.shape[-2] if p.dim() >= 2 else p.shape[-1]
            w = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                            device=p.device)
            p.copy_(w * (1.0 / math.sqrt(max(fan_in, 1))))


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         rotary_dim: int | None = None) -> torch.Tensor:
    """Rotary embedding on the last dim; partial rotary for chatglm 2d.

    x: [..., S, n, hd]; positions broadcastable to [..., S]."""
    hd = x.shape[-1]
    rd = rotary_dim or hd
    rot, rest = x[..., :rd], x[..., rd:]
    half = rd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = rot[..., :half], rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return torch.cat([out, rest], dim=-1) if rd < hd else out


def _attn_mask(q_pos, k_pos, window: int) -> torch.Tensor:
    m = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


def attention(q, k, v, q_pos, k_pos, window: int = 0,
              block_q: int = 1024, blockwise_from: int = 8192) -> torch.Tensor:
    """GQA attention with torch ops.  q: [B,S,H,hd], k/v: [B,T,KV,hd] ->
    [B,S,H,hd].  Above ``blockwise_from`` (and S % block_q == 0) the query
    blocks run one at a time, so the [S, T] scores never fully exist.
    Products are taken in f32 from the inputs' values and ``p`` is cast to
    ``v.dtype`` before PV, as in the JAX package."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, S, KV, G, hd)
    k32, v32 = k.float(), v.float()

    def blk(qb, qpb):
        s = torch.einsum("bqkgh,btkh->bkgqt", qb.float(), k32) * scale
        s = torch.where(_attn_mask(qpb, k_pos, window), s, -1e30)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        return torch.einsum("bkgqt,btkh->bqkgh", p.float(), v32)

    if S <= blockwise_from or S % block_q != 0:
        out = blk(qg, q_pos)
    else:
        out = torch.cat([blk(qg[:, i:i + block_q], q_pos[i:i + block_q])
                         for i in range(0, S, block_q)], dim=1)
    return out.reshape(B, S, H, hd).to(q.dtype)


def swiglu(x, w1, w3, w2):
    return (F.silu(x @ w1) * (x @ w3)) @ w2


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------
class DecoderLayer(nn.Module):
    """One dense decoder layer; parameters named as the JAX layer stack's."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.cfg = cfg
        for name, shape in layer_shapes(cfg).items():
            self.register_parameter(name, _param(shape, cfg, device))

    def qkv(self, x, positions):
        """The JAX ``_qkv_gqa``: projections, optional bias, RoPE."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = q.reshape(B, S, H, hd)
        k = k.reshape(B, S, KV, hd)
        v = v.reshape(B, S, KV, hd)
        rd = int(cfg.rotary_pct * hd)
        return rope(q, positions, cfg.rope_theta, rd), rope(k, positions, cfg.rope_theta, rd), v

    def mlp(self, x):
        """x + SwiGLU(rms_norm(x)): the second half of the layer."""
        B, S, d = x.shape
        h = rms_norm(x, self.ln_mlp, self.cfg.norm_eps)
        return x + swiglu(h.reshape(B * S, d), self.w1, self.w3, self.w2).reshape(B, S, d)

    def forward(self, x, positions):
        """The JAX ``layer_fwd``: one layer over the full sequence."""
        cfg = self.cfg
        B, S, _ = x.shape
        h = rms_norm(x, self.ln_attn, cfg.norm_eps)
        q, k, v = self.qkv(h, positions)
        if cfg.use_flash_prefill and S % 128 == 0:
            KV = cfg.n_kv_heads
            qg = q.reshape(B, S, KV, cfg.n_heads // KV, cfg.hd)
            attn = ops.flash_prefill(qg, k, v, window=cfg.sliding_window)
        else:
            attn = attention(q, k, v, positions, positions, cfg.sliding_window,
                             cfg.attn_block_q, cfg.blockwise_from)
        return self.mlp(x + attn.reshape(B, S, -1) @ self.wo)


class Transformer(nn.Module):
    """The dense LM.  ``device`` defaults to CUDA and raises without a card
    unless ``"cpu"`` is asked for; ``generator`` (a ``torch.Generator`` on
    that device) draws the random init, a generator seeded 0 when None."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        cfg.validate()
        dev = resolve_device(device)
        self.cfg = cfg
        for name, shape in top_shapes(cfg).items():
            self.register_parameter(name, _param(shape, cfg, dev))
        self.layers = nn.ModuleList(DecoderLayer(cfg, dev) for _ in range(cfg.n_layers))
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        init_params(self, generator)

    def _embed(self, tokens):
        return self.embed[tokens.long()].to(self.cfg.dtype)

    def _logits(self, x):
        return (rms_norm(x, self.ln_f, self.cfg.norm_eps) @ self.lm_head).float()

    def hidden_states(self, tokens, positions=None) -> torch.Tensor:
        """Final-norm hidden states [B, S, d] (the pre-lm_head forward)."""
        S = tokens.shape[1]
        x = self._embed(tokens)
        pos = positions if positions is not None else torch.arange(S, device=x.device)
        for layer in self.layers:
            x = layer(x, pos)
        return rms_norm(x, self.ln_f, self.cfg.norm_eps)

    def forward(self, tokens, positions=None) -> torch.Tensor:
        """Logits f32 [B, S, vocab]."""
        return (self.hidden_states(tokens, positions) @ self.lm_head).float()

    def prefill(self, tokens, max_len: int):
        """Run the prompt ``tokens`` [B, S], building the KV cache.

        Returns (cache, logits f32 [B, vocab] of the last position).  Under
        a sliding window the cache keeps the last min(window, max_len)
        positions in a ring: position p sits in slot p % len."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self._embed(tokens)
        pos = torch.arange(S, device=x.device)
        win = cfg.sliding_window
        cache = cache_init(cfg, B, max_len, x.device)
        eff = cache["k"].shape[2]
        take = min(S, eff)
        roll = S % eff if S >= eff else 0
        for i, layer in enumerate(self.layers):
            h = rms_norm(x, layer.ln_attn, cfg.norm_eps)
            q, k, v = layer.qkv(h, pos)
            attn = attention(q, k, v, pos, pos, win, cfg.attn_block_q, cfg.blockwise_from)
            for buf, full in ((cache["k"][i], k), (cache["v"][i], v)):
                buf[:, :take] = full[:, S - take:]
                if roll:
                    buf.copy_(torch.roll(buf, roll, dims=1))
            x = layer.mlp(x + attn.reshape(B, S, -1) @ layer.wo)
        cache["index"] = S
        return cache, self._logits(x[:, -1])

    def decode_step(self, cache: dict, tokens):
        """One-token decode: ``tokens`` [B] -> (cache, logits f32 [B, vocab]).

        Writes the new K/V into ``cache`` in place at the ring slot
        (index % cache length), attends over the slots whose global
        position is valid (and inside the window), and advances
        ``cache["index"]``."""
        cfg = self.cfg
        B = tokens.shape[0]
        x = self._embed(tokens)[:, None, :]
        idx = cache["index"]
        T = cache["k"].shape[2]
        slot = idx % T
        dev = x.device
        pos_now = torch.full((B, 1), idx, dtype=torch.int32, device=dev)
        # global position stored in each ring slot (largest p <= idx, p % T == s)
        k_pos = idx - ((idx - torch.arange(T, device=dev)) % T)
        k_valid = (k_pos >= 0) & (k_pos <= idx)
        if cfg.sliding_window > 0:
            k_valid &= (idx - k_pos) < cfg.sliding_window
        KV, G, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
        for i, layer in enumerate(self.layers):
            h = rms_norm(x, layer.ln_attn, cfg.norm_eps)
            q, k_new, v_new = layer.qkv(h, pos_now)
            k_l, v_l = cache["k"][i], cache["v"][i]
            k_l[:, slot] = k_new[:, 0]
            v_l[:, slot] = v_new[:, 0]
            qg = q.reshape(B, 1, KV, G, hd)
            s = torch.einsum("bqkgh,btkh->bkgqt", qg.float(), k_l.float()) / math.sqrt(hd)
            s = torch.where(k_valid, s, -1e30)
            p = torch.softmax(s, dim=-1).to(v_l.dtype)
            o = torch.einsum("bkgqt,btkh->bqkgh", p.float(), v_l.float())
            x = layer.mlp(x + o.to(cfg.dtype).reshape(B, 1, -1) @ layer.wo)
        cache["index"] = idx + 1
        return cache, self._logits(x[:, 0])


def cache_init(cfg: TransformerConfig, batch: int, max_len: int, device=None) -> dict:
    """Zeroed KV cache: k, v [L, B, min(window, max_len) or max_len, KV, hd]
    in ``cfg.dtype``, and ``index`` (the next position) 0."""
    dev = resolve_device(device)
    eff = min(cfg.sliding_window, max_len) if cfg.sliding_window else max_len
    shape = (cfg.n_layers, batch, eff, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev), "index": 0}


@torch.no_grad()
def load_jax_params(model: Transformer, params: dict) -> None:
    """Load a JAX parameter tree (numpy leaves, e.g.
    ``jax.tree.map(np.asarray, repro.models.transformer.init(cfg, key))``)
    into ``model``, unstacking the ``[L, ...]`` layer stacks.  Leaves go
    through f32, which holds every bf16 value exactly (``torch.from_numpy``
    rejects numpy's bf16 type)."""
    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    top = set(top_shapes(model.cfg))
    stacked = set(layer_shapes(model.cfg))
    if set(params) != top | {"layers"} or set(params["layers"]) != stacked:
        raise ValueError(f"parameter tree {sorted(params)} / {sorted(params.get('layers', {}))} "
                         f"does not match the dense config's {sorted(top)} / {sorted(stacked)}")
    for name in top:
        getattr(model, name).copy_(tensor(params[name]))
    for name in stacked:
        stack = tensor(params["layers"][name])
        if stack.shape[0] != len(model.layers):
            raise ValueError(f"{name}: {stack.shape[0]} layers, model has {len(model.layers)}")
        for layer, w in zip(model.layers, stack):
            getattr(layer, name).copy_(w)
