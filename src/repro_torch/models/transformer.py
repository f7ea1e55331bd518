"""Transformer LM family: forward, prefill and decode (torch port).

The port of ``repro.models.transformer`` for the five decoders the JAX
package configures, dense (qwen2-7b, h2o-danube-3-4b, chatglm3-6b) and MoE
(qwen3-moe-235b-a22b, deepseek-v2-236b):

  * GQA attention with RoPE (full or partial rotary), optional QKV bias and
    sliding window, a KV cache with a ring layout under a sliding window;
  * MLA: a low-rank compressed KV stream (``kv_lora``) with decoupled RoPE
    dims, attended in the absorbed form, so the cache keeps only ``c_kv``
    [.., kv_lora] and ``k_rope`` [.., rope];
  * MoE: token-choice top-k routing through a float32 router, the
    sort-based dispatch with a per-expert capacity (assignments past it are
    dropped), optional shared experts; deepseek's leading dense layers come
    first in the one layer list.

The parameter layout is the JAX package's (``x @ w`` with ``w`` [in, out];
head h = kv * G + g; expert stacks [E, in, out]), one ``DecoderLayer``
module per layer instead of the ``dense_layers`` / ``layers`` scan stacks,
so :func:`load_jax_params` carries a JAX parameter tree across unchanged.

``DecoderLayer.forward`` takes the ``flash_prefill`` kernel for GQA when
``cfg.use_flash_prefill`` and S % 128 == 0, as the JAX package does (MLA
never does); ``prefill`` and ``decode_step`` compute attention with torch
ops whatever the flag says, as the JAX package's versions do.  A MoE
layer's combine sums each token's K expert contributions in ascending
expert order in the activations' dtype, the order of the JAX package's
scatter-add, so results do not depend on atomics.  Sharding constraints
(``_wsc``) have no meaning on one card and are not ported; the config
keeps their fields.

Training: the parameters are ordinary trainable ``nn.Parameter``s and
``forward`` is differentiable, as the JAX package's is.  :func:`loss_fn`
is the JAX ``loss_fn``: the next-token cross entropy, its head chunked
by ``cfg.loss_chunk`` with each chunk checkpointed (the backward
recomputes its ``[chunk, V]`` logits), and with ``cfg.remat`` the layer
stack rematerialised as the JAX ``_scan_stack`` does it (one checkpoint
per block of ``remat_block`` layers, and one per layer inside a block of
more than one).  The flash kernel has no backward: under grad it raises,
as JAX does differentiating its Pallas kernel, so a training forward
keeps ``use_flash_prefill`` off.  ``prefill`` and ``decode_step`` run
under ``torch.no_grad()`` (JAX never differentiates them; they write
their caches in place).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.engine.streaming import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.parallel import P, local


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
    # --- MoE ---
    n_experts: int = 0               # 0 = dense
    top_k: int = 0
    moe_d_ff: int = 0                # routed-expert hidden
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    n_dense_layers: int = 0          # leading dense layers (deepseek)
    capacity_factor: float = 1.25
    moe_chunk: int = 32768           # tokens per dispatch round
    # --- MLA (deepseek) ---
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
    remat: bool = True               # rematerialise the layer stack under grad
    remat_block: int = 1             # layers per remat block
    # multi-device fields of the JAX config, kept so configs carry over
    # field for field; one card does not read them
    scan_unroll: int = 1
    act_dp: tuple = ()
    act_tp: str = "model"
    act_seq: bool = False
    tp_size: int = 16
    attn_block_q: int = 1024         # blockwise attention chunk
    blockwise_from: int = 8192       # use blockwise attention above this S
    loss_chunk: int = 0              # tokens per checkpointed head chunk (0: one)
    use_flash_prefill: bool = False  # the flash_prefill kernel for full-seq GQA attention
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

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.n_dense_layers if self.is_moe else 0

    def layer_kinds(self) -> list[str]:
        """Each layer's FFN, in order: a MoE model's leading dense layers
        (the JAX ``dense_layers`` stack), then its MoE layers."""
        if not self.is_moe:
            return ["dense"] * self.n_layers
        return ["dense"] * self.n_dense_layers + ["moe"] * self.n_moe_layers

    def validate(self) -> None:
        """The JAX config's rules (``TransformerConfig.validate``)."""
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads {self.n_heads} is not a multiple of "
                             f"n_kv_heads {self.n_kv_heads}")
        if self.is_moe:
            if not 0 < self.top_k <= self.n_experts:
                raise ValueError(f"top_k {self.top_k} is not in 1 .. n_experts "
                                 f"{self.n_experts}")
            if not 0 <= self.n_dense_layers < self.n_layers:
                raise ValueError(f"n_dense_layers {self.n_dense_layers} is not in "
                                 f"0 .. n_layers - 1 = {self.n_layers - 1}")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def attn_shapes(cfg: TransformerConfig) -> dict[str, tuple[int, ...]]:
    """The attention half of one layer (the JAX ``_attn_shapes``)."""
    d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    sh = {"ln_attn": (d,), "ln_mlp": (d,),
          "wo": (H * (cfg.mla_v_dim if cfg.is_mla else hd), d)}
    if cfg.is_mla:
        qd = cfg.mla_nope_dim + cfg.mla_rope_dim
        if cfg.mla_q_lora:
            sh.update(w_dq=(d, cfg.mla_q_lora), w_uq=(cfg.mla_q_lora, H * qd))
        else:
            sh["wq"] = (d, H * qd)
        sh.update(w_dkv=(d, cfg.mla_kv_lora + cfg.mla_rope_dim),
                  w_uk=(cfg.mla_kv_lora, H * cfg.mla_nope_dim),
                  w_uv=(cfg.mla_kv_lora, H * cfg.mla_v_dim))
    else:
        sh.update(wq=(d, H * hd), wk=(d, KV * hd), wv=(d, KV * hd))
        if cfg.qkv_bias:
            sh.update(bq=(H * hd,), bk=(KV * hd,), bv=(KV * hd,))
    return sh


def layer_shapes(cfg: TransformerConfig, kind: str = "dense") -> dict[str, tuple[int, ...]]:
    """Shapes of one decoder layer of ``kind`` ``"dense"`` (SwiGLU MLP) or
    ``"moe"`` (routed experts [+ shared]): the JAX ``_layer_shapes``
    without the leading layer axis."""
    d = cfg.d_model
    sh = attn_shapes(cfg)
    if kind == "dense":
        sh.update(w1=(d, cfg.d_ff), w3=(d, cfg.d_ff), w2=(cfg.d_ff, d))
    elif kind == "moe":
        E, f = cfg.n_experts, cfg.moe_d_ff
        sh.update(router=(d, E), we1=(E, d, f), we3=(E, d, f), we2=(E, f, d))
        if cfg.n_shared_experts:
            sff = cfg.shared_d_ff or cfg.n_shared_experts * cfg.moe_d_ff
            sh.update(ws1=(d, sff), ws3=(d, sff), ws2=(sff, d))
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    return sh


def param_dtype(name: str, cfg: TransformerConfig) -> torch.dtype:
    """The router is float32 whatever ``cfg.dtype`` is, as in the JAX package."""
    return torch.float32 if name == "router" else cfg.dtype


def top_shapes(cfg: TransformerConfig) -> dict[str, tuple[int, ...]]:
    return {"embed": (cfg.vocab, cfg.d_model), "ln_f": (cfg.d_model,),
            "lm_head": (cfg.d_model, cfg.vocab)}


def param_specs(cfg: TransformerConfig, dp: tuple[str, ...] = ("data",),
                tp: str = "model", tp_size: int = 16, dp_size: int = 16) -> dict:
    """Partition specs keyed as ``named_parameters()`` (the JAX
    ``param_specs`` with the stacked layer axis dropped): Megatron-style
    TP on the head / hidden output dims, and FSDP: the other big dim of
    each weight over the data axes (the JAX ``fsdp=True``, the training
    layout; the serving layout without FSDP belongs to the bundles' pod
    shardings, still refused).  Head-aligned TP only: a GQA
    projection whose head count the model axis does not divide stays
    whole over it."""
    d_ok = cfg.d_model % dp_size == 0
    fs = dp if d_ok else None          # the FSDP split of dim d_model

    def attn_specs() -> dict:
        s = {"ln_attn": P(None), "ln_mlp": P(None), "wo": P(tp, fs)}
        if cfg.is_mla:
            if cfg.mla_q_lora:
                s["w_dq"] = P(fs, tp if cfg.mla_q_lora % tp_size == 0 else None)
                s["w_uq"] = P(fs if cfg.mla_q_lora % dp_size == 0 else None, tp)
            else:
                s["wq"] = P(fs, tp)
            kvl = cfg.mla_kv_lora + cfg.mla_rope_dim
            s["w_dkv"] = P(fs, tp if kvl % tp_size == 0 else None)
            lora_fs = fs if cfg.mla_kv_lora % dp_size == 0 else None
            s["w_uk"] = P(lora_fs, tp)
            s["w_uv"] = P(lora_fs, tp)
        else:
            q_ok = cfg.n_heads % tp_size == 0
            kv_ok = cfg.n_kv_heads % tp_size == 0
            s["wq"] = P(fs, tp if q_ok else None)
            s["wk"] = s["wv"] = P(fs, tp if kv_ok else None)
            s["wo"] = P(tp if q_ok else None, fs)
            if cfg.qkv_bias:
                s["bq"] = P(tp if q_ok else None)
                s["bk"] = s["bv"] = P(tp) if kv_ok else P(None)
        return s

    dense = {**attn_specs(), "w1": P(fs, tp), "w3": P(fs, tp), "w2": P(tp, fs)}
    moe = {**attn_specs(), "router": P(None, None),
           "we1": P(tp, fs, None), "we3": P(tp, fs, None), "we2": P(tp, None, fs)}
    if cfg.n_shared_experts:
        moe.update(ws1=P(fs, tp), ws3=P(fs, tp), ws2=P(tp, fs))
    out = {"embed": P(tp, fs), "ln_f": P(None), "lm_head": P(fs, tp)}
    for i, kind in enumerate(cfg.layer_kinds()):
        for name, spec in (moe if kind == "moe" else dense).items():
            out[f"layers.{i}.{name}"] = spec
    return out


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def bind_param(params: dict, name: str, shape, dtype) -> nn.Parameter:
    """The parameter ``name`` of a given tree, checked against the
    config's shape and dtype (a plain tensor is wrapped, sharing storage)."""
    if name not in params:
        raise ValueError(f"parameter {name} is missing")
    p = params[name]
    if tuple(p.shape) != tuple(shape) or p.dtype != dtype:
        raise ValueError(f"{name}: {tuple(p.shape)} {p.dtype}, the config's "
                         f"{tuple(shape)} {dtype}")
    return p if isinstance(p, nn.Parameter) else nn.Parameter(p)


def model_device(device) -> torch.device:
    """The device a model is built on: ``"meta"`` (shapes and dtypes only,
    nothing allocated or drawn, as the JAX ``init_abstract``) or what
    :func:`~repro_torch.engine.streaming.resolve_device` gives."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Random init as the JAX ``init``: ``ln_*`` ones, ``b*`` zeros, every
    other weight (the 3-D expert stacks too) normal * 1/sqrt(fan_in)
    (fan_in = shape[-2]) drawn in f32 and cast to the parameter's dtype.
    The draws differ from JAX's."""
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


def _query_blocks(S: int, block_q: int, blockwise_from: int) -> list[slice]:
    """One slice over the whole sequence, or query blocks of ``block_q``
    above ``blockwise_from`` (when they divide S), so the [S, T] scores
    never fully exist."""
    if S <= blockwise_from or S % block_q != 0:
        return [slice(0, S)]
    return [slice(i, i + block_q) for i in range(0, S, block_q)]


def attention(q, k, v, q_pos, k_pos, window: int = 0,
              block_q: int = 1024, blockwise_from: int = 8192) -> torch.Tensor:
    """GQA attention with torch ops.  q: [B,S,H,hd], k/v: [B,T,KV,hd] ->
    [B,S,H,hd].  Products are taken in f32 from the inputs' values and
    ``p`` is cast to ``v.dtype`` before PV, as in the JAX package."""
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

    out = torch.cat([blk(qg[:, sl], q_pos[sl])
                     for sl in _query_blocks(S, block_q, blockwise_from)], dim=1)
    return out.reshape(B, S, H, hd).to(q.dtype)


def mla_attention(q_nope, q_rope, c_kv, k_rope, w_uk, w_uv, cfg: TransformerConfig,
                  q_pos, k_pos, k_valid=None) -> torch.Tensor:
    """Absorbed MLA attention over the compressed stream (the JAX
    ``_mla_attention``):

      score = ((q_nope W_uk^T) . c_kv + q_rope . k_rope) / sqrt(nope + rope)
      out_h = softmax(score) . c_kv @ W_uv_h

    q_nope [B,S,H,nope], q_rope [B,S,H,rope], c_kv [B,T,kv_lora],
    k_rope [B,T,rope] -> [B,S,H,v_dim] in ``cfg.dtype``.  Scores and the
    context are f32 products of the operands' values, ``q_nope W_uk^T`` is
    rounded to ``c_kv``'s dtype first and the softmax weights before the
    context, as in the JAX package; blockwise above ``cfg.blockwise_from``.
    ``k_valid`` [T] masks cache slots (decode)."""
    B, S, H, nd = q_nope.shape
    Lr = cfg.mla_kv_lora
    q_abs = torch.einsum("bshn,lhn->bshl", q_nope.float(), w_uk.reshape(Lr, H, nd).float())
    scale = 1.0 / math.sqrt(nd + cfg.mla_rope_dim)
    c32, r32 = c_kv.float(), k_rope.float()

    def blk(qa, qr, qpb):
        s = torch.einsum("bshl,btl->bhst", qa.to(c_kv.dtype).float(), c32)
        s = (s + torch.einsum("bshr,btr->bhst", qr.float(), r32)) * scale
        mask = _attn_mask(qpb, k_pos, cfg.sliding_window)
        if k_valid is not None:
            mask = mask & k_valid[None, :]
        s = torch.where(mask, s, -1e30)
        p = torch.softmax(s, dim=-1).to(c_kv.dtype)
        return torch.einsum("bhst,btl->bshl", p.float(), c32)

    ctx = torch.cat([blk(q_abs[:, sl], q_rope[:, sl], q_pos[sl])
                     for sl in _query_blocks(S, cfg.attn_block_q, cfg.blockwise_from)], dim=1)
    out = torch.einsum("bshl,lhv->bshv", ctx, w_uv.reshape(Lr, H, cfg.mla_v_dim).float())
    return out.to(cfg.dtype)


def swiglu(x, w1, w3, w2):
    return (F.silu(x @ w1) * (x @ w3)) @ w2


# ---------------------------------------------------------------------------
# MoE: token-choice top-k with the static-shape sort-based dispatch
# ---------------------------------------------------------------------------
def moe_capacity(T: int, cfg: TransformerConfig) -> int:
    """Slots per expert for a chunk of T tokens, as the JAX package
    computes it (in this order, in Python floats); at T <= 256 (decode,
    tiny batches) it covers every token, so serving never drops."""
    C = max(int(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 1)
    return max(C, T) if T <= 256 else C


class DispatchPlan(NamedTuple):
    """One chunk's routing: the T * K (token, expert) assignments sorted
    stably by expert.  ``pos_in_e`` is an assignment's slot in its expert's
    buffer, ``keep`` whether that slot is below ``capacity``; ``gates`` are
    the renormalised top-k gates in the same order."""
    e_sorted: torch.Tensor   # int64 [T*K]
    t_sorted: torch.Tensor   # int64 [T*K]
    pos_in_e: torch.Tensor   # int64 [T*K]
    keep: torch.Tensor       # bool [T*K]
    gates: torch.Tensor      # f32 [T*K]
    capacity: int


def moe_dispatch_plan(x: torch.Tensor, router: torch.Tensor,
                      cfg: TransformerConfig) -> DispatchPlan:
    """The JAX ``_moe_ffn_chunk``'s routing for x [T, d]: an f32 router,
    softmax, top-k, the gates renormalised, then the stable sort of the
    flat expert ids, the per-expert counts and each assignment's slot."""
    T = x.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    gates = torch.softmax(x.float() @ router, dim=-1)
    top_g, top_e = torch.topk(gates, K, dim=-1)
    top_g = top_g / top_g.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = top_e.reshape(-1)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    # the per-expert counts by a scatter-add (``bincount``'s output length
    # depends on the data, so it has no ``meta`` form)
    counts = torch.zeros(E, dtype=flat_e.dtype, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * K, device=x.device) - starts[e_sorted]
    C = moe_capacity(T, cfg)
    return DispatchPlan(e_sorted, flat_t[order], pos_in_e, pos_in_e < C,
                        top_g.reshape(-1)[order], C)


def _moe_ffn_chunk(x: torch.Tensor, lp: nn.Module, cfg: TransformerConfig) -> torch.Tensor:
    """x: [T, d] -> [T, d]: dispatch into the [E, C, d] buffer (overflow
    past capacity drops), the expert SwiGLUs as batched products over all
    E experts, the gated combine, then the shared experts.

    The dispatch is the JAX package's scatter-add: every assignment adds
    ``x[t] * keep`` at ``(e, pos)``, a dropped one at slot (0, 0).  The
    buffer starts at zero and each slot receives at most one kept row, so
    every other add is of zeros and the buffer equals the boolean-index
    store exactly, with no ``nonzero`` (no host sync, and a ``meta`` form).

    On a mesh (``lp.par``) the experts are split over "model": this rank
    routes every token, keeps the assignments to its own experts, and the
    partial outputs are summed over "model" (the shared experts are
    split by hidden units, as a dense layer's MLP)."""
    T, d = x.shape
    K = cfg.top_k
    plan = moe_dispatch_plan(x, lp.w("router"), cfg)
    keep, e_sorted, gates = plan.keep, plan.e_sorted, plan.gates
    E = cfg.n_experts
    split = lp.split("we1")
    xr = x
    if split:
        lo, hi = lp.par.model_range(E)
        E = hi - lo
        keep = keep & (e_sorted >= lo) & (e_sorted < hi)
        e_sorted = e_sorted - lo
        xr, gates = lp.enter(x), lp.enter(gates)
    e_at = torch.where(keep, e_sorted, 0)
    pos_at = torch.where(keep, plan.pos_in_e, 0)
    buf = x.new_zeros((E, plan.capacity, d))
    buf = buf.index_put((e_at, pos_at), xr[plan.t_sorted] * keep[:, None].to(x.dtype),
                        accumulate=True)
    h = F.silu(torch.bmm(buf, lp.w("we1"))) * torch.bmm(buf, lp.w("we3"))
    y_e = torch.bmm(h, lp.w("we2"))                                 # [E, C, d]
    contrib = y_e[e_at, pos_at]
    contrib = contrib * (gates * keep).to(contrib.dtype)[:, None]
    # each token's K contributions in the sorted order (ascending expert),
    # added one at a time in their dtype: the JAX scatter-add's order
    per_token = torch.argsort(plan.t_sorted, stable=True).view(T, K)
    y = contrib[per_token[:, 0]]
    for j in range(1, K):
        y = y + contrib[per_token[:, j]]
    y = lp.exit(y, split)
    if cfg.n_shared_experts:
        y = y + lp.swiglu("ws1", "ws3", "ws2", x)
    return y.to(x.dtype)


def moe_ffn(x: torch.Tensor, lp: nn.Module, cfg: TransformerConfig,
            bs: tuple[int, int] | None = None) -> torch.Tensor:
    """x: [T, d] -> [T, d].  Above ``cfg.moe_chunk`` tokens, with ``bs`` =
    (B, S) given and S a multiple of s_ck = max(moe_chunk // B, 1), the
    dispatch runs on sequence chunks of s_ck (capacity per chunk), as in
    the JAX package; ``decode_step`` passes no ``bs`` and is never chunked."""
    T, d = x.shape
    chunk = cfg.moe_chunk
    if not chunk or T <= chunk or bs is None:
        return _moe_ffn_chunk(x, lp, cfg)
    B, S = bs
    s_ck = max(chunk // B, 1)
    if S % s_ck != 0:
        return _moe_ffn_chunk(x, lp, cfg)
    xs = x.reshape(B, S // s_ck, s_ck, d)
    ys = [_moe_ffn_chunk(xs[:, i].reshape(B * s_ck, d), lp, cfg).reshape(B, s_ck, d)
          for i in range(S // s_ck)]
    return torch.stack(ys, dim=1).reshape(T, d)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------
class _MeshModule(nn.Module):
    """A module that computes on one device (``par`` None) or on a mesh
    (``par`` a :class:`~repro_torch.models.parallel.MeshParallel`, its
    parameters DTensors)."""
    par = None

    def w(self, name: str, keep_tp: bool = True) -> torch.Tensor:
        """The weight ``name`` to compute with: the parameter itself on one
        device; on a mesh its local tensor, whole over "data" and split over
        "model" as stored (``keep_tp``) or whole."""
        p = getattr(self, name)
        return p if self.par is None else self.par.weight(p, keep_tp)

    def split(self, name: str) -> bool:
        """Whether ``name`` is stored split over "model" (never on one device)."""
        return self.par is not None and self.par.split(getattr(self, name))

    def enter(self, x, on: bool = True):
        """``x`` entering a region split over "model" (identity when ``on``
        is False or on one device)."""
        return self.par.enter(x) if on and self.par is not None else x

    def exit(self, y, on: bool = True):
        """The partial results ``y`` of a split region summed over "model"."""
        return self.par.exit(y) if on and self.par is not None else y


class DecoderLayer(_MeshModule):
    """One decoder layer of ``kind`` "dense" or "moe"; parameters named as
    the JAX layer stacks'."""

    def __init__(self, cfg: TransformerConfig, device, kind: str = "dense",
                 params: dict | None = None, par=None):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.par = par
        for name, shape in layer_shapes(cfg, kind).items():
            dt = param_dtype(name, cfg)
            self.register_parameter(name, _param(shape, dt, device) if params is None
                                    else bind_param(params, name, shape, dt))

    def mla_heads_split(self) -> bool:
        """Whether the MLA head-indexed weights (``w_uq`` / ``wq``, ``w_uk``,
        ``w_uv``, ``wo``) stay split over "model": when it divides the head
        count (they are stored split by columns either way) and it has more
        than one rank."""
        return self.par is not None and self.par.tp > 1 and self.cfg.n_heads % self.par.tp == 0

    def qkv(self, x, positions):
        """The JAX ``_qkv_gqa``: projections, optional bias, RoPE.  On a
        mesh the heads the stored weights split over "model" are this
        rank's; where the query heads are split and the KV heads are not,
        each local query head gets its own KV head (k, v [B, S, H_local,
        hd])."""
        cfg = self.cfg
        B, S, _ = x.shape
        hd = cfg.hd
        q_split, kv_split = self.split("wq"), self.split("wk")
        q = self.enter(x, q_split) @ self.w("wq")
        xkv = self.enter(x, kv_split)
        k, v = xkv @ self.w("wk"), xkv @ self.w("wv")
        if cfg.qkv_bias:
            q, k, v = q + self.w("bq"), k + self.w("bk"), v + self.w("bv")
        if q_split and not kv_split:
            k, v = self.enter(k), self.enter(v)
        q = q.reshape(B, S, -1, hd)
        k = k.reshape(B, S, -1, hd)
        v = v.reshape(B, S, -1, hd)
        rd = int(cfg.rotary_pct * hd)
        q, k = rope(q, positions, cfg.rope_theta, rd), rope(k, positions, cfg.rope_theta, rd)
        if q_split and not kv_split:
            G = cfg.n_heads // cfg.n_kv_heads
            lo, hi = self.par.model_range(cfg.n_heads)
            kv_of = torch.arange(lo, hi, device=q.device) // G
            k, v = k[:, :, kv_of], v[:, :, kv_of]
        return q, k, v

    def qkv_mla(self, x, positions):
        """The JAX ``_qkv_mla``: (q_nope, q_rope, c_kv, k_rope); the last
        two are the cacheable compressed stream."""
        cfg = self.cfg
        B, S, _ = x.shape
        nd, rd = cfg.mla_nope_dim, cfg.mla_rope_dim
        hs = self.mla_heads_split()
        if cfg.mla_q_lora:
            q = self.enter(x @ self.w("w_dq", keep_tp=False), hs) @ self.w("w_uq", hs)
        else:
            q = self.enter(x, hs) @ self.w("wq", hs)
        q = q.reshape(B, S, -1, nd + rd)
        q_rope = rope(q[..., nd:], positions, cfg.rope_theta)
        ckv = x @ self.w("w_dkv", keep_tp=False)
        k_rope = rope(ckv[..., cfg.mla_kv_lora:][:, :, None, :], positions, cfg.rope_theta)
        return q[..., :nd], q_rope, ckv[..., :cfg.mla_kv_lora], k_rope[:, :, 0]

    def attend(self, h, positions, flash: bool = False):
        """Full-sequence attention of the normed input h [B, S, d]:
        (output [B, S, H * v_dim] before ``wo``, the layer's cache entries
        (k, v) or (c_kv, k_rope)).  ``flash`` takes the flash_prefill
        kernel (GQA, S % 128 == 0)."""
        cfg = self.cfg
        B, S, _ = h.shape
        if cfg.is_mla:
            qn, qr, ckv, kr = self.qkv_mla(h, positions)
            hs = self.mla_heads_split()
            attn = mla_attention(qn, qr, self.enter(ckv, hs), self.enter(kr, hs),
                                 self.w("w_uk", hs), self.w("w_uv", hs), cfg,
                                 positions, positions)
            return attn.reshape(B, S, -1), (ckv, kr)
        q, k, v = self.qkv(h, positions)
        if flash:
            KV = cfg.n_kv_heads
            qg = q.reshape(B, S, KV, cfg.n_heads // KV, cfg.hd)
            attn = ops.flash_prefill(qg, k, v, window=cfg.sliding_window)
        else:
            attn = attention(q, k, v, positions, positions, cfg.sliding_window,
                             cfg.attn_block_q, cfg.blockwise_from)
        return attn.reshape(B, S, -1), (k, v)

    def ffn(self, x, bs: tuple[int, int] | None = None):
        """The JAX ``_ffn`` on normed tokens x [T, d].  On a mesh a MoE
        layer routes the global batch (every "data" rank's tokens, so the
        capacity is the global token set's) and keeps this rank's rows."""
        if self.kind == "moe":
            if self.par is None or bs is None or self.par.dp == 1:
                return moe_ffn(x, self, self.cfg, bs)
            lo = self.par.dp_rank * x.shape[0]
            xa = self.par.gather_rows(x)
            y = moe_ffn(xa, self, self.cfg, (bs[0] * self.par.dp, bs[1]))
            return y[lo:lo + x.shape[0]]
        return self.swiglu("w1", "w3", "w2", x)

    def swiglu(self, n1: str, n3: str, n2: str, x):
        """SwiGLU by the weights ``n1``, ``n3``, ``n2``; on a mesh split over
        "model" by hidden units (column- then row-parallel)."""
        split = self.split(n1)
        y = swiglu(self.enter(x, split), self.w(n1), self.w(n3), self.w(n2))
        return self.exit(y, split)

    def out_proj(self, attn):
        """``attn @ wo``; on a mesh summed over "model" when ``wo`` is split
        by heads (always for MLA when the heads split)."""
        split = self.mla_heads_split() if self.cfg.is_mla else self.split("wo")
        return self.exit(attn @ self.w("wo", split), split)

    def mlp(self, x):
        """x + FFN(rms_norm(x)) over a full sequence x [B, S, d]."""
        B, S, d = x.shape
        h = rms_norm(x, self.w("ln_mlp"), self.cfg.norm_eps)
        return x + self.ffn(h.reshape(B * S, d), (B, S)).reshape(B, S, d)

    def forward(self, x, positions):
        """The JAX ``layer_fwd``: one layer over the full sequence."""
        cfg = self.cfg
        h = rms_norm(x, self.w("ln_attn"), cfg.norm_eps)
        flash = cfg.use_flash_prefill and not cfg.is_mla and x.shape[1] % 128 == 0
        attn, _ = self.attend(h, positions, flash)
        return self.mlp(x + self.out_proj(attn))


class Transformer(_MeshModule):
    """The LM.  ``device`` defaults to CUDA and raises without a card
    unless ``"cpu"`` is asked for; ``generator`` (a ``torch.Generator`` on
    that device) draws the random init, a generator seeded 0 when None.
    ``device="meta"`` builds the shapes only (:func:`init_abstract`).
    ``params`` (a dict keyed as ``named_parameters()``) binds the model to
    those tensors, unchanged and not re-drawn, on their device: the step
    functions of ``repro_torch.configs.lm_family`` run the model on a
    parameter tree this way.  ``layers`` holds every layer, a MoE model's
    dense ones first.

    ``par`` (a :class:`~repro_torch.models.parallel.MeshParallel`, with
    ``params`` DTensors placed by :func:`param_specs`) runs the training
    forward on a mesh: this rank's batch rows, the weights gathered layer
    by layer.  ``prefill`` and ``decode_step`` run on one device only."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 generator: torch.Generator | None = None, params: dict | None = None,
                 par=None):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.par = par
        if par is not None and params is None:
            raise ValueError("a mesh model is bound to placed parameters (params=)")
        if params is not None:
            for name, shape in top_shapes(cfg).items():
                self.register_parameter(name, bind_param(params, name, shape, cfg.dtype))
            dev = self.embed.device
            self.layers = nn.ModuleList(
                DecoderLayer(cfg, dev, kind, params={
                    k.split(".", 2)[2]: v for k, v in params.items()
                    if k.startswith(f"layers.{i}.")}, par=par)
                for i, kind in enumerate(cfg.layer_kinds()))
            if len(params) != sum(1 for _ in self.parameters()):
                raise ValueError("params holds names the config does not have")
            return
        dev = model_device(device)
        for name, shape in top_shapes(cfg).items():
            self.register_parameter(name, _param(shape, cfg.dtype, dev))
        self.layers = nn.ModuleList(DecoderLayer(cfg, dev, kind) for kind in cfg.layer_kinds())
        if dev.type == "meta":
            return
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        init_params(self, generator)

    def _embed(self, tokens):
        if not self.split("embed"):
            return self.w("embed")[tokens.long()].to(self.cfg.dtype)
        # the table's rows split over "model": each rank looks up the ids
        # in its range, the rows are summed over "model"
        lo, hi = self.par.model_range(self.cfg.vocab)
        ids = tokens.long()
        inside = (ids >= lo) & (ids < hi)
        rows = self.w("embed")[(ids - lo).clamp(0, max(hi - lo - 1, 0))]
        return self.exit(rows * inside[..., None]).to(self.cfg.dtype)

    def head(self, x, w=None) -> torch.Tensor:
        """f32 logits ``x @ lm_head`` of hidden states x [..., d]; on a mesh
        split over "model", each rank's vocabulary columns concatenated.
        ``w``: ``self.w("lm_head")`` taken once by a caller that runs the
        head several times."""
        w = self.w("lm_head") if w is None else w
        if not self.split("lm_head"):
            return (x @ w).float()
        y = self.enter(x) @ w
        return self.par.gather_model(y, -1, self.cfg.vocab).float()

    def _logits(self, x):
        return (rms_norm(x, self.ln_f, self.cfg.norm_eps) @ self.lm_head).float()

    def hidden_states(self, tokens, positions=None) -> torch.Tensor:
        """Final-norm hidden states [B, S, d] (the pre-lm_head forward):
        the dense stack, then the MoE stack, each as :func:`_run_stack`."""
        S = tokens.shape[1]
        x = self._embed(tokens)
        pos = positions if positions is not None else torch.arange(S, device=x.device)
        nd = self.cfg.n_dense_layers if self.cfg.is_moe else 0
        for stack in (self.layers[:nd], self.layers[nd:]):
            x = _run_stack(x, list(stack), self.cfg, pos)
        return rms_norm(x, self.w("ln_f"), self.cfg.norm_eps)

    def forward(self, tokens, positions=None) -> torch.Tensor:
        """Logits f32 [B, S, vocab]."""
        return self.head(self.hidden_states(tokens, positions))

    @torch.no_grad()
    def prefill(self, tokens, max_len: int):
        """Run the prompt ``tokens`` [B, S], building the cache.

        Returns (cache, logits f32 [B, vocab] of the last position).  Under
        a sliding window the cache keeps the last min(window, max_len)
        positions in a ring: position p sits in slot p % len."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self._embed(tokens)
        pos = torch.arange(S, device=x.device)
        win = cfg.sliding_window
        eff = min(win, max_len) if win > 0 else max_len
        cache = _cache_alloc(cfg, B, eff, x.device)
        bufs = (cache["c_kv"], cache["k_rope"]) if cfg.is_mla else (cache["k"], cache["v"])
        take = min(S, eff)
        roll = S % eff if S >= eff else 0
        for i, layer in enumerate(self.layers):
            h = rms_norm(x, layer.ln_attn, cfg.norm_eps)
            attn, stash = layer.attend(h, pos)
            for buf, full in zip((bufs[0][i], bufs[1][i]), stash):
                buf[:, :take] = full[:, S - take:]
                if roll:
                    buf.copy_(torch.roll(buf, roll, dims=1))
            x = layer.mlp(x + attn @ layer.wo)
        cache["index"] = S
        return cache, self._logits(x[:, -1])

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens):
        """One-token decode: ``tokens`` [B] -> (cache, logits f32 [B, vocab]).

        Writes the new cache entries in place at the ring slot (index %
        cache length), attends over the slots whose global position is
        valid (and inside the window), and advances ``cache["index"]``.  A
        MoE layer dispatches the B tokens unchunked (capacity >= B at
        B <= 256)."""
        cfg = self.cfg
        B = tokens.shape[0]
        x = self._embed(tokens)[:, None, :]
        T = (cache["c_kv"] if cfg.is_mla else cache["k"]).shape[2]
        dev = x.device
        idx = cache["index"]
        if isinstance(idx, torch.Tensor):
            # a device scalar (the dry-run's ``meta`` cache): no host read
            idx = idx.to(torch.int64)
            slot = (idx % T).reshape(1)
            pos_now = idx.to(torch.int32).expand(B, 1)
        else:
            # a host int: filled in place, no host-to-device copy (and sync)
            slot = torch.full((1,), idx % T, dtype=torch.int64, device=dev)
            pos_now = torch.full((B, 1), idx, dtype=torch.int32, device=dev)
        # global position stored in each ring slot (largest p <= idx, p % T == s)
        k_pos = idx - ((idx - torch.arange(T, device=dev)) % T)
        k_valid = (k_pos >= 0) & (k_pos <= idx)
        if cfg.sliding_window > 0:
            k_valid &= (idx - k_pos) < cfg.sliding_window
        KV, G, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
        for i, layer in enumerate(self.layers):
            h = rms_norm(x, layer.ln_attn, cfg.norm_eps)
            if cfg.is_mla:
                qn, qr, c_new, r_new = layer.qkv_mla(h, pos_now)
                c_l, r_l = cache["c_kv"][i], cache["k_rope"][i]
                c_l.index_copy_(1, slot, c_new)
                r_l.index_copy_(1, slot, r_new)
                attn = mla_attention(qn, qr, c_l, r_l, layer.w_uk, layer.w_uv, cfg,
                                     pos_now[0], k_pos, k_valid)
            else:
                q, k_new, v_new = layer.qkv(h, pos_now)
                k_l, v_l = cache["k"][i], cache["v"][i]
                k_l.index_copy_(1, slot, k_new)
                v_l.index_copy_(1, slot, v_new)
                qg = q.reshape(B, 1, KV, G, hd)
                s = torch.einsum("bqkgh,btkh->bkgqt", qg.float(), k_l.float()) / math.sqrt(hd)
                s = torch.where(k_valid, s, -1e30)
                p = torch.softmax(s, dim=-1).to(v_l.dtype)
                attn = torch.einsum("bkgqt,btkh->bqkgh", p.float(), v_l.float()).to(cfg.dtype)
            x = x + attn.reshape(B, 1, -1) @ layer.wo
            h2 = rms_norm(x, layer.ln_mlp, cfg.norm_eps)
            x = x + layer.ffn(h2.reshape(B, -1)).reshape(B, 1, -1)
        cache["index"] = cache["index"] + 1
        return cache, self._logits(x[:, 0])


def remat(fn, *args):
    """``fn(*args)`` under a checkpoint when grad mode is on (the backward
    recomputes it; nothing inside is saved), else a plain call."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _run_stack(x, layers: list, cfg: TransformerConfig, positions) -> torch.Tensor:
    """The JAX ``_scan_stack`` over ``layers``: blocks of ``bk`` layers
    (the largest divisor of the stack's depth up to ``cfg.remat_block``).
    With ``cfg.remat`` each block is one checkpoint, so the backward keeps
    one activation per block, and a block of more than one layer also
    checkpoints each layer, so its recompute holds one layer's
    intermediates at a time."""
    n = len(layers)
    if not n or not cfg.remat:
        for layer in layers:
            x = layer(x, positions)
        return x
    bk = max(k for k in range(1, min(cfg.remat_block, n) + 1) if n % k == 0)

    def block(x, i):
        for layer in layers[i:i + bk]:
            x = remat(layer, x, positions) if bk > 1 else layer(x, positions)
        return x

    for i in range(0, n, bk):
        x = remat(block, x, i)
    return x


def _ce_terms(logits: torch.Tensor, labels: torch.Tensor):
    """(sum of the nll, count) for one block of f32 logits [N, V] (the JAX
    ``_ce_terms``): the gold logit by a masked reduction over the
    vocabulary; labels below 0 are masked out."""
    logz = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    sel = vocab == labels.clamp_min(0)[..., None]
    gold = torch.where(sel, logits, 0.0).sum(dim=-1)
    mask = labels >= 0
    return ((logz - gold) * mask).sum(), mask.sum()


def loss_terms(model: Transformer, tokens, labels):
    """(sum of the nll, count of labels >= 0) of ``model`` on ``tokens``
    [B, S] against ``labels`` [B, S].  When ``cfg.loss_chunk`` divides
    T = B * S and T exceeds it, the head runs chunk by chunk, each
    checkpointed, so the live logits are [chunk, V] and the backward
    recomputes them."""
    cfg = model.cfg
    x = model.hidden_states(tokens)
    B, S, d = x.shape
    T = B * S
    xt, lt = x.reshape(T, d), labels.reshape(T)
    ck = cfg.loss_chunk
    if ck and T > ck and T % ck == 0:
        # the head's weight taken once: the chunks' gradients add up in one
        # tensor (on a mesh, each take's DTensor gradient would be added
        # out of place, a transient copy of the whole head)
        w = model.w("lm_head")

        def chunk_terms(xc, lc):
            return _ce_terms(model.head(xc, w), lc)

        terms = [remat(chunk_terms, xt[i:i + ck], lt[i:i + ck]) for i in range(0, T, ck)]
        return torch.stack([t[0] for t in terms]).sum(), torch.stack([t[1] for t in terms]).sum()
    return _ce_terms(model.head(xt), lt)


def loss_fn(model: Transformer, tokens, labels) -> torch.Tensor:
    """Mean next-token cross entropy of ``model`` on ``tokens`` [B, S]
    against ``labels`` [B, S] (the JAX ``loss_fn``): the nll summed over
    the batch over the count of labels >= 0 (:func:`loss_terms`).  On a
    mesh ``tokens`` and ``labels`` are this rank's rows (local tensors or
    the DTensors of ``shard_batch``) and the count is the global batch's:
    the result is this rank's share of the global mean, whose sum over
    "data" (:func:`~repro_torch.models.parallel.MeshParallel.sum_data`) is
    the loss and whose gradients are this rank's partial sums."""
    nll, cnt = loss_terms(model, local(tokens), local(labels))
    if model.par is not None:
        cnt = model.par.sum_data(cnt)
    return nll / cnt.clamp_min(1)


def _cache_alloc(cfg: TransformerConfig, batch: int, slots: int, dev) -> dict:
    L = cfg.n_layers

    def zeros(*shape):
        return torch.zeros((L, batch, slots, *shape), dtype=cfg.dtype, device=dev)

    if cfg.is_mla:
        return {"c_kv": zeros(cfg.mla_kv_lora), "k_rope": zeros(cfg.mla_rope_dim), "index": 0}
    return {"k": zeros(cfg.n_kv_heads, cfg.hd), "v": zeros(cfg.n_kv_heads, cfg.hd), "index": 0}


def init_abstract(cfg: TransformerConfig) -> dict:
    """The parameters as ``meta`` tensors keyed as ``named_parameters()``
    (the JAX ``init_abstract``): shapes and dtypes, nothing allocated."""
    return dict(Transformer(cfg, device="meta").named_parameters())


def cache_abstract(cfg: TransformerConfig, batch: int, max_len: int) -> dict:
    """The cache of :func:`cache_init` as ``meta`` tensors (the JAX
    ``cache_abstract``), ``index`` an int32 scalar as in the JAX cache."""
    win = cfg.sliding_window
    slots = min(win, max_len) if win and not cfg.is_mla else max_len
    cache = _cache_alloc(cfg, batch, slots, torch.device("meta"))
    cache["index"] = torch.zeros((), dtype=torch.int32, device="meta")
    return cache


def cache_init(cfg: TransformerConfig, batch: int, max_len: int, device=None) -> dict:
    """Zeroed cache in ``cfg.dtype`` with ``index`` (the next position) 0,
    shaped as the JAX ``cache_shapes``: GQA k, v [L, B, min(window, max_len)
    or max_len, KV, hd]; MLA c_kv [L, B, max_len, kv_lora] and k_rope
    [L, B, max_len, rope].  Layer i runs across both stacks, dense first."""
    dev = resolve_device(device)
    win = cfg.sliding_window
    slots = min(win, max_len) if win and not cfg.is_mla else max_len
    return _cache_alloc(cfg, batch, slots, dev)


@torch.no_grad()
def load_jax_params(model: Transformer, params: dict) -> None:
    """Load a JAX parameter tree (numpy leaves, e.g.
    ``jax.tree.map(np.asarray, repro.models.transformer.init(cfg, key))``)
    into ``model``, unstacking the ``[L, ...]`` stacks (``dense_layers``
    then ``layers``) into ``model.layers`` in order.  Leaves go through
    f32, which holds every bf16 value exactly (``torch.from_numpy`` rejects
    numpy's bf16 type); each parameter keeps its dtype (the router f32)."""
    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    cfg = model.cfg
    nd = cfg.n_dense_layers if cfg.is_moe else 0
    stacks = {}  # JAX stack name -> (layer kind, its layers in model.layers)
    if nd:
        stacks["dense_layers"] = ("dense", model.layers[:nd])
    stacks["layers"] = ("moe" if cfg.is_moe else "dense", model.layers[nd:])
    top = set(top_shapes(cfg))
    want = {key: set(layer_shapes(cfg, kind)) for key, (kind, _) in stacks.items()}
    if set(params) != top | set(want) or any(set(params[k]) != v for k, v in want.items()):
        got = {k: sorted(v) if isinstance(v, dict) else "leaf" for k, v in params.items()}
        raise ValueError(f"parameter tree {got} does not match the config's "
                         f"{sorted(top)} + {({k: sorted(v) for k, v in want.items()})}")
    for name in top:
        getattr(model, name).copy_(tensor(params[name]))
    for key, (_, layers) in stacks.items():
        for name in want[key]:
            stack = tensor(params[key][name])
            if stack.shape[0] != len(layers):
                raise ValueError(f"{key}.{name}: {stack.shape[0]} layers, the model has "
                                 f"{len(layers)}")
            for layer, w in zip(layers, stack):
                getattr(layer, name).copy_(w)
