"""LM-family bundle implementation (5 transformer archs x 4 shapes; torch
port of ``repro.configs.lm_family``).

Shapes:
  train_4k    — train_step (fwd + bwd + AdamW) on [256, 4096] tokens
  prefill_32k — serve prefill on [32, 32768] tokens -> (KV cache, logits)
  decode_32k  — one-token decode with a 32k KV cache, batch 128
  long_500k   — one-token decode with a 524288-position context; only
                for sub-quadratic (SWA) archs — pure full-attention archs
                skip it

``shardings`` gives the JAX package's layouts: the training cells' FSDP
+ TP parameters (``param_specs(fsdp=True)``), the serving cells' weights
resident per TP shard where they fit (``_serve_needs_fsdp``), the batch
over the data axes where they divide it, the cache by ``cache_specs`` and
the logits over "model".  The parameter tree is
``Transformer.named_parameters()`` (``nn.Parameter`` leaves); each step
binds a model to it (``Transformer(cfg, params=...)``), on the mesh in use
(``parallel.use_mesh``) with the arguments placed by ``shardings``
(``parallel.place_tree``), else on their device.  The step's config carries
the cell's activation layout (``_act_cfg``): the train cells split the
layer carry on the sequence over "model" (``act_seq``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import base
from repro_torch.engine.streaming import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.parallel import P, mesh_parallel
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim.adamw import make_train_step as _opt_step

OPT = AdamW(lr=cosine_schedule(3e-4, 2000, 100_000), weight_decay=0.1)

SHAPES = {
    "train_4k": base.ShapeCell("train_4k", "train",
                               {"seq": 4096, "batch": 256}),
    "prefill_32k": base.ShapeCell("prefill_32k", "prefill",
                                  {"seq": 32768, "batch": 32}),
    "decode_32k": base.ShapeCell("decode_32k", "decode",
                                 {"seq": 32768, "batch": 128}),
    "long_500k": base.ShapeCell("long_500k", "decode",
                                {"seq": 524288, "batch": 1}),
}

SKIP_LONG = ("pure full-attention decoder: 524288-token decode has no "
             "sub-quadratic structure; skipped per assignment rule "
             "(see DESIGN.md §4)")


def make_train_step(cfg: T.TransformerConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: the next-token loss of a model bound to
    ``params``, its gradients, one AdamW step (parameters updated in place)."""
    return _opt_step(
        lambda p, b: T.loss_fn(T.Transformer(cfg, params=p), b["tokens"], b["labels"]), OPT)


def abstract_args(bundle, shape_id: str, multi_pod: bool = False):
    cfg: T.TransformerConfig = bundle.config
    cell = bundle.cells[shape_id]
    params = T.init_abstract(cfg)
    B, S = cell.meta["batch"], cell.meta["seq"]
    if cell.kind == "train":
        return (
            params,
            OPT.init(params),
            {"tokens": base.meta((B, S), torch.int32),
             "labels": base.meta((B, S), torch.int32)},
        )
    if cell.kind == "prefill":
        return (params, {"tokens": base.meta((B, S), torch.int32)})
    # decode: cache of S positions + one token per sequence
    cache = T.cache_abstract(cfg, B, S)
    return (params, cache, {"tokens": base.meta((B,), torch.int32)})


def real_args(bundle, shape_id: str, device=None, seed: int = 0):
    """:func:`abstract_args`' leaves on ``device``: seeded parameters, zero
    moments, token ids below the vocabulary; a decode cell's cache is
    zeros with the new token at its last slot (``index`` S - 1)."""
    dev = resolve_device(device)
    cfg: T.TransformerConfig = bundle.config
    cell = bundle.cells[shape_id]
    g = torch.Generator(device=dev).manual_seed(seed)
    params = dict(T.Transformer(cfg, device=dev, generator=g).named_parameters())
    B, S = cell.meta["batch"], cell.meta["seq"]

    def ids(*shape):
        return torch.randint(0, cfg.vocab, shape, generator=g, device=dev, dtype=torch.int32)

    if cell.kind == "train":
        return (params, OPT.init(params), {"tokens": ids(B, S), "labels": ids(B, S)})
    if cell.kind == "prefill":
        return (params, {"tokens": ids(B, S)})
    cache = T.cache_init(cfg, B, S, device=dev)
    cache["index"] = torch.tensor(S - 1, dtype=torch.int32, device=dev)
    return (params, cache, {"tokens": ids(B)})


def _serve_needs_fsdp(cfg: T.TransformerConfig) -> bool:
    """Serving holds bf16 weights only (no optimizer moments): keep them
    resident per TP shard when they fit (the dense archs), and split them
    over the data axes too only when they do not (the MoE archs): the JAX
    rule, > 12 GB of weights per TP shard."""
    from repro_torch.analysis.roofline import lm_param_count

    resident_gb = lm_param_count(cfg) * 2 / base.TP_SIZE / 2**30
    return resident_gb > 12.0


def shardings(bundle, shape_id: str, multi_pod: bool = False):
    """``(in_specs, out_specs)`` of the cell on the production mesh (the
    JAX ``shardings``), keyed as the port's arguments and results."""
    cfg: T.TransformerConfig = bundle.config
    cell = bundle.cells[shape_id]
    dp = base.dp_axes(multi_pod)
    dpn = base.dp_size(multi_pod)
    tp = base.TP_AXIS
    fsdp = True if cell.kind == "train" else _serve_needs_fsdp(cfg)
    pspecs = T.param_specs(cfg, dp, tp, base.TP_SIZE, dpn, fsdp=fsdp)
    B = cell.meta["batch"]
    bspec = dp if B % dpn == 0 else None
    if cell.kind == "train":
        ospecs = OPT.state_specs(pspecs)
        bat = {"tokens": P(bspec, None), "labels": P(bspec, None)}
        return (pspecs, ospecs, bat), (pspecs, ospecs, {"loss": P(), "grad_norm": P()})
    cspecs = T.cache_specs(cfg, B, dp, tp, dpn)
    if cell.kind == "prefill":
        return (pspecs, {"tokens": P(bspec, None)}), (cspecs, P(bspec, tp))
    return (pspecs, cspecs, {"tokens": P(bspec)}), (cspecs, P(bspec, tp))


def _act_cfg(bundle, shape_id: str) -> T.TransformerConfig:
    """The config with the cell's activation layout on the production mesh
    (the JAX ``_act_cfg``): a train cell's layer carry split on the
    sequence over "model" (``act_seq``) when the model axis divides it."""
    cell = bundle.cells[shape_id]
    act_seq = cell.kind == "train" and cell.meta["seq"] % base.TP_SIZE == 0
    return dataclasses.replace(bundle.config, act_seq=act_seq)


def step_fn(bundle, shape_id: str, multi_pod: bool = False):
    cfg = _act_cfg(bundle, shape_id)
    cell = bundle.cells[shape_id]
    if cell.kind == "train":
        one = make_train_step(cfg)

        def train_step(params, opt_state, batch):
            par = mesh_parallel(batch["tokens"])
            if par is None:
                return one(params, opt_state, batch)
            return _opt_step(lambda p, b: T.loss_fn(T.Transformer(cfg, params=p, par=par),
                                                    b["tokens"], b["labels"]),
                             OPT, report=par.sum_data)(params, opt_state, batch)

        return train_step
    if cell.kind == "prefill":
        S = cell.meta["seq"]
        return lambda params, batch: T.Transformer(
            cfg, params=params, par=mesh_parallel(batch["tokens"])).prefill(batch["tokens"], S)
    return lambda params, cache, batch: T.Transformer(
        cfg, params=params, par=mesh_parallel(batch["tokens"])).decode_step(cache, batch["tokens"])


def smoke_batch(bundle, rng: np.random.Generator, device=None):
    cfg = bundle.smoke_config
    B, S = 2, 16
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return base.host_tensors({"tokens": toks[:, :-1], "labels": toks[:, 1:]},
                             resolve_device(device))


def smoke_step(bundle):
    """``run(batch)`` on the batch's device: parameters drawn on the CPU from
    seed 0 (so every device starts from the same ones), one train step,
    then a prefill of 32 positions and a decode step."""
    cfg = bundle.smoke_config

    def run(batch):
        dev = batch["tokens"].device
        params = base.to_device(dict(T.Transformer(cfg, device="cpu").named_parameters()), dev)
        opt_state = OPT.init(params)
        params, opt_state, metrics = make_train_step(cfg)(params, opt_state, batch)
        model = T.Transformer(cfg, params=params)
        cache, logits_p = model.prefill(batch["tokens"], 32)
        cache, logits_d = model.decode_step(cache, batch["tokens"][:, -1])
        return {"loss": metrics["loss"], "logits_prefill": logits_p,
                "logits_decode": logits_d}

    return run


def make_bundle(arch_id: str, config: T.TransformerConfig,
                smoke_config: T.TransformerConfig,
                skip_long: bool) -> base.ArchBundle:
    config.validate()
    smoke_config.validate()
    cells = dict(SHAPES)
    skip = {}
    if skip_long:
        cells.pop("long_500k")
        skip["long_500k"] = SKIP_LONG
    return base.ArchBundle(
        arch_id=arch_id, family="lm", config=config,
        smoke_config=smoke_config, cells=cells, skip_shapes=skip,
        _abstract_args=abstract_args, _shardings=shardings, _real_args=real_args,
        _step_fn=step_fn, _smoke_batch=smoke_batch, _smoke_step=smoke_step,
    )
