"""gloo ranks for the sharded-training tests: :func:`spawn` runs a function
of this module in ``world`` spawned processes (one torch thread each, a
``file://`` store in the test's temporary directory) and returns each
rank's result.  Every wait has a timeout, so a hung rank fails its test
instead of holding the suite; the children are killed on the way out.

The functions here import the port only (never JAX): a spawned child
imports this module, not the test module.
"""
import dataclasses
import multiprocessing
import os
import queue
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

import torch_threads  # noqa: F401  (one torch thread per process)
from repro_torch.configs import GNN_CONFIGS, LM_CONFIGS, get_arch
from repro_torch.data import lm_batch_fn
from repro_torch.launch import elastic, mesh as M, train as TR
from repro_torch.models import gnn as G
from repro_torch.models import transformer as T
from repro_torch.models.parallel import P, local, local_slice, place_tree, placements, \
    shard_tensor, use_mesh
from repro_torch.optim import AdamW, compressed_psum, cosine_schedule

ARCHS = ["qwen2-7b", "chatglm3-6b", "h2o-danube-3-4b", "qwen3-moe-235b-a22b",
         "deepseek-v2-236b"]
BATCH, SEQ, STEPS = 8, 32, 3


def _rank_fn(fn_name):
    """The function ``fn_name`` of this module, or ``"module:name"`` of
    another test helper module."""
    if ":" in fn_name:
        import importlib

        mod, name = fn_name.split(":")
        return getattr(importlib.import_module(mod), name)
    return globals()[fn_name]


def _child(fn_name, rank, world, store, args, out, backend):
    if backend == "nccl":
        _card_child(fn_name, rank, world, store, args, out)
        return
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        try:
            res = _rank_fn(fn_name)(rank, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, "ok", res))
    except BaseException:  # noqa: BLE001  (the parent reports it)
        out.put((rank, "error", traceback.format_exc()))


def _card_child(fn_name, rank, world, store, args, out):
    """An NCCL rank on card ``rank``.  It reports after a barrier and ends
    without tearing the NCCL groups down, which can leave a card's process
    alive past its join."""
    try:
        torch.set_num_threads(1)
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank,
                                world_size=world, device_id=torch.device("cuda", rank))
        res = _rank_fn(fn_name)(rank, *args)
        dist.barrier()
        report = (rank, "ok", res)
    except BaseException:  # noqa: BLE001  (the parent reports it)
        report = (rank, "error", traceback.format_exc())
    out.put(report)
    out.close()
    out.join_thread()
    os._exit(0 if report[1] == "ok" else 1)


def spawn(fn_name: str, world: int, tmp_dir, *args, timeout: float = 240.0,
          backend: str = "gloo") -> list:
    """``fn_name(rank, *args)`` on ``world`` ranks (gloo, or NCCL with one
    card each), ``fn_name`` a function of this module or
    ``"module:name"``; the results in rank order.  Raises with the first failing
    rank's traceback, or when a rank gives nothing within ``timeout``
    seconds."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(str(tmp_dir), f"store_{fn_name.replace(':', '_')}_{world}")
    procs = [ctx.Process(target=_child, args=(fn_name, r, world, store, args, out, backend))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            try:
                rank, status, res = out.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"{fn_name}: a rank gave nothing in {timeout} s") from None
            if status != "ok":
                raise RuntimeError(f"{fn_name} rank {rank} failed:\n{res}")
            got[rank] = res
        for p in procs:
            p.join(timeout=60)
            if p.is_alive() or p.exitcode != 0:
                raise RuntimeError(f"{fn_name}: a rank did not exit cleanly ({p.exitcode})")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [got[r] for r in range(world)]


# ---------------------------------------------------------------------------
# The JAX package's arrays in the port's names
# ---------------------------------------------------------------------------
def port_init(npz, arch: str) -> dict:
    """The JAX init of ``arch`` (``init/<arch>/<path>`` leaves of the
    reference's npz) keyed as the port's ``named_parameters()``."""
    prefix = f"init/{arch}/"
    tree: dict = {}
    for key in npz.files:
        if key.startswith(prefix):
            parts = key[len(prefix):].split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = npz[key]
    model = T.Transformer(LM_CONFIGS[arch].SMOKE, device="cpu")
    T.load_jax_params(model, tree)
    return {k: v.detach().numpy().copy() for k, v in model.named_parameters()}


def jax_shard(npz, prefix: str, name: str, coord, cfg) -> np.ndarray:
    """The JAX device (row, col)'s shard of the port parameter ``name``
    (its layer of the stacked leaf)."""
    at = f"{coord[0]}.{coord[1]}"
    if not name.startswith("layers."):
        return npz[f"{prefix}/{name}/{at}"]
    _, i, leaf = name.split(".", 2)
    i = int(i)
    nd = cfg.n_dense_layers if cfg.is_moe else 0
    stack, j = ("dense_layers", i) if i < nd else ("layers", i - nd)
    return npz[f"{prefix}/{stack}/{leaf}/{at}"][j]


# ---------------------------------------------------------------------------
# Rank functions
# ---------------------------------------------------------------------------
def train_against_jax(rank, npz_path, ckpt_dir):
    """Per arch on the 2 x 2 mesh: train_lm's losses and norms from the JAX
    init; the local shards of the init (parameters, m, v) and after one
    step, with the JAX device of this rank's coordinate's shards beside
    them; then the checkpoint drill; then shard_tensor beside
    distribute_tensor."""
    npz = np.load(npz_path)
    out = {"train": {}, "shards": {}}
    for arch in ARCHS:
        cfg = LM_CONFIGS[arch].SMOKE
        init = port_init(npz, arch)
        r = TR.train_lm(arch, steps=STEPS, batch=BATCH, seq=SEQ, init=init, log_every=100,
                        mesh=M.make_host_mesh(device="cpu"))
        out["train"][arch] = (r["losses"], r["grad_norms"])
        opt = AdamW(lr=cosine_schedule(3e-4, 10, max(STEPS, 100)))
        run = TR._OnMesh(cfg, opt, M.make_host_mesh(device="cpu"), init)
        coord = run.mesh.get_coordinate()
        rows = {}
        for name, p in run.params.items():
            rows[("init", name)] = (local(p).detach().numpy().copy(),
                                    jax_shard(npz, f"shard0/{arch}/params", name, coord, cfg))
            for mom in ("m", "v"):
                got = local(getattr(run.opt_state, mom)[name]).numpy().copy()
                rows[(f"init_{mom}", name)] = (got, np.zeros_like(rows[("init", name)][1],
                                                              dtype=np.float32))
        batch = lm_batch_fn(cfg.vocab, BATCH, SEQ)(0)
        run.step(run.params, run.opt_state, run.put(batch))
        for name, p in run.params.items():
            rows[("step1_params", name)] = (
                local(p).detach().numpy().copy(),
                jax_shard(npz, f"shard1/{arch}/params", name, coord, cfg))
            for mom in ("m", "v"):
                rows[(f"step1_{mom}", name)] = (
                    local(getattr(run.opt_state, mom)[name]).numpy().copy(),
                    jax_shard(npz, f"shard1/{arch}/{mom}", name, coord, cfg))
        out["shards"][arch] = rows
    out["ckpt"] = checkpoint_drill(ckpt_dir)
    mesh = M.make_host_mesh(device="cpu")
    t = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    same = []
    for spec in (P(("data",), "model"), P("model", ("data",)), P(None, ("data", "model")),
                 P(None), P(("data", "model"))):
        a = shard_tensor(t, mesh, spec).to_local()
        b = distribute_tensor(t, mesh, placements(spec, mesh), src_data_rank=None).to_local()
        same.append(bool(torch.equal(a, b)) and bool(torch.equal(a, local_slice(t, spec, mesh))))
    out["shard_tensor"] = same
    return out


def checkpoint_drill(ckpt_dir):
    """train_lm with a checkpoint every 2 steps and a failure after step
    5's update, restarted: the losses of the uninterrupted run and of the
    restart from step 4."""
    mesh = M.make_host_mesh(device="cpu")
    full = TR.train_lm("qwen2-7b", steps=8, batch=4, seq=16, log_every=100, mesh=mesh)
    try:
        TR.train_lm("qwen2-7b", steps=8, batch=4, seq=16, ckpt_dir=ckpt_dir, ckpt_every=2,
                    fail_at=5, log_every=100, mesh=mesh)
        failed = None
    except RuntimeError as e:
        failed = str(e)
    again = TR.train_lm("qwen2-7b", steps=8, batch=4, seq=16, ckpt_dir=ckpt_dir, ckpt_every=2,
                        log_every=100, mesh=mesh)
    return {"full": full["losses"], "failed": failed, "again": again["losses"],
            "restored_from": again["restored_from"]}


def tp_layouts(rank, cases):
    """``build_for_devices`` over every rank (model axis ``m``) against one
    device for each (name, arch, config fields, m) case: three steps'
    losses and norms, and the final parameters whole."""
    out = {}
    for name, arch, fields, m in cases:
        cfg = dataclasses.replace(LM_CONFIGS[arch].SMOKE, **fields)
        got = {}
        for where in ("one", "mesh"):
            opt = AdamW(lr=cosine_schedule(1e-3, 2, 100))
            devs = ["cpu"] if where == "one" else list(range(dist.get_world_size()))
            _, ps, os_, bs, step = elastic.build_for_devices(cfg, devs, opt, model_axis=m)
            model = T.Transformer(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
            params0 = dict(model.named_parameters())
            host = elastic.to_host((params0, opt.init(params0)))
            p, o = elastic.reshard_state(host[0], ps), elastic.reshard_state(host[1], os_)
            metrics = []
            for i in range(STEPS):
                toks = np.random.default_rng(50 + i).integers(0, cfg.vocab, (4, 17),
                                                              dtype=np.int32)
                b = elastic.reshard_state({"tokens": toks[:, :-1], "labels": toks[:, 1:]}, bs)
                p, o, mt = step(p, o, b)
                metrics.append((float(mt["loss"]), float(mt["grad_norm"])))
            got[where] = (metrics, elastic.to_host(p))
        out[name] = got
    return out


def one_by_one(rank, ckpt_root):
    """train_lm on the world-1 mesh for each arch, its final state written
    by a checkpoint at the last step."""
    out = {}
    for arch in ARCHS:
        r = TR.train_lm(arch, steps=STEPS, batch=BATCH, seq=SEQ, log_every=100,
                        ckpt_dir=os.path.join(ckpt_root, f"mesh_{arch}"), ckpt_every=STEPS,
                        mesh=M.make_host_mesh(device="cpu"))
        out[arch] = (r["losses"], r["grad_norms"])
    return out


def elastic_and_agg(rank, npz_path):
    """The elastic drill from the JAX init; the split aggregation
    (``SplitGraph``: each rank's edges summed into its node rows) on the
    JAX package's inputs (f32) and on f64 ones, with its gradients beside
    the dense ones'; each GNN's loss and gradients (f64) on its batch
    placed whole on every rank, run split."""
    npz = np.load(npz_path)
    out = {"drill": elastic.elastic_drill(LM_CONFIGS["qwen2-7b"].SMOKE, device="cpu",
                                          init=port_init(npz, "qwen2-7b"),
                                          ranks=list(range(dist.get_world_size())))}
    mesh = M.make_host_mesh(device="cpu")
    out["coord"] = tuple(mesh.get_coordinate())
    sp = G.SplitGraph(mesh)

    def split_agg(msgs, recv, n, kind):
        # every rank's edges summed into its node rows, gathered whole
        return sp.full(sp.agg(sp.rows(msgs), sp.rows(recv), n, kind), n)

    rng = np.random.default_rng(0)
    msgs = rng.normal(size=(256, 16)).astype(np.float32)
    recv = rng.integers(0, 64, 256).astype(np.int32)
    for kind in ("sum", "mean"):
        out[f"agg/{kind}"] = split_agg(torch.from_numpy(msgs), torch.from_numpy(recv).long(),
                                       64, kind).numpy()
        m64 = torch.from_numpy(np.random.default_rng(7).normal(size=(300, 8))).requires_grad_()
        r64 = torch.from_numpy(np.random.default_rng(8).integers(0, 36, 300))
        w = torch.from_numpy(np.random.default_rng(9).normal(size=(36, 8)))
        mine = sp.agg(sp.rows(m64), sp.rows(r64), 36, kind)
        want = G._agg_dense(m64, r64, 36, kind)
        # each rank's share of the weighted sum: the gradients of its edges
        g_got, = torch.autograd.grad((mine * sp.rows(w)).sum(), m64)
        g_want, = torch.autograd.grad((want * w).sum(), m64)
        out[f"f64/{kind}"] = (sp.full(mine.detach(), 36).numpy(), want.detach().numpy(),
                              sp.sum_all(g_got).numpy(), g_want.numpy())
        # 4 ranks do not divide 37 nodes: uneven chunks of node rows
        out[f"odd/{kind}"] = (split_agg(m64.detach(), r64, 37, kind).numpy(),
                              G._agg_dense(m64, r64, 37, kind).detach().numpy())
    out["gnn"] = {}
    for arch in sorted(GNN_CONFIGS):
        batch = get_arch(arch).smoke_batch(np.random.default_rng(0), device="cpu")
        # min_tp_dim 2: every even output dim split over "model" by param_specs
        cfg = dataclasses.replace(GNN_CONFIGS[arch].SMOKE, dtype=torch.float64, min_tp_dim=2)
        got = {}
        for where in ("dense", "mesh"):
            params = G.init(cfg, torch.Generator().manual_seed(3), device="cpu")
            if where == "mesh":  # the leaves DTensors placed by param_specs
                params = G.place_params(params, cfg, mesh)
            leaves = [v for sub in params.values() for v in
                      (sub.values() if isinstance(sub, dict) else [sub])]
            if where == "mesh":
                # the batch whole on every rank, run split: each rank's
                # loss its share, summed over the ranks
                placed = place_tree(batch, {k: P() for k in batch}, mesh)
                with use_mesh(mesh):
                    loss = G.loss_fn(params, placed, cfg)
            else:
                loss = G.loss_fn(params, batch, cfg)
            grads = torch.autograd.grad(loss, leaves)
            value = float(sp.sum_all(loss)) if where == "mesh" else float(loss)
            got[where] = (value, [(g.full_tensor() if isinstance(g, DTensor) else g)
                                  .numpy() for g in grads])
        out["gnn"][arch] = got
    return out


def cards_leg(rank, inits):
    """On every card's NCCL rank, the ("data", "model") mesh of them all:
    each f32 SMOKE LM's ``train_lm`` from ``inits`` (losses and norms), the
    qwen2-7b full-width run (:func:`full_width_steps`), ``elastic_drill``
    on qwen2-7b's f32 SMOKE config from n cards to n / 2, and whether
    ``compressed_psum`` over NCCL equals it over gloo on the same card
    tensors (CUDA divides by a scalar through its reciprocal, so CPU
    tensors would round differently)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = M.make_host_mesh()
    out = {"smoke": {}}
    for arch, init in inits.items():
        r = TR.train_lm(arch, steps=STEPS, batch=BATCH, seq=SEQ, log_every=100, init=init,
                        mesh=mesh)
        out["smoke"][arch] = (r["losses"], r["grad_norms"])
    out["full"] = full_width_steps(mesh)
    # f32: from n cards to n / 2 the "data" sums change order, which bf16
    # weights at full width carry past the drill's rtol of 1e-5
    out["drill"] = elastic.elastic_drill(LM_CONFIGS["qwen2-7b"].SMOKE, 3, 3, seed=0,
                                         ranks=list(range(dist.get_world_size())))
    rows = torch.from_numpy(np.random.default_rng(100 + rank).normal(
        size=300_000).astype(np.float32)).cuda()
    nccl = compressed_psum(rows, group=dist.group.WORLD)
    gloo = compressed_psum(rows, group=dist.new_group(backend="gloo"))
    out["psum_equal"] = bool(torch.equal(nccl, gloo))
    return out


FULL_LAYERS, FULL_BATCH, FULL_SEQ = 4, 8, 4096   # chip_smoke.py's train phase


def full_width_steps(mesh) -> list:
    """qwen2-7b at full width in bf16 (FULL_LAYERS layers, FULL_BATCH x
    FULL_SEQ tokens, chip_smoke.py's seed and optimizer) for STEPS steps on
    ``mesh`` through train_lm's mesh state: per step the loss, norm,
    seconds and this card's peak memory."""
    cfg = dataclasses.replace(LM_CONFIGS["qwen2-7b"].FULL, n_layers=FULL_LAYERS)
    run = TR._OnMesh(cfg, AdamW(lr=cosine_schedule(3e-4, 2000, 100_000), weight_decay=0.1),
                     mesh, None)
    make = lm_batch_fn(cfg.vocab, FULL_BATCH, FULL_SEQ)
    rows = []
    for b in range(STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ts = time.perf_counter()
        _, run.opt_state, m = run.step(run.params, run.opt_state, run.put(make(b)))
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        rows.append({"loss": loss, "grad_norm": gnorm, "seconds": time.perf_counter() - ts,
                     "max_memory_allocated": torch.cuda.max_memory_allocated()})
    del run
    torch.cuda.empty_cache()
    return rows
