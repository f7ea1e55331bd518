"""Rank functions of the mesh-serving, MIND, GNN and census tests, run in
spawned processes (:func:`torch_sharded_ranks.spawn` for gloo ranks,
:func:`alone` for one process holding a placeholder group).  They import
the port only (never JAX): a spawned child imports this module, not the
test module.
"""
import dataclasses
import logging
import multiprocessing
import queue
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

import torch_threads  # noqa: F401  (one torch thread per process)
from repro_torch.configs import GNN_CONFIGS, LM_CONFIGS, get_arch
from repro_torch.configs.lm_family import _serve_needs_fsdp
from repro_torch.launch import mesh as M
from repro_torch.models import gnn as G
from repro_torch.models import recsys as RS
from repro_torch.models import transformer as T
from repro_torch.models.parallel import MeshParallel, P, chunk_range, local, place_tree, \
    use_mesh

ARCHS = ["qwen2-7b", "chatglm3-6b", "h2o-danube-3-4b", "qwen3-moe-235b-a22b",
         "deepseek-v2-236b"]
# prompt [B, S] then DECODE steps; the cache holds MAX_LEN slots (the SWA
# ring of h2o-danube's SMOKE window, 8, wraps)
B, S, MAX_LEN, DECODE = 4, 12, 16, 4
MESHES = [(2, 2), (1, 4)]          # (data, model)


def _alone_child(fn_name, args, out):
    try:
        torch.set_num_threads(1)
        logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
        out.put(("ok", globals()[fn_name](*args)))
    except BaseException:  # noqa: BLE001  (the parent reports it)
        out.put(("error", traceback.format_exc()))


def alone(fn_name: str, *args, timeout: float = 240.0):
    """``fn_name(*args)`` in one spawned process with no process group up
    (a placeholder group is process-global); its result."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    p = ctx.Process(target=_alone_child, args=(fn_name, args, out))
    p.start()
    try:
        try:
            status, res = out.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(f"{fn_name} gave nothing in {timeout} s") from None
        if status != "ok":
            raise RuntimeError(f"{fn_name} failed:\n{res}")
        p.join(timeout=60)
        return res
    finally:
        if p.is_alive():
            p.kill()
            p.join(timeout=10)


def serving_specs(arch: str, mesh):
    """The serving layout of ``arch``'s SMOKE config on ``mesh``: the
    parameters by ``param_specs`` with FSDP where the FULL config's serving
    cells use it (the MoE archs), the cache by ``cache_specs``."""
    cfg = LM_CONFIGS[arch].SMOKE
    dp, tp = mesh.size(0), mesh.size(1)
    pspecs = T.param_specs(cfg, ("data",), "model", tp, dp,
                           fsdp=_serve_needs_fsdp(LM_CONFIGS[arch].FULL))
    return pspecs, T.cache_specs(cfg, B, ("data",), "model", dp)


def serve_lm(rank, npz_path):
    """Per mesh of :data:`MESHES` and arch: prefill of the prompt, then
    :data:`DECODE` teacher-forced decode steps, each arch's weights the
    port's keyed arrays of the npz; this rank's logits (rows, vocabulary
    columns) per step and its cache after the last, with its coordinate."""
    npz = np.load(npz_path)
    out = {}
    for dp, tp in MESHES:
        mesh = M.mesh_over(list(range(dist.get_world_size())), "cpu", model=tp)
        coord = tuple(mesh.get_coordinate())
        for arch in ARCHS:
            cfg = LM_CONFIGS[arch].SMOKE
            names = [k.split("/", 2)[2] for k in npz.files if k.startswith(f"w/{arch}/")]
            whole = {n: nn.Parameter(torch.from_numpy(npz[f"w/{arch}/{n}"])) for n in names}
            pspecs, cspecs = serving_specs(arch, mesh)
            params = place_tree(whole, pspecs, mesh)
            toks = torch.from_numpy(npz[f"tokens/{arch}"])
            tokens = place_tree(toks, P("data", None), mesh)
            par = MeshParallel(mesh, batch_split=True)
            model = T.Transformer(cfg, params=params, par=par)
            cache, logits = model.prefill(tokens, MAX_LEN)
            steps = [local(logits).numpy().copy()]
            nxt = torch.from_numpy(npz[f"next/{arch}"])
            for i in range(DECODE):
                cache, logits = model.decode_step(cache, local(place_tree(
                    nxt[:, i], P("data"), mesh)))
                steps.append(local(logits).numpy().copy())
            out[(dp, tp, arch)] = {
                "coord": coord, "logits": steps,
                "cache": {k: local(v).numpy().copy() for k, v in cache.items()
                          if isinstance(v, torch.Tensor)},
                "index": int(cache["index"])}
    return out


def mind_on_mesh(rank, npz_path):
    """MIND's SMOKE config on the (2, 2) mesh from the npz's weights:
    ``serve_score`` (this rank's rows), ``retrieval_score`` (its chunk of
    the corpus, split over every axis), the loss (summed over the data
    axes) and the parameters' gradients whole."""
    npz = np.load(npz_path)
    cfg = get_arch("mind").smoke_config
    mesh = M.make_host_mesh(device="cpu")
    whole = {n: nn.Parameter(torch.from_numpy(npz[f"w/{n}"])) for n in RS.shapes(cfg)}
    params = place_tree(whole, RS.param_specs(cfg), mesh)
    batch = {k: torch.from_numpy(npz[f"b/{k}"]) for k in
             ("hist", "hist_mask", "user_feats", "candidates", "target")}
    rows = {k: place_tree(v, P("data", *([None] * (v.dim() - 1))), mesh)
            for k, v in batch.items()}
    ret = {"hist": batch["hist"][:1], "hist_mask": batch["hist_mask"][:1],
           "user_feats": batch["user_feats"][:1]}
    ret = {k: place_tree(v, P(None, None), mesh) for k, v in ret.items()}
    ret["candidate_ids"] = place_tree(torch.from_numpy(npz["b/candidate_ids"]),
                                      P(("data", "model")), mesh)
    model = RS.MIND(cfg, params=params, par=MeshParallel(mesh))
    out = {"coord": tuple(mesh.get_coordinate()),
           "serve": model.serve_score(rows).numpy(),
           "retrieval": RS.MIND(cfg, params=params, par=MeshParallel(
               mesh, batch_split=False)).retrieval_score(ret).numpy()}
    par = MeshParallel(mesh)
    loss = RS.loss_fn(RS.MIND(cfg, params=params, par=par), rows)
    grads = torch.autograd.grad(loss, list(params.values()))
    out["loss"] = float(par.sum_data(loss))
    out["grads"] = {n: g.full_tensor().numpy() for n, g in zip(params, grads)}
    return out


def gnn_split_specs(arch: str, batch: dict, dp: int, n_ranks: int) -> dict:
    """The JAX package's rules for a batch's layout on a (dp, n_ranks / dp)
    mesh: node arrays over "data" when it divides them, edges over ("data",
    "model") (or "data"), minibatch seeds over every axis, molecules by
    graph."""
    full = ("data", "model")

    def over(n, both):
        if both and n % n_ranks == 0:
            return full
        return "data" if n % dp == 0 else None

    out = {}
    for k, v in batch.items():
        if isinstance(v, list):
            out[k] = [P(over(t.shape[0], True), *([None] * (t.dim() - 1))) for t in v]
            continue
        edge = k in ("senders", "receivers", "edge_feat")
        seeds = "seed_x" in batch
        molecule = batch["x"].dim() == 3 if "x" in batch else False
        out[k] = P(over(v.shape[0], (edge or seeds) and not molecule),
                   *([None] * (v.dim() - 1)))
    return out


def gnn_on_mesh(rank, npz_path):
    """Each GNN's SMOKE config (f32) on the (2, 2) mesh, its batch placed by
    the JAX package's rules: this rank's loss share summed over every rank,
    and the parameters' gradients whole; for the graph, molecule and
    minibatch forms."""
    npz = np.load(npz_path)
    mesh = M.make_host_mesh(device="cpu")
    out = {}
    for arch in sorted(GNN_CONFIGS):
        cfg = GNN_CONFIGS[arch].SMOKE
        for form in ("graph", "molecule", "minibatch"):
            if form == "minibatch" and arch != "graphsage-reddit":
                continue
            pre = f"{arch}/{form}"
            params = {k: {n: torch.from_numpy(npz[f"{pre}/p/{k}/{n}"]) for n in sub}
                      for k, sub in G.shapes(cfg).items()}
            specs = G.param_specs(cfg, ("data",), "model", 2)
            placed = place_tree(params, specs, mesh)
            placed = {k: {n: t.requires_grad_() for n, t in sub.items()}
                      for k, sub in placed.items()}
            batch = {}
            for key in npz.files:
                if key.startswith(f"{pre}/b/"):
                    name = key[len(f"{pre}/b/"):]
                    if "." in name:
                        base, i = name.split(".")
                        batch.setdefault(base, []).append((int(i), torch.from_numpy(npz[key])))
                    else:
                        batch[name] = torch.from_numpy(npz[key])
            batch = {k: [t for _, t in sorted(v)] if isinstance(v, list) else v
                     for k, v in batch.items()}
            bspecs = gnn_split_specs(arch, batch, mesh.size(0), mesh.size())
            with use_mesh(mesh):
                pb = place_tree(batch, bspecs, mesh)
                sp = G.split_of(pb)
                loss = G.loss_fn(placed, pb, cfg)
            leaves = [t for sub in placed.values() for t in sub.values()]
            grads = torch.autograd.grad(loss, leaves)
            out[(arch, form)] = (float(sp.sum_all(loss)),
                                 [g.full_tensor().numpy() for g in grads])
    return out


# ---------------------------------------------------------------------------
# Census on placeholder ranks (one process, torch's fake backend)
# ---------------------------------------------------------------------------
def census_invariants(shape, names):
    """On a placeholder group of prod(shape) ranks, the census of:
    a step that reads a DTensor argument and gathers it (argument bytes,
    collectives, the wrapper), the FSDP gathers of one layer's weights
    (collective bytes), and a pure data-parallel step of qwen2-7b's SMOKE
    layer (FLOPs per rank)."""
    from torch.distributed.tensor import Replicate

    from repro_torch.analysis.hlo import count_step

    n = int(np.prod(shape))
    M.init_placeholder_ranks(n)
    try:
        mesh = M.DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=names)
        k = mesh.ndim
        out = {"shape": shape}
        # a [1024, 512] f32 DTensor split on both dims over two mesh dims
        x = torch.empty(1024, 512, device="meta")
        spec = P(names[-2], names[-1]) if k == 2 else P(names[:2], names[-1])
        d = place_tree(x, spec, mesh)
        w = torch.empty(512, 64, device="meta")

        def gather_mm(d, w):
            return d.redistribute(mesh, [Replicate()] * k).to_local() @ w

        def gathers(d, w):   # four gathers in turn, the products summed
            acc = gather_mm(d, w)
            for _ in range(3):
                acc = acc + gather_mm(d, w)
            return acc

        many = count_step(gathers, (d, w))
        c = count_step(gather_mm, (d, w))
        out["gather"] = {"many_peak": many.peak_bytes, "many_live_end": many.live_bytes,"local_bytes": local(d).numel() * 4, "live_after_track": None,
                         "collectives": dict(c.collectives), "flops": c.flops,
                         "peak": c.peak_bytes,
                         "groups": {str(kk): v for kk, v in c.collective_groups.items()},
                         "ops": dict(c.ops)}
        from repro_torch.analysis.hlo import OpCensus

        t = OpCensus()
        t.track((d, w))
        out["gather"]["live_after_track"] = t.live_bytes
        # one SMOKE layer's FSDP gathers (the training layout), forward only
        cfg = LM_CONFIGS["qwen2-7b"].SMOKE
        par = MeshParallel(mesh)
        dp_axes = names[:-1]
        specs = T.param_specs(cfg, dp_axes, "model", par.tp, par.dp)
        full = {nm: p for nm, p in T.init_abstract(cfg).items() if nm.startswith("layers.0.")}
        placed = place_tree(full, {nm: specs[nm] for nm in full}, mesh)
        layer = T.DecoderLayer(cfg, "meta", params={nm.split(".", 2)[2]: p
                                                    for nm, p in placed.items()}, par=par)

        def gathers():
            return [layer.w(nm) for nm in T.layer_shapes(cfg)]

        c = count_step(gathers, ())
        out["fsdp"] = {"collectives": dict(c.collectives),
                       "shapes": {nm: (tuple(placed[f"layers.0.{nm}"].shape), str(
                           specs[f"layers.0.{nm}"])) for nm in T.layer_shapes(cfg)},
                       "dp": par.dp, "tp": par.tp}
        # a pure data-parallel step: every weight whole, the batch over the
        # data axes; matmul FLOPs per rank = one device's / dp
        cfg1 = dataclasses.replace(cfg, n_layers=1)
        rep = {nm: P(*([None] * len(p.shape))) for nm, p in T.init_abstract(cfg1).items()}
        params = place_tree(T.init_abstract(cfg1), rep, mesh)
        toks = torch.empty((8 * par.dp, 16), dtype=torch.int64, device="meta")
        tokens = place_tree(toks, P(dp_axes, None), mesh)

        def dp_step(params, tokens):
            with torch.no_grad():
                return T.Transformer(cfg1, params=params, par=par).forward(local(tokens))

        one = count_step(lambda t: T.Transformer(cfg1, device="meta").forward(t), (toks,))
        with use_mesh(mesh):
            c = count_step(dp_step, (params, tokens))
        out["dp_flops"] = (c.flops, one.flops, par.dp)
        return out
    finally:
        dist.destroy_process_group()


def production_meshes(n):
    """``make_production_mesh`` on a placeholder group of ``n`` ranks: the
    shape and names of the single- and multi-pod meshes, or the error."""
    M.init_placeholder_ranks(n)
    try:
        got = {}
        for multi in (False, True):
            try:
                m = M.make_production_mesh(multi_pod=multi, device="cpu")
                got[multi] = (tuple(m.shape), tuple(m.mesh_dim_names),
                              tuple(m.get_coordinate()), m.mesh.flatten().tolist()[:3])
            except ValueError as e:
                got[multi] = ("ValueError", str(e))
        return got
    finally:
        dist.destroy_process_group()


def pod_rows(cells):
    """The dry-run rows of (arch, shape, mesh) cells, each on its own
    placeholder group (in this process, one after another)."""
    from repro_torch.launch.dryrun import run_cell

    return [run_cell(a, s, m, verbose=False) for a, s, m in cells]



# ---------------------------------------------------------------------------
# Across cards (NCCL, one rank per card)
# ---------------------------------------------------------------------------
CARDS_LAYERS, CARDS_PROMPT, CARDS_MAX_LEN, CARDS_DECODE = 4, (4, 1024), 1040, 16


def cards_serve(rank):
    """qwen2-7b at full width (CARDS_LAYERS layers) drawn in bf16 on every
    card from one seed, and the same weights in f32; rank 0 serves both on
    its card alone first; then every rank serves both on the (2, 2) mesh
    of four cards under the serving layout sized to that mesh: prefill of
    the prompts, then CARDS_DECODE decode steps fed seeded tokens (TF32
    off).  Per dtype, each step's logits on the host (numpy: a tensor
    would go back through a file descriptor of a process that has ended):
    rank 0's one-card run whole, every rank's mesh run (its rows and
    vocabulary columns), with the seconds."""
    import time

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    arch = "qwen2-7b"
    cfg16 = dataclasses.replace(LM_CONFIGS[arch].FULL, n_layers=CARDS_LAYERS)
    cfg32 = dataclasses.replace(cfg16, dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(41)
    prompts = torch.randint(0, cfg16.vocab, CARDS_PROMPT, generator=g, device=dev)
    feed = torch.randint(0, cfg16.vocab, (CARDS_PROMPT[0], CARDS_DECODE), generator=g, device=dev)
    w16 = dict(T.Transformer(cfg16, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(0)).named_parameters())
    # the bf16 weights in f32 (the router-free dense model has no f32 leaf)
    weights = {torch.bfloat16: (cfg16, w16),
               torch.float32: (cfg32, {n: nn.Parameter(p.detach().float()) for n, p in w16.items()})}

    def serve(m, tokens, rows):
        out, secs = [], []
        torch.cuda.synchronize()
        ts = time.perf_counter()
        cache, lg = m.prefill(tokens, CARDS_MAX_LEN)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - ts)
        out.append(local(lg).float().cpu().numpy())
        for i in range(CARDS_DECODE):
            ts = time.perf_counter()
            cache, lg = m.decode_step(cache, feed[rows, i])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - ts)
            out.append(local(lg).float().cpu().numpy())
        return out, secs

    mesh = M.mesh_over(list(range(dist.get_world_size())), "cuda", model=2)
    dp, tp = mesh.size(0), mesh.size(1)
    rows = slice(*chunk_range(CARDS_PROMPT[0], dp, mesh.get_coordinate()[0]))
    toks = local(place_tree(prompts, P("data", None), mesh))
    res = {"coord": tuple(mesh.get_coordinate())}
    with torch.no_grad():
        for dtype, (cfg, params) in weights.items():
            name = str(dtype).split(".")[-1]
            if rank == 0:
                res[f"one_{name}"] = serve(T.Transformer(cfg, params=params), prompts,
                                           slice(None))
            pspecs = T.param_specs(cfg, ("data",), "model", tp, dp,
                                   fsdp=_serve_needs_fsdp(LM_CONFIGS[arch].FULL))
            mesh_model = T.Transformer(cfg, params=place_tree(params, pspecs, mesh),
                                       par=MeshParallel(mesh))
            res[f"mesh_{name}"] = serve(mesh_model, toks, rows)
            del mesh_model
            torch.cuda.empty_cache()
    res["peak"] = torch.cuda.max_memory_allocated()
    return res


def act_seq_steps(rank):
    """Per LM arch (SMOKE, remat on) on the (2, 2) mesh: two train steps
    with the layer carry split on the sequence over "model" (``act_seq``)
    and two without, from the same weights: losses and norms."""
    from repro_torch.data import lm_batch_fn
    from repro_torch.launch import train as TR
    from repro_torch.optim import AdamW, cosine_schedule

    mesh = M.make_host_mesh(device="cpu")
    out = {}
    for arch in ARCHS:
        got = {}
        for act_seq in (False, True):
            cfg = dataclasses.replace(LM_CONFIGS[arch].SMOKE, remat=True, act_seq=act_seq)
            opt = AdamW(lr=cosine_schedule(1e-3, 2, 100))
            run = TR._OnMesh(cfg, opt, mesh, None)
            rows = []
            for b in range(2):
                _, run.opt_state, m = run.step(run.params, run.opt_state,
                                               run.put(lm_batch_fn(cfg.vocab, 8, 32)(b)))
                rows.append((float(m["loss"]), float(m["grad_norm"])))
            got[act_seq] = rows
        out[arch] = got
    return out
