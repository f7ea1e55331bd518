"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints one JSON line; any failed check exits non-zero):
  build   compile the CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
          sm_90a) and print the card, its power limit, the TF32 flag and
          ptxas's registers, shared memory and spills of the attention,
          walk, path-latency and fused UPDATE kernels.
  parity  each kernel against its plain torch version, exactly, on 1 M
          seeded random paths (L in {1, 6, 9}, 6 / 40 / 128 servers, bit 31
          set, -1 padding and empty rows; the routed walk under
          home_first, nearest_copy and queue_aware with tied loads; the
          scored walk over the nearest_copy_dp tables of depth None and 2);
          the path-latency kernel also at its route boundaries (L 8 / 9 /
          17 / 65 / 200, 80 / 160 / 400 servers) and on row slices from an
          odd row;
          the fused UPDATE on seeded random 256-row batches in every gate
          mode (none, routed with and without lookahead, queue-ranked,
          scored with depth None and 2), and as a class launch of 700 rows
          in 256-row batches (the statistics too).
  main    the paper's pipeline on SNB scale 10: greedy replication under
          ``nearest_copy`` for t = 1 and 2, the feasibility check and the
          home-first latencies, on the kernel backend; the kernels' launch
          counters are zeroed just before and read just after; the serial
          prune must launch ``prune_walk`` once per t.  The t = 1 run is
          repeated with the torch gate and must give the same mask.  One
          more t = 1 home-first walk is broken into the transient engine's
          packed upload, the chunks' uploads, the launches and the readback,
          each synchronised.  An
          untimed re-run records the rows of every launch of kernels 1-4.
  fused   the fused provisioning path on the same workload:
          ``replicate_workload(fused=True)`` under ``nearest_copy`` and
          ``nearest_copy_dp`` for t = 1 and 2 on the kernel backend
          (counters zeroed just before, read just after), each feasible
          under its policy with 0 failed paths and 0 routed violations,
          each prune one sweep launch (``prune_walk``, or
          ``prune_walk_scored`` under ``nearest_copy_dp``), ``fused_update``
          launched once per budget class call (not per batch), and no
          ``_dp_score_tables`` call inside the ``nearest_copy_dp`` drives'
          UPDATE (the kernel computes the scored gate); each policy's
          kernel-route prune is held against the torch backend's batched
          prune from the same pre-prune scheme (masks and counts equal, the
          ``bytes_saved`` difference printed); with unit
          sizes at t = 1 the kernel and torch backends must give the same
          mask.  Where a ``nearest_copy`` mask differs from the
          main phase's (sizes 1 + 0.1 * degree make near-tied candidate
          costs round by summation order), the first diverging UPDATE
          batch is found by replaying each class batch by batch and printed
          with the path and both costs.  An
          untimed re-run records the rows per launch, as in main.
  dp_prune  ``replicate_workload(policy="nearest_copy_dp")`` (fused=False,
          kernel backend) at t = 1 and 2 on the main workload, counters
          zeroed just before and read just after: feasible, 0 failed paths,
          0 routed violations, one ``prune_walk_scored`` launch per t.
          Each prune is then replayed untimed from the greedy's pre-prune
          scheme: the drive's mask and count, and no ``scored_walk`` launch
          inside it beyond its h0 feasibility walk.  The old per-candidate loop (a gate walk and a
          host round trip per candidate) is timed on the first 2,000 t = 1
          candidates; the scored kernel is held
          against ``prune_walk_scored_plain`` on those candidates (depths
          None and 2) and on seeded random cases with objects that have no
          holder; the whole t = 1 and t = 2 sweeps against the torch
          backend's batched prune from the same pre-prune schemes (keep
          flags, words and masks); the t = 1 sweep timed.
  executor  ``execute_workload`` on the main phase's t = 1 and t = 2 schemes
          under home_first, nearest_copy and nearest_copy_dp, with the home
          router, ``replica_lb`` and ``hedged`` (with ``hedge_replicas``),
          all servers alive and again after ``Event("fail", 0, 0)`` (the
          drain, with the greedy's resharding map, then ``repair_paths`` in
          rounds until the home-first bound holds; checked feasible): each
          case once on the kernel backend (counters zeroed just before,
          read just after: ``routed_walk`` or ``scored_walk`` must launch)
          and once on the torch backend, reports, server counters and
          failed queries equal; the launches per call, ``summary()`` per
          t, and one call's time by part (host fail-over and packing,
          uploads, the walk's enqueue and device time, readback, numpy
          accounting).
  planes  the engine planes on the main cell (the t = 1 ``nearest_copy``
          drive with ``return_engine=True``; counters zeroed just before each
          part and read just after): the dirty-set cache (1,000 seeded
          ``add_replicas``, 500 ``remove_replicas``, a mixed batch; after
          each, ``path_latencies(incremental=True)`` under all four policies
          on the kernel backend equal to a full evaluation and to the torch
          backend, with dirty rows, ``gathered_bytes``, launches and both
          evaluations' seconds); ``snb_drift`` on the scale-10 graph through
          ``replicate_delta`` on the engine, separate and fused (unit
          sizes), kernel = torch (masks, additions, stats), each phase
          feasible after its delta, and the aligned-batch delta equal to the
          from-scratch run; ``replicate_stream`` in 8 chunks equal to 8
          chunked deltas, one chunk resident, the overlap seconds; and
          ``replicate_workload(resilience=1)`` under home_first and
          nearest_copy (and nearest_copy fused, unit sizes), kernel = torch,
          0 violations, resilient-feasible on the card, with rounds,
          orphans, replicas, overhead and the case-walk / masked-UPDATE
          seconds; then ``benchmarks/torch_provisioning_policies.py``'s SNB
          figures with a flag for ``BENCH_provisioning.json``'s.
  serve   the serving stack on the main cell (the main phase's t = 1
          ``nearest_copy`` scheme, 20,000 queries at 20,000 qps): ``simulate``
          under home_first, nearest_copy and nearest_copy_dp (home router),
          ``replica_lb`` and ``hedged``, queue_aware with ``reroute_every``
          = 2,000 (10 rebuilds), batching + admission + ``HedgePolicy`` under
          a uniform t = 1 ``SLOSpec``, server 0 killed mid-run and revived,
          and ``hop_feedback`` closed loop (64 clients): each on the kernel
          backend (counters zeroed just before, read just after: one
          ``routed_walk`` / ``scored_walk`` launch per routing variant, none
          under hop feedback), every walk re-run on torch and equal, the
          whole ``SimReport`` against the torch backend's for home_first,
          the reroute case and the chaos case; p50 / p99 / p999, achieved
          qps, utilization, failed and shed queries and the host seconds
          by part (walk: packing, uploads, enqueue, readback; tree build;
          event loop).  Then ``snb_drift`` at scale 10 (3 x 2,000 queries)
          through an ``AdaptiveController`` on the drive's engine and on a
          torch twin (reports, masks, feasibility after each repair), one
          ``on_liveness_change`` with server 2 failed (resilient-feasible,
          0 violations), a home-first controller whose repair evicts (each
          window's incremental re-check equal to a full evaluation); and
          ``harness_simulate`` on the first 200 queries beside ``simulate``
          (every query completes, failed flags equal; the real-clock
          percentiles printed, not compared).
  mesh    the path-sharded fused greedy (``mesh=``) on the main cell (SNB
          scale 10, 6 servers, f = object sizes, kernel backend): a mesh of
          every visible card when there are several, else 4 shards on the
          one card and a 1-shard mesh; ``replicate_workload(fused=True,
          mesh=)`` under nearest_copy at t = 1 and 2, home_first and
          nearest_copy_dp at t = 1 (counters zeroed just before each drive,
          read just after: ``fused_update`` launched once per shard and
          batch, never as a class launch, on several shards, and as the
          single-card class launch on one shard), masks and integer stats
          equal to a single-device drive at the rounded batch size (and to
          the fused phase's), total cost within the float32 rounding of
          two summation orders, every replica equal; untimed with
          ``track_rm``, each drive's resharding map equal and the first
          mesh's total cost equal to the float64 sum of f over its map
          (within its float32 rounding); one ``replicate_delta`` (the
          planes phase's fused delta) and one 8-chunk ``replicate_stream``
          on each mesh equal to their single-device runs.  Printed:
          devices, shards, rounded batch, seconds per stage beside the
          single-device drive's, launches and the bytes exchanged
          between replicas.
  prune   the serial prune's kernel on the main path's inputs: the first
          2,000 t = 1 candidates through ``prune_walk`` and its plain loop
          under home_first, nearest_copy and queue_aware (keep flags and
          words identical), seeded random cases for the plain-loop bucket;
          the whole t = 1 and t = 2 sweeps against the batched prune on the
          torch backend from the same schemes (keep flags, words and masks
          identical, and the main phase's counts and masks equal to it);
          the t = 1 sweep timed with its µs per candidate, and the routed
          walk at the old per-candidate prune's median row count.
  shapes  kernels 1-4 timed once each at the median rows per launch of the
          path that launches them (main or fused; ``fused_update``: a class
          launch of the median class size), with their byte bounds;
          ``path_latency`` also with its launch plan and the bytes of the
          32-byte sectors its gathers touch.
  sweep   the engine's hot primitives at deployment scale (SNB scale 100,
          150,000 queries, ~1.4 M paths, 128 servers): kernel vs plain,
          exact, then each timed as the median of 5 runs after a warm-up;
          the scored walk over row chunks of those paths; the fused UPDATE
          on 256- and 65,536-row batches of the SNB scale 10 paths, and the
          whole scale 10 workload as one t = 1 class: one launch against
          the sequence of per-batch calls it replaced (equal results), with
          the plain time and the sum of the batches' bounds.
  quickstart  ``examples/torch_quickstart.py``'s table (SNB scale 1, 1,500
          queries, 6 servers, t = 0-3) on the kernel backend (counters
          zeroed just before, read just after) and on the torch backend:
          every t feasible, masks, replicas and executor summaries equal.
  tenants  ``benchmarks/torch_tenant_frontier.py``'s frontier (GNN t_Q 3 ->
          0, SNB at 1) on both backends: overhead monotone, 0 failed paths,
          masks and home-first latencies equal; a printed flag says
          whether the replica counts equal ``BENCH_tenants.json``'s; its
          drift part (per-tenant p99 under the arbitrating controller) on
          both backends, equal.
  lm_parity  the attention and embedding-bag kernels against their plain
          versions on seeded inputs: flash prefill (bf16 on the wgmma
          kernel, f32 on the CUDA-core kernel) on the JAX package's sweep
          shapes plus qwen2-7b's (KV 4, G 7, hd 128, S 4096: 128-row tiles
          cross positions mid-group), chatglm3's group of 16 with a window,
          a group of 5 at hd 32 and danube's (KV 8, G 4, hd 120, window
          4096, S 8192); decode on the sweep shapes plus T = 4100 with
          lengths 0 .. T and T = 1040 and 3001 (not multiples of the
          64-key split chunk) with lengths at the chunk edges; the bag in
          sum and mean with all-padding bags.  f32 at 2e-5 (TF32 off), bf16
          at 3e-2 (flash) and 2e-2 (decode), the bag at 1e-5.
  lm      qwen2-7b at full width in bf16 from a seeded random init:
          ``forward`` on 2 x 4,096 tokens with ``use_flash_prefill`` (28
          flash launches, all on the tensor-core kernel) and without
          (blockwise torch-op attention), the logits compared at the stated
          tolerance and the two forwards' seconds reported side by side; the same two forwards at
          full width in f32 with 2 layers, at 1e-4; then 4 prompts of 1,024
          tokens served by ``prefill`` and 16 greedy ``decode_step``s, each
          step's logits held against ``forward`` on the same tokens;
          ``ops.decode_attention`` on layer 0's cache against its plain
          version.  Each kernel is timed at these shapes beside its plain
          version and ``scaled_dot_product_attention``; the flash kernel's
          f32 route is timed at the same shape.
  bag     ``ops.embedding_bag`` at MIND's widths: a 2^26 x 64 f32 item
          table and 4,096 bags of 50 ids with ~10% padding, in mean and sum,
          against the plain version, timed beside ``F.embedding_bag``.
  lm_moe  twice: qwen3-moe-235b-a22b (4 MoE layers) and deepseek-v2-236b
          (its dense layer + 3 MoE layers, MLA) at full width in bf16 from
          a seeded init.  ``forward`` on 2 x 4,096 tokens (qwen3: with
          ``use_flash_prefill``, 4 launches all on the tensor-core kernel
          at G = 16, and without, each layer's attention flash vs torch ops
          at 3e-2; deepseek: the blockwise MLA branch, no flash launch);
          ``prefill`` 4 x 1,024 against ``forward`` over exactly those
          prompts at capacity factor 1.25 (the same drops); a copy at
          factor E/K + 1, which drops nothing, serving 4 x 512 prompts with
          16 greedy decode steps, each against ``forward`` (trap g).  Every
          ``moe_dispatch_plan`` call is recorded: dropped assignments per
          layer, and between two runs the tokens routed to other experts
          or dropped elsewhere (trap h), whose logits are reported and not
          checked; the first MoE layer may differ at no more than 10% of
          the tokens.  The decode step beside its byte bound (every
          expert read, trap j); qwen3's flash timed at G = 16 and its f32
          2-layer flash check at 1e-4.
  recsys  MIND FULL in f32 (2^26 x 64 items): ``serve_score`` at
          ``serve_p99`` (512 users x 100 candidates) and ``serve_bulk``
          (262,144 x 100), ``retrieval_score`` at ``retrieval_cand`` (1 x
          2^20), each against the same port code on the CPU for the first
          64 users at 1e-4, and timed.
  train   (run right after build, while the card's memory is
          unfragmented) the training path.  qwen2-7b at full width in bf16
          with 4 layers (remat blocks of 4 with the inner per-layer
          checkpoint, the head in two 16,384-token chunks) on lm_family's
          train_4k sequence at batch 8: 3 steps of lm_family's optimizer
          (counters zeroed just before, read just after: no flash_prefill
          launch), then 8 steps at a constant rate of 1e-4 on one batch;
          each step's loss, grad norm, seconds, tokens/s, peak memory and
          FLOPs against 989 TFLOP/s; the first loss within 0.05 of ln V +
          1/2, the repeated batch's loss falling, the flash branch refused
          under grad.  In f32 (TF32 off) qwen2 at 2 layers and d_model 448
          and the SMOKE qwen3-moe and deepseek-v2: loss and every gradient
          on the card against the CPU within 1e-4 of each leaf's largest,
          and equal with remat off and with the head unchunked.  The four
          GNNs on gnn_family's cells at FULL widths (graphsage-reddit on
          minibatch_lg over ogb_like(232,965, mean degree 50), graphcast
          on full_graph_sm, egnn and schnet on molecule): card = CPU on
          loss and gradients (graphcast in f64, its f32 gap printed: see
          GNN_F64_CHECK), then one optimizer step timed.  MIND at
          train_batch (B = 65,536, the item table cut to 2^24 rows) one
          step timed, and card = CPU at B = 1,024 over 2^20 items.
          train_lm on qwen2-7b's SMOKE config: a failure injected after
          step 5, the restart's losses equal to an uninterrupted run's.
  mesh_train  right after train's qwen2-7b run (before the other parts
          fragment the card's memory): a world-1 NCCL group and its 1 x 1
          ("data", "model") mesh, the same 3 steps with the parameters and
          AdamW moments as DTensors placed by param_specs (counters zeroed
          just before, read just after: 0 launches), losses and norms
          equal to train's bit for bit, step seconds and peak memory
          beside train's; elastic_drill through the mesh, bit-exact (the
          launch phase runs the same drill on one device); the GNN's
          split aggregation (SplitGraph) against dense in f64 (1e-12);
          compressed_psum over the
          group equal to the no-group result.  (Several cards: the
          ``cuda``-marked tests/test_torch_mesh_train_cuda.py.)
  mesh_serve  serving on a mesh, after recsys: a world-1 NCCL group and
          its 1 x 1 ("data", "model") mesh.  qwen2-7b at full width with
          MESH_SERVE_LAYERS layers in bf16, its parameters placed by the
          bundle's decode_32k layout (``shardings``, sized to the mesh):
          prefill of 4 x 1,024 prompts into 1,040 slots, then 16 decode
          steps fed the one-device run's greedy tokens; every step's logits
          and the cache bit-equal to one device's, seconds beside.  MIND
          FULL at serve_p99 (512 users x 100 candidates) placed by its
          cell's layout, scores bit-equal to one device's.  Counters zeroed
          just before the mesh drives, read just after: 0 launches (no
          kernel is on these paths in ``repro``).  (Several cards: the
          ``cuda``-marked tests/test_torch_mesh_serve_cuda.py.)
  launch  the last modules.  From the phase's start, DRYRUN_WORKERS host
          processes count the one-card dry-run's 36 cells on ``meta``
          tensors (``launch.dryrun.cell_row``) and POD_CELLS per rank on
          the 256 / 512-rank meshes (each on a placeholder group of its
          own; every kernel counter read in the worker: 0), while the card
          runs:
          (a) ``launch.serve.serve`` at the main cell (SNB-like scale 10,
          20,000 queries, 6 hash-sharded servers), t = 1 and t = 2 with
          the server-0 drill and t = 1 with ``hedge``, each on the kernel
          and the torch backend, reports equal field by field and masks
          equal, launches per kernel (counters zeroed just before each
          kernel-backend drive, read just after); (b) every bundle's
          ``smoke_step`` on the card and on the CPU, f32 losses within
          1e-4 relative; (d) ``launch.elastic.elastic_drill`` on qwen2-7b at
          full width with 2 layers, 2 x 512 tokens, bf16, 3 + 3 steps,
          bit-exact.  Then each dry-run row is printed, and every cell
          whose counted peak is under 70 GiB runs one real step on the
          card: ``FlopCounterMode`` equal to the ``meta`` count exactly, 0
          kernel launches, ``max_memory_allocated`` beside the peak.
The last two lines are the kernels' JSON summary (kernels 1-4 timed at
the sweep's shapes, and under "main_shape_*" at their paths' median
rows per launch; ``fused_update`` also under "class_*", the whole-class
launch) and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1.
Each timed call is timed twice: "ms" with the card idle at the start
event, so a call shorter than its host enqueue is timed from the host,
and "device_ms" behind a sleep kernel, so only the card's time counts.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

# the caching allocator grows its segments in place, in every phase: the
# train phase runs qwen2-7b's ~73 GB step twice (one device, then the
# 1 x 1 mesh), and with fixed segments the second run in a process finds
# no 3.5 GiB block in the first one's freed segments (either run alone
# fits on a fresh card); set before the first allocation
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
# H100 SXM 32-bit rate outside the tensor cores (67 T/s for float32 in the
# data sheet), taken as the peak of the fused UPDATE's integer mask ops
INT32_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate (data sheet)
# bf16 forward at full width, flash vs torch-op attention: the logits have
# std ~1; a 28-layer bf16 model at widths 448 and 896 on the CPU differed by
# at most 0.090 / 0.098 and 0.014 / 0.015 on average between the branches
LOGIT_MAX_TOL, LOGIT_MEAN_TOL = 0.5, 0.05
# bf16 attention against the exact f32 output of the same bf16 q, k, v:
# max |err| / rms of the output row (row_scaled_err) at most 4 bf16 ulps
# (2^-7 each) of that row's scale
FLASH_BF16_REL = 2.0 ** -5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def gpu_name_and_power() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip()


def ptxas_lines(build, src: str) -> list[str]:
    """The kernel names and the register, shared-memory and spill lines of
    ``nvcc -Xptxas=-v``'s output for one source, from the log that the build
    keeps beside the library."""
    log = build.library_path().parent / f"{src}.log"
    return [line.replace("ptxas info    :", "").strip() for line in log.read_text().splitlines()
            if "Compiling entry function" in line or "Used" in line or "spill" in line]


def phase_build(build) -> dict:
    t0 = time.perf_counter()
    build.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_name_and_power()
    print(smi, flush=True)
    out = {
        "phase": "build", "seconds": time.perf_counter() - t0,
        "nvcc_seconds": build.BUILD_SECONDS, "library": str(build.library_path()),
        "nvidia_smi": smi,
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "torch": torch.__version__, "cuda": torch.version.cuda, "numpy": np.__version__,
        "ptxas": {src: ptxas_lines(build, src)
                  for src in ("flash_prefill", "decode_attention", "path_latency", "routed_walk",
                              "prune_walk", "provision_update")},
    }
    emit(out)
    return out


def random_case(seed: int, P: int, L: int, n_srv: int, n_obj: int, dev):
    """Seeded random kernel inputs on the device."""
    g = torch.Generator(device=dev).manual_seed(seed)
    W = (n_srv + 31) // 32
    shard = torch.randint(0, n_srv, (n_obj,), generator=g, device=dev, dtype=torch.int32)
    hold = torch.rand((n_obj, W * 32), generator=g, device=dev) < 0.1
    hold[:, n_srv:] = False
    hold[torch.arange(n_obj, device=dev), shard.long()] = True
    hold[:, 31] |= torch.rand(n_obj, generator=g, device=dev) < 0.5   # the sign bit
    shifts = torch.arange(32, device=dev, dtype=torch.int64)
    w64 = (hold.view(n_obj, W, 32).long() << shifts).sum(-1)
    w32 = torch.where(w64 >= 2**31, w64 - 2**32, w64).to(torch.int32)
    words = torch.cat([w32, torch.zeros((1, W), dtype=torch.int32, device=dev)])
    # a few homes are -1 (no alive copy): clamped by the home-first walk,
    # a dead server for the routed walk
    shard[torch.rand(n_obj, generator=g, device=dev) < 0.01] = -1
    lengths = torch.randint(0, L + 1, (P,), generator=g, device=dev, dtype=torch.int32)
    objects = torch.randint(0, n_obj, (P, L), generator=g, device=dev, dtype=torch.int32)
    objects[torch.arange(L, device=dev)[None, :] >= lengths[:, None]] = -1
    start = torch.randint(-1, n_srv, (P,), generator=g, device=dev, dtype=torch.int32)
    load = torch.zeros(W * 32, dtype=torch.float32, device=dev)
    load[:n_srv] = torch.randint(0, 3, (n_srv,), generator=g, device=dev).float()  # ties
    return objects, lengths, words, shard, start, load


def fused_args(seed: int, B: int, L: int, n_srv: int, dev, combi):
    """A seeded random fused-UPDATE batch: (words, objects, lengths, shard,
    f, tables, counts, t, load) on the device, sizes multiples of 1/8."""
    objects, lengths, words, shard, _, load = random_case(seed, B, L, n_srv, 5000, dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    n = shard.shape[0]
    f = torch.randint(1, 24, (n,), generator=g, device=dev).float() / 8
    tables, counts = combi.stacked_tables(max(L - 1, 1), 2 if L > 6 else 1)
    t = torch.randint(0, 3, (B,), generator=g, device=dev, dtype=torch.int32)
    return (words, objects, lengths, shard.clamp_min(0), f,
            torch.from_numpy(tables).to(dev), torch.from_numpy(counts).to(dev), t, load)


def fused_gates(routing):
    """Gate mode -> (policy, whether it ranks holders by the load)."""
    return {
        "none": (None, False),
        "routed": (routing.resolve_policy("nearest_copy"), False),
        "no_lookahead": (routing.NearestCopy(lookahead=False), False),
        "queue_aware": (routing.resolve_policy("queue_aware"), True),
        "scored": (routing.nearest_copy_dp(), False),
        "scored_depth2": (routing.nearest_copy_dp(2), False),
    }


def phase_parity(pl, rw, pu, backends, routing, combi, dev, P: int) -> dict:
    t0 = time.perf_counter()
    cases = []
    max_err = {"path_latency": 0, "routed_walk": 0, "scored_walk": 0, "fused_update": 0.0}
    for L in (1, 6, 9):
        for n_srv in (6, 40, 128):
            objects, lengths, words, shard, start, load = random_case(
                L * 1000 + n_srv, P, L, n_srv, 500_000, dev)
            got = pl.path_latency(objects, lengths, words, shard)
            want = pl.path_latency_plain(objects, lengths, words, shard)
            err = int((got - want).abs().max())
            max_err["path_latency"] = max(max_err["path_latency"], err)
            check(torch.equal(got, want), f"path_latency L={L} S={n_srv}")
            for mode, lv in (("home_first", load), ("nearest_copy", torch.zeros_like(load)),
                             ("queue_aware", load)):
                kw = dict(home_first=mode == "home_first", lookahead=mode != "home_first")
                s, loc = rw.routed_walk(objects, lengths, words, shard, start, lv, **kw)
                ws, wl = rw.routed_walk_plain(objects, lengths, words, shard, start, lv, **kw)
                err = int((s - ws).abs().max()) + int((loc != wl).sum())
                max_err["routed_walk"] = max(max_err["routed_walk"], err)
                check(torch.equal(s, ws) and torch.equal(loc, wl),
                      f"routed_walk {mode} L={L} S={n_srv}")
            for depth in (-1, 2):
                scores = backends._dp_score_tables(objects, lengths, words, depth)
                s, loc = rw.scored_walk(objects, lengths, words, shard, start, scores)
                ws, wl = rw.scored_walk_plain(objects, lengths, words, shard, start, scores)
                err = int((s - ws).abs().max()) + int((loc != wl).sum())
                max_err["scored_walk"] = max(max_err["scored_walk"], err)
                check(torch.equal(s, ws) and torch.equal(loc, wl),
                      f"scored_walk depth={depth} L={L} S={n_srv}")
                del scores
            cases.append({"L": L, "n_servers": n_srv, "mean_h": float(got.float().mean())})
    # path_latency at its route boundaries (the ring of pl.GROUP positions,
    # staged / in place, whole word rows for W <= 4 / one word past) and on
    # row slices from an odd row (an unaligned staged span)
    for L in (8, 9, 17, 65, 200):
        for n_srv in (80, 160, 400):
            objects, lengths, words, shard, _, _ = random_case(
                L * 1000 + n_srv + 1, 200_000, L, n_srv, 100_000, dev)
            for o, ln in ((objects, lengths), (objects[1:], lengths[1:])):
                got = pl.path_latency(o, ln, words, shard)
                want = pl.path_latency_plain(o, ln, words, shard)
                max_err["path_latency"] = max(max_err["path_latency"],
                                              int((got - want).abs().max()))
                check(torch.equal(got, want),
                      f"path_latency L={L} S={n_srv} offset={o.data_ptr() % 16}")
    fused_cases = []
    for gate, (pol, ranked) in fused_gates(routing).items():
        for L, n_srv in ((1, 6), (6, 40), (9, 128)):
            words, *args = fused_args(L * 100 + n_srv, 256, L, n_srv, dev, combi)
            if not ranked:
                args[-1] = torch.zeros_like(args[-1])
            got = pu.fused_update(words.clone(), *args, pol=pol)
            want = pu.fused_update_plain(words.clone(), *args, pol=pol)
            err = float((got[1] - want[1]).abs().max())
            err += sum(int((g != w).sum()) for g, w in zip(got[2:], want[2:]))
            err += int((got[0][:-1] != want[0][:-1]).sum())  # sacrificial row: a sink
            max_err["fused_update"] = max(max_err["fused_update"], err)
            check(err == 0, f"fused_update {gate} L={L} S={n_srv}")
            fused_cases.append({"gate": gate, "L": L, "n_servers": n_srv,
                                "additions": int(got[3].sum()),
                                "skipped": int(got[5].sum()),
                                "no_solution": int(got[2].sum())})
            # the class launch: 700 rows in batches of 256 (the last partial)
            words, *args = fused_args(L * 100 + n_srv + 7, 700, L, n_srv, dev, combi)
            if not ranked:
                args[-1] = torch.zeros_like(args[-1])
            acc_k = torch.zeros(3, device=dev)
            acc_p = torch.zeros(3, device=dev)
            got = pu.fused_update_class(words.clone(), *args, acc_k, pol=pol)
            want = pu.fused_update_class_plain(words.clone(), *args, acc_p, pol=pol)
            err = float((got[1] - want[1]).abs().max()) + float((acc_k - acc_p).abs().max())
            err += sum(int((g != w).sum()) for g, w in zip(got[2:], want[2:]))
            err += int((got[0][:-1] != want[0][:-1]).sum())
            max_err["fused_update"] = max(max_err["fused_update"], err)
            check(err == 0, f"fused_update_class {gate} L={L} S={n_srv}")
    torch.cuda.synchronize()
    out = {"phase": "parity", "seconds": time.perf_counter() - t0, "paths": P,
           "cases": cases, "fused_batches": fused_cases, "max_abs_err": max_err,
           "exact": True}
    emit(out)
    return out


def snb_case(graph_mod, workload_mod, scale: int, n_queries: int, n_srv: int):
    """SNB-like graph, its short-read paths, a hash sharding and sizes."""
    snb = graph_mod.snb_like(scale=scale, seed=0)
    ps = workload_mod.snb_workload_materialized(snb, n_queries=n_queries, seed=0)
    shard = graph_mod.hash_partition(snb.graph.n_nodes, n_srv)
    return snb, ps, shard, snb.graph.object_sizes().astype(np.float32)


# the launch counters, in the order of main()'s `counters`; flash_prefill_tc
# counts the flash launches that went to the tensor-core kernel
KERNELS = ("path_latency", "routed_walk", "scored_walk", "fused_update",
           "flash_prefill", "flash_prefill_tc", "decode_attention", "embedding_bag",
           "prune_walk", "prune_walk_scored")


def zero_counts(mods) -> None:
    for m, attr in mods:
        setattr(m, attr, 0)


def read_counts(mods) -> dict:
    return {name: getattr(m, attr) for name, (m, attr) in zip(KERNELS, mods)}


def row_targets(backends, greedy) -> dict:
    """Kernel rows 1-4 -> (module, name its caller looks up, position of the
    [P, L] objects argument)."""
    return {"path_latency": (backends, "path_latency", 0),
            "routed_walk": (backends, "routed_walk", 0),
            "scored_walk": (backends, "scored_walk", 0),
            "fused_update": (greedy, "fused_update_class", 1)}


@contextlib.contextmanager
def record_rows(targets: dict):
    """Record the path rows P of every launch of the targets' kernels while
    the block runs: each name is replaced, where its caller looks it up, by
    a function that notes ``objects.shape[0]`` of a launching call (a CUDA
    tensor with P > 0) and calls the wrapper."""
    seen = {name: [] for name in targets}
    originals = {name: getattr(mod, attr) for name, (mod, attr, _) in targets.items()}

    def recorder(name, fn, pos):
        def rec(*args, **kwargs):
            objects = args[pos]
            if objects.is_cuda and objects.shape[0]:
                seen[name].append(int(objects.shape[0]))
            return fn(*args, **kwargs)
        return rec

    for name, (mod, attr, pos) in targets.items():
        setattr(mod, attr, recorder(name, originals[name], pos))
    try:
        yield seen
    finally:
        for name, (mod, attr, _) in targets.items():
            setattr(mod, attr, originals[name])


def rows_per_launch(counters, targets: dict, calls) -> dict:
    """min / median / max path rows per launch of kernels 1-4 over an
    untimed re-run of ``calls``, outside every measured window: the
    counters are zeroed before it, and the recorded calls must be the
    launches it counted."""
    zero_counts(counters)
    with record_rows(targets) as seen:
        for call in calls:
            call()
    launches = read_counts(counters)
    out = {}
    for name, ps in seen.items():
        check(len(ps) == launches[name],
              f"{name}: {len(ps)} recorded calls vs {launches[name]} counted launches")
        if ps:
            out[name] = {"launches": len(ps), "min": min(ps),
                         "median": int(statistics.median_low(ps)), "max": max(ps)}
    return out


@contextlib.contextmanager
def home_first_parts(engine_core, streaming, backends):
    """While the block runs, time the pieces of the home-first walk
    (``path_latencies``) on the host, each synchronised before and after:
    the transient engine's packed upload (``PackedScheme.from_mask``, the
    host packing with it), the chunks' uploads (``stream_chunks``'
    ``to_device``, two per chunk), the launches (``backends.kernel_eval``;
    also between CUDA events, the card's time) and the readback
    (``to_host``).  The syncs add their own cost: this is a breakdown, not
    the stage's time."""
    parts = {"packed_upload_s": 0.0, "chunk_uploads_s": 0.0, "launches_s": 0.0,
             "launches_device_ms": 0.0, "readback_s": 0.0, "chunk_uploads": 0,
             "chunk_upload_bytes": 0, "launches": 0}
    packed_cls = engine_core.PackedScheme
    orig = (packed_cls.__dict__["from_mask"], streaming.to_device, backends.kernel_eval,
            engine_core.to_host)

    def clocked(key, fn, count=None, events=False):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            res = fn(*args, **kwargs)
            b.record()
            torch.cuda.synchronize()
            parts[key] += time.perf_counter() - t0
            if events:
                parts["launches_device_ms"] += a.elapsed_time(b)
            if count:
                parts[count] += 1
            if key == "chunk_uploads_s":
                parts["chunk_upload_bytes"] += int(res.nbytes)
            return res
        return wrapped

    packed_cls.from_mask = staticmethod(clocked("packed_upload_s", packed_cls.from_mask))
    streaming.to_device = clocked("chunk_uploads_s", orig[1], "chunk_uploads")
    backends.kernel_eval = clocked("launches_s", orig[2], "launches", events=True)
    engine_core.to_host = clocked("readback_s", orig[3])
    try:
        yield parts
    finally:
        packed_cls.from_mask = orig[0]
        streaming.to_device, backends.kernel_eval, engine_core.to_host = orig[1:]


def phase_main(T, counters, targets, case, engine_mod, engine_core, streaming, backends,
               scale: int, n_queries: int) -> dict:
    t0 = time.perf_counter()
    snb, ps, shard, f = case
    n = snb.graph.n_nodes
    runs = {}
    schemes = {}
    hs = {}
    # the main path: counters zeroed just before, read just after
    zero_counts(counters)
    engine_mod.TRANSFER.reset()
    for t in (1, 2):
        ts = time.perf_counter()
        scheme, st = T.replicate_workload(ps, shard, 6, t, f=f, policy="nearest_copy")
        greedy_s = time.perf_counter() - ts
        tf = time.perf_counter()
        feasible = T.is_latency_feasible(ps, scheme, t, policy="nearest_copy")
        feas_s = time.perf_counter() - tf
        th = time.perf_counter()
        h = T.path_latencies(ps, scheme)
        h_s = time.perf_counter() - th
        hs[t] = h
        check(feasible, f"t={t}: scheme not feasible under nearest_copy")
        check(st.failed_paths == 0, f"t={t}: {st.failed_paths} failed paths")
        check(st.routed_violations == 0, f"t={t}: {st.routed_violations} routed violations")
        check(h.shape == (ps.n_paths,) and h.dtype == np.int32 and int(h.min()) >= 0,
              f"t={t}: home-first latencies malformed")
        schemes[t] = scheme
        runs[t] = {
            "replicas": st.replicas, "pruned": st.pruned_replicas,
            "overhead": scheme.replication_overhead(f.astype(np.float64)),
            "failed_paths": st.failed_paths, "routed_violations": st.routed_violations,
            "routed_skips": st.routed_skips, "fallback_paths": st.fallback_paths,
            "paths_processed": st.paths_processed, "feasible": feasible,
            "home_first_max_h": int(h.max()), "home_first_mean_h": float(h.mean()),
            "greedy_s": greedy_s,
            "stage_s": dict(st.stage_s, feasibility=feas_s, home_first_latencies=h_s),
        }
    launches = read_counts(counters)
    transfer = engine_mod.TRANSFER.snapshot()
    check(launches["path_latency"] > 0, "path_latency kernel not launched on the main path")
    check(launches["routed_walk"] > 0, "routed_walk kernel not launched on the main path")
    check(launches["prune_walk"] == 2,
          f"prune_walk launched {launches['prune_walk']} times on the main path, "
          "expected 2 (one serial prune per t)")
    # where the home-first stage goes: one more t = 1 walk, its pieces clocked
    with home_first_parts(engine_core, streaming, backends) as home_first:
        th = time.perf_counter()
        h = T.path_latencies(ps, schemes[1])
        home_first["total_s"] = time.perf_counter() - th
    check(home_first["launches"] > 0 and np.array_equal(h, hs[1]),
          "home-first breakdown drive")
    print(f"main t=1 home-first breakdown: {home_first}", flush=True)
    # the t = 1 run with the plain torch gate must give the same mask
    tt = time.perf_counter()
    scheme_t, st_t = T.replicate_workload(ps, shard, 6, 1, f=f, policy="nearest_copy",
                                          policy_backend="torch")
    torch_gate_s = time.perf_counter() - tt
    check(np.array_equal(scheme_t.mask, schemes[1].mask), "t=1 torch-gate mask differs")
    # a small reference check: kernel engine vs the pure-python oracle
    small = ps.select(np.arange(min(2000, ps.n_paths)))
    for pol in ("home_first", "nearest_copy"):
        k = engine_mod.LatencyEngine(schemes[1]).path_latencies(small, policy=pol)
        r = engine_mod.LatencyEngine(schemes[1], backend="reference").path_latencies(small, policy=pol)
        check(np.array_equal(k, r), f"kernel engine vs reference oracle ({pol})")

    def rerun(t):
        scheme = T.replicate_workload(ps, shard, 6, t, f=f, policy="nearest_copy")[0]
        T.is_latency_feasible(ps, scheme, t, policy="nearest_copy")
        T.path_latencies(ps, scheme)

    rows = rows_per_launch(counters, targets, [lambda t=t: rerun(t) for t in (1, 2)])
    out = {
        "phase": "main", "seconds": time.perf_counter() - t0,
        "scale": scale, "n_queries": n_queries, "objects": int(n),
        "edges": int(snb.graph.n_edges), "paths": ps.n_paths, "max_len": ps.max_len,
        "n_servers": 6, "policy": "nearest_copy", "runs": runs, "launches": launches,
        "rows_per_launch": rows, "transfer": transfer, "home_first_breakdown_t1": home_first,
        "torch_gate_t1_identical": True, "torch_gate_t1_s": torch_gate_s,
        "torch_gate_t1_stage_s": st_t.stage_s,
    }
    emit(out)
    out["schemes"] = schemes
    return out


def first_update_divergence(T, greedy, backends, pu, case, t: int, pol: str) -> dict:
    """Where ``fused=True`` first parts from the separate pipeline.

    Reruns ``replicate_workload(fused=True)`` on the kernel backend and
    replays each of its ``fused_update_class`` calls batch by batch on a
    copy of the class's words: each batch is priced twice on the same
    snapshot, with the ``fused_update`` kernel (costs summed x-major over
    [L, Hp1]) and with the separate pipeline's gate + ``_update_batch_core``
    (einsum costs), and the snapshot then takes the kernel's additions, as
    the class launch does.  The first batch whose choices differ is
    reported with the path, both float32 costs and each choice's cost
    summed in float64.  Later batches price different snapshots, so only the
    first divergence is compared.
    """
    _, ps, shard, f = case
    orig = greedy.fused_update_class
    seen = {"batches": 0, "classes": 0, "first": None}

    def probe(words, objects, lengths, shard_d, f_d, tables, counts, t_d, rank, acc,
              batch_size=256, pol=None):
        dev = objects.device
        none = torch.zeros(1, device=dev)
        w = words.clone()
        for i in range(0, objects.shape[0], batch_size):
            if seen["first"] is not None:
                break
            o, ln, tb = (x[i : i + batch_size] for x in (objects, lengths, t_d))
            k = pu.fused_update(w.clone(), o, ln, shard_d, f_d, tables, counts, tb, rank,
                                pol=pol)
            h_rt = (torch.zeros_like(tb) if pol is None else
                    backends.gate_counts(o, ln, w, shard_d, pol, rank, backend="kernel"))
            e = greedy._update_batch_core(w.clone(), o, ln, shard_d, f_d, tables, counts, tb,
                                          h_rt, none, none, none, False, pol is not None)
            rows = torch.nonzero((k[3] != e[3]).flatten(1).any(dim=1)).flatten()
            if len(rows):
                r = int(rows[0])
                fx = f_d[o[r].clamp_min(0).long()].double()
                exact = lambda ch: float((ch[r].double().sum(dim=1) * fx).sum())  # noqa: E731
                seen["first"] = {
                    "class": seen["classes"], "batch": seen["batches"] + i // batch_size,
                    "rows": int(o.shape[0]), "paths_differing": len(rows), "row": r,
                    "objects": o[r, : int(ln[r])].tolist(), "t": int(tb[r]),
                    "kernel_cost": float(k[1][r]), "einsum_cost": float(e[1][r]),
                    "kernel_choice_cost_f64": exact(k[3]),
                    "einsum_choice_cost_f64": exact(e[3]),
                }
            w = k[0]
        seen["batches"] += -(-objects.shape[0] // batch_size)
        seen["classes"] += 1
        return orig(words, objects, lengths, shard_d, f_d, tables, counts, t_d, rank, acc,
                    batch_size=batch_size, pol=pol)

    greedy.fused_update_class = probe
    try:
        T.replicate_workload(ps, shard, 6, t, f=f, policy=pol, fused=True)
    finally:
        greedy.fused_update_class = orig
    return {"fused_classes": seen["classes"], "fused_batches": seen["batches"],
            "first_divergence": seen["first"]}


@contextlib.contextmanager
def watch_update_class(greedy, backends, pu):
    """While the block runs, count greedy's ``fused_update_class`` calls
    that launch (rows > 0), their snapshot batches, and the
    ``_dp_score_tables`` calls made inside them or elsewhere (through the
    names both modules look it up by)."""
    seen = {"class_calls": 0, "batches": 0, "dp_tables_in_update": 0,
            "dp_tables_elsewhere": 0}
    inside = [False]
    orig = (greedy.fused_update_class, backends._dp_score_tables, pu._dp_score_tables)

    def cls(words, objects, *args, batch_size=256, **kwargs):
        if objects.shape[0]:
            seen["class_calls"] += 1
            seen["batches"] += -(-objects.shape[0] // batch_size)
        inside[0] = True
        try:
            return orig[0](words, objects, *args, batch_size=batch_size, **kwargs)
        finally:
            inside[0] = False

    def counted(fn):
        def wrapped(*args, **kwargs):
            seen["dp_tables_in_update" if inside[0] else "dp_tables_elsewhere"] += 1
            return fn(*args, **kwargs)
        return wrapped

    greedy.fused_update_class = cls
    backends._dp_score_tables = counted(orig[1])
    pu._dp_score_tables = counted(orig[2])
    try:
        yield seen
    finally:
        greedy.fused_update_class, backends._dp_score_tables, pu._dp_score_tables = orig


@contextlib.contextmanager
def update_parts(greedy):
    """While the block runs, time the kernel route's UPDATE of each budget
    class (``greedy._run_update_class``) and its pieces on the host, each
    synchronised before and after: its uploads (``to_device``), its class
    call (``fused_update_class``; also between CUDA events, the card's
    time) and its statistics readback (``DeviceStatsAcc.drain``).  The
    syncs add their own cost: this is a breakdown, not the stage's time."""
    parts = {"run_update_class_s": 0.0, "upload_s": 0.0, "class_call_s": 0.0,
             "class_device_ms": 0.0, "drain_s": 0.0, "uploads": 0, "class_calls": 0,
             "upload_bytes_s": []}
    inside = [False]
    orig = (greedy._run_update_class, greedy.to_device, greedy.fused_update_class,
            greedy.DeviceStatsAcc.drain)

    def clocked(key, fn, count=None, events=False, outer=False):
        def wrapped(*args, **kwargs):
            if not (outer or inside[0]):
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            inside[0] = True
            try:
                res = fn(*args, **kwargs)
            finally:
                inside[0] = not outer
            b.record()
            torch.cuda.synchronize()
            parts[key] += time.perf_counter() - t0
            if key == "upload_s":
                parts["upload_bytes_s"].append((int(res.nbytes), time.perf_counter() - t0))
            if events:
                parts["class_device_ms"] += a.elapsed_time(b)
            if count:
                parts[count] += 1
            return res
        return wrapped

    greedy._run_update_class = clocked("run_update_class_s", orig[0], outer=True)
    greedy.to_device = clocked("upload_s", orig[1], "uploads")
    greedy.fused_update_class = clocked("class_call_s", orig[2], "class_calls", events=True)
    greedy.DeviceStatsAcc.drain = clocked("drain_s", orig[3])
    try:
        yield parts
    finally:
        (greedy._run_update_class, greedy.to_device, greedy.fused_update_class,
         greedy.DeviceStatsAcc.drain) = orig


def fused_prune_check(T, case, pol: str, t: int, drive_scheme, dev) -> dict:
    """The ``fused=True`` prune's kernel route (one ``prune_walk`` sweep,
    ``prune_walk_scored`` under ``nearest_copy_dp``) against an independent
    version: the torch backend's batched prune (independent groups, plain
    torch walks) from the same pre-prune scheme of the fused greedy under
    ``pol``.  Masks and counts must be equal, and the drive's mask equal to
    the kernel route's; ``bytes_saved`` is the same sizes summed in another
    order (candidate order vs group by group), so its difference is
    printed, not checked."""
    _, ps, shard, f = case
    pre, _ = T.replicate_workload(ps, shard, 6, t, f=f, policy=pol, fused=True,
                                  policy_prune=False)
    ker, ref = pre.copy(), pre.copy()
    tk = time.perf_counter()
    n_k, b_k = T.prune_scheme_replicas(ker, ps, t, policy=pol, f=f, fused=True, device=dev)
    tr = time.perf_counter()
    n_r, b_r = T.prune_scheme_replicas(ref, ps, t, policy=pol, f=f, fused=True,
                                       backend="torch", device=dev)
    ref_s = time.perf_counter() - tr
    cells = int((ker.mask != ref.mask).sum())
    check(cells == 0 and n_k == n_r,
          f"fused {pol} t={t}: the kernel-route prune differs from the torch batched prune "
          f"in {cells} cells ({n_k} vs {n_r} removed)")
    check(np.array_equal(drive_scheme.mask, ker.mask),
          f"fused {pol} t={t}: the drive's mask vs its prune's kernel route")
    print(f"fused {pol} t={t}: bytes_saved kernel route {b_k!r}, torch batched {b_r!r}, "
          f"difference {b_k - b_r!r}", flush=True)
    return {"removed": n_k, "mask_cells_differ": cells, "bytes_saved_kernel": b_k,
            "bytes_saved_reference": b_r, "bytes_saved_diff": b_k - b_r,
            "kernel_s": tr - tk, "reference_s": ref_s}


def phase_fused(T, greedy, backends, pu, counters, targets, case, main_schemes: dict,
                dev) -> dict:
    t0 = time.perf_counter()
    snb, ps, shard, f = case
    runs = {}
    schemes = {}
    watched = {}
    # the fused path: counters zeroed just before, read just after
    zero_counts(counters)
    for pol in ("nearest_copy", "nearest_copy_dp"):
        for t in (1, 2):
            ts = time.perf_counter()
            with watch_update_class(greedy, backends, pu) as watched[f"{pol}/t={t}"]:
                scheme, st = T.replicate_workload(ps, shard, 6, t, f=f, policy=pol,
                                                  fused=True)
            greedy_s = time.perf_counter() - ts
            feasible = T.is_latency_feasible(ps, scheme, t, policy=pol)
            check(feasible, f"fused {pol} t={t}: scheme not feasible under {pol}")
            check(st.failed_paths == 0, f"fused {pol} t={t}: {st.failed_paths} failed paths")
            check(st.routed_violations == 0,
                  f"fused {pol} t={t}: {st.routed_violations} routed violations")
            schemes[pol, t] = scheme
            runs[f"{pol}/t={t}"] = {
                "replicas": st.replicas, "pruned": st.pruned_replicas,
                "overhead": scheme.replication_overhead(f.astype(np.float64)),
                "failed_paths": st.failed_paths, "routed_violations": st.routed_violations,
                "routed_skips": st.routed_skips, "fallback_paths": st.fallback_paths,
                "feasible": feasible, "greedy_s": greedy_s, "stage_s": st.stage_s,
            }
    launches = read_counts(counters)
    check(launches["fused_update"] > 0, "fused_update kernel not launched on the fused path")
    # one launch per budget class, not one per batch
    class_calls = sum(w["class_calls"] for w in watched.values())
    batches = sum(w["batches"] for w in watched.values())
    print(f"fused: fused_update launched {launches['fused_update']} times for {class_calls} "
          f"class calls of {batches} batches", flush=True)
    check(launches["fused_update"] == class_calls,
          f"fused_update launched {launches['fused_update']} times for {class_calls} class "
          f"calls ({batches} batches), expected one launch per class call")
    for key, w in watched.items():
        if key.startswith("nearest_copy_dp"):
            check(w["dp_tables_in_update"] == 0,
                  f"fused {key}: _dp_score_tables called {w['dp_tables_in_update']} times "
                  "in the UPDATE, expected 0 (the kernel computes the scored gate)")
    check(launches["scored_walk"] > 0, "scored_walk kernel not launched on the fused path")
    for name in ("prune_walk", "prune_walk_scored"):
        check(launches[name] == 2, f"{name} launched {launches[name]} times on the fused path, "
                                   "expected 2 (one prune per t)")
    prune_check = {f"{pol}/t={t}": fused_prune_check(T, case, pol, t, schemes[pol, t], dev)
                   for pol in ("nearest_copy", "nearest_copy_dp") for t in (1, 2)}
    # where the kernel route's UPDATE stage goes: one more t = 1 drive per
    # policy with its pieces clocked (uploads include the gate's, which run
    # through the same name)
    breakdown = {}
    for pol in ("nearest_copy", "nearest_copy_dp"):
        with update_parts(greedy) as parts:
            _, st = T.replicate_workload(ps, shard, 6, 1, f=f, policy=pol, fused=True)
        breakdown[pol] = dict(parts, update_stage_s=st.stage_s["update"])
        print(f"fused {pol} t=1 UPDATE breakdown: {breakdown[pol]}", flush=True)
    # fused=True vs the main phase's fused=False (f = object_sizes): the
    # kernel sums each cost in its own order, so near-ties may resolve
    # differently (ROADMAP trap c); printed, not checked
    same_as_separate = {
        f"t={t}": bool(np.array_equal(schemes["nearest_copy", t].mask, main_schemes[t].mask))
        for t in (1, 2)
    }
    divergence = {}
    for t in (1, 2):
        if not same_as_separate[f"t={t}"]:
            diff = np.argwhere(schemes["nearest_copy", t].mask != main_schemes[t].mask)
            divergence[f"t={t}"] = dict(
                first_update_divergence(T, greedy, backends, pu, case, t, "nearest_copy"),
                mask_cells_differ=len(diff), first_cell=diff[0].tolist())
            print(f"fused vs separate nearest_copy t={t}: {divergence[f't={t}']}", flush=True)
    # unit sizes make every candidate cost exact: kernel == torch backend
    unit = {}
    for pol in ("nearest_copy", "nearest_copy_dp"):
        tk = time.perf_counter()
        k_scheme, k_st = T.replicate_workload(ps, shard, 6, 1, policy=pol, fused=True)
        tt = time.perf_counter()
        t_scheme, t_st = T.replicate_workload(ps, shard, 6, 1, policy=pol, fused=True,
                                              policy_backend="torch")
        check(np.array_equal(k_scheme.mask, t_scheme.mask),
              f"fused unit-f t=1 {pol}: kernel and torch backends differ")
        unit[pol] = {"replicas": k_st.replicas, "kernel_s": tt - tk,
                     "torch_s": time.perf_counter() - tt,
                     "kernel_stage_s": k_st.stage_s, "torch_stage_s": t_st.stage_s}

    def rerun(pol, t):
        scheme = T.replicate_workload(ps, shard, 6, t, f=f, policy=pol, fused=True)[0]
        T.is_latency_feasible(ps, scheme, t, policy=pol)

    rows = rows_per_launch(counters, targets,
                           [lambda pol=pol, t=t: rerun(pol, t)
                            for pol in ("nearest_copy", "nearest_copy_dp") for t in (1, 2)])
    out = {
        "phase": "fused", "seconds": time.perf_counter() - t0, "paths": ps.n_paths,
        "n_servers": 6, "runs": runs, "launches": launches,
        "update_classes": watched, "update_breakdown_t1": breakdown, "rows_per_launch": rows,
        "prune_vs_torch_batched": prune_check,
        "nearest_copy_same_as_separate": same_as_separate,
        "nearest_copy_divergence": divergence,
        "unit_f_t1_kernel_equals_torch": True, "unit_f_t1": unit,
    }
    emit(out)
    return dict(out, schemes=schemes)


EXEC_POLICIES = ("home_first", "nearest_copy", "nearest_copy_dp")
# (router, hedge_replicas): the coordinator pick and the per-hop hedge
EXEC_ROUTES = ((None, False), ("replica_lb", False), ("hedged", True))
REPORT_FIELDS = ("query_latency_us", "query_traversals", "per_server_local", "per_server_rpcs",
                 "query_failed")


def execute_once(TD, scheme, ps, dead, policy, router, hedge, backend):
    """One ``execute_workload`` on a fresh cluster over ``scheme`` with the
    ``dead`` servers failed: (report, the servers' counters, seconds)."""
    cluster = TD.Cluster(scheme)
    for s in dead:
        cluster.fail_server(s)
    rt = None if router is None else TD.Router(scheme, router)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = TD.execute_workload(cluster, ps, TD.LatencyModel(), seed=0, hedge_replicas=hedge,
                              router=rt, policy=policy, backend=backend)
    seconds = time.perf_counter() - t0
    counters = [(s.local_accesses, s.remote_rpcs_in, s.queries_coordinated)
                for s in cluster.servers]
    return rep, counters, seconds


def reports_equal(a, b) -> bool:
    return (all(np.array_equal(getattr(a, k), getattr(b, k)) for k in REPORT_FIELDS)
            and a.throughput_qps == b.throughput_qps)


def executor_parts(TD, executor, backends, streaming, scheme, ps, policy, dev) -> dict:
    """One ``execute_workload`` call's time by part (home router, all
    alive): the host's fail-over map and packing (``walk_inputs``), the four
    uploads, the walk (its host enqueue, and its device time behind a
    sleep kernel), the two readbacks, each synchronised; and the numpy
    accounting, the call's time less its walk (``trace_paths``, clocked in
    a second call)."""
    alive = np.ones(scheme.n_servers, bool)
    parts = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    objects, lengths, words, home, _ = executor.walk_inputs(ps, scheme, alive)
    parts["host_failover_pack_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    up = [streaming.to_device(a, dev) for a in (objects, lengths, words, home)]
    torch.cuda.synchronize()
    parts["uploads_s"] = time.perf_counter() - t0
    parts["upload_bytes"] = int(sum(a.nbytes for a in (objects, lengths, words, home)))

    def walk():
        return backends.access_trace(*up, policy=policy, backend="kernel")

    walk()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    servers, local = walk()
    parts["walk_enqueue_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    parts["walk_s"] = time.perf_counter() - t0
    parts["walk_device_ms"] = time_ms(walk, reps=5, busy_first=True)
    t0 = time.perf_counter()
    streaming.to_host(servers), streaming.to_host(local)
    parts["readback_s"] = time.perf_counter() - t0
    # the whole call, and its walk clocked inside it
    orig = executor.trace_paths
    walk_s = []

    def clocked(*args, **kwargs):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = orig(*args, **kwargs)
        walk_s.append(time.perf_counter() - t1)
        return res

    executor.trace_paths = clocked
    try:
        _, _, total = execute_once(TD, scheme, ps, (), policy, None, False, "kernel")
    finally:
        executor.trace_paths = orig
    parts.update(call_s=total, trace_paths_s=sum(walk_s),
                 accounting_s=total - sum(walk_s))
    return parts


REPAIR_ROUNDS = 8


def fail_and_repair(T, TD, faults, base, rm, ps, t: int, fsz):
    """Server 0 fails (``Event("fail", 0, 0)``: its partition drains onto
    the least-loaded survivor, the replicas its originals' resharding-map
    entries name follow them) and ``repair_paths`` restores the home-first
    bound, on a copy of ``base``.  A repair adds copies for one violating
    path after another, and a copy added for a later path can move an
    earlier repaired path's home-first walk (a walk stays where a copy is),
    so the repair runs in rounds until no path violates, at most
    ``REPAIR_ROUNDS``.  Returns (scheme, report)."""
    failed = T.ReplicationScheme(base.mask.copy(), base.shard.copy())
    cluster = TD.Cluster(failed, f=fsz)
    rmap = T.ReshardingMap.from_entries(rm, failed.shard)
    t0 = time.perf_counter()
    event = faults.apply_event(cluster, rmap, TD.Event("fail", 0, 0), fsz)
    drain_s = time.perf_counter() - t0
    rounds = []
    feasible = False
    for _ in range(REPAIR_ROUNDS):
        res = T.repair_paths(failed, rmap, ps, t, fsz)
        rounds.append(res)
        feasible = T.is_latency_feasible(ps, failed, t)
        if feasible or res["failed_paths"]:
            break
    return failed, {"moved": event["moved"], "transferred": event["transferred"],
                    "deleted": event["deleted"], "drain_s": drain_s, "rounds": rounds,
                    "seconds": time.perf_counter() - t0, "feasible_home_first": feasible,
                    "overhead": failed.replication_overhead(fsz)}


def phase_executor(T, TD, executor, faults, backends, streaming, rw, counters, case,
                   main_schemes: dict, dev) -> dict:
    """The executor on the main drive's schemes: every (policy, router)
    case on the kernel and the torch backend, all servers alive and after
    server 0 fails (drain, then ``repair_paths``); reports, counters and
    failed queries must be equal."""
    t0 = time.perf_counter()
    snb, ps, shard, f = case
    fsz = f.astype(np.float64)
    cases = {}
    per_call = {}
    summaries = {}
    repairs = {}
    parts = {}
    launches = {"routed_walk": 0, "scored_walk": 0}
    for t in (1, 2):
        base = main_schemes[t]
        # the main drive again, keeping its resharding map (the same scheme)
        tg = time.perf_counter()
        tracked, st = T.replicate_workload(ps, shard, 6, t, f=f, policy="nearest_copy",
                                           track_rm=True)
        greedy_s = time.perf_counter() - tg
        check(np.array_equal(tracked.mask, base.mask),
              f"executor t={t}: the greedy with track_rm=True gave another scheme")
        failed, repair = fail_and_repair(T, TD, faults, base, st.rm, ps, t, fsz)
        check(repair["feasible_home_first"] and not any(r["failed_paths"]
                                                        for r in repair["rounds"]),
              f"executor t={t}: scheme not feasible after the fail event and repair_paths "
              f"({repair})")
        check(np.array_equal(T.path_latencies(ps, failed, backend="kernel"),
                             T.path_latencies(ps, failed, backend="torch")),
              f"executor t={t}: home-first latencies of the repaired scheme differ")
        repair.update(rm_entries=len(st.rm), greedy_track_rm_s=greedy_s,
                      feasible_nearest_copy=T.is_latency_feasible(ps, failed, t,
                                                                  policy="nearest_copy"))
        repairs[f"t={t}"] = repair
        print(f"executor t={t} fail 0 + repair: {repair}", flush=True)
        for live, scheme, dead in (("alive", base, ()), ("fail0", failed, (0,))):
            for policy in EXEC_POLICIES:
                for router, hedge in EXEC_ROUTES:
                    key = f"t={t}/{live}/{policy}/{router or 'home'}{'+hedge' if hedge else ''}"
                    zero_counts(counters)
                    k_rep, k_cnt, k_s = execute_once(TD, scheme, ps, dead, policy, router, hedge,
                                                     "kernel")
                    got = {"routed_walk": rw.LAUNCHES, "scored_walk": rw.SCORED_LAUNCHES}
                    t_rep, t_cnt, t_s = execute_once(TD, scheme, ps, dead, policy, router, hedge,
                                                     "torch")
                    check(reports_equal(k_rep, t_rep) and k_cnt == t_cnt,
                          f"executor {key}: kernel and torch reports differ")
                    walk = "scored_walk" if policy == "nearest_copy_dp" else "routed_walk"
                    check(got[walk] > 0, f"executor {key}: {walk} not launched")
                    for name in launches:
                        launches[name] += got[name]
                    per_call[key] = got
                    cases[key] = {"kernel_s": k_s, "torch_s": t_s, "failed": k_rep.n_failed,
                                  "p99_us": k_rep.p99_us}
                    if router is None and live == "alive":
                        summaries[f"t={t}/{policy}"] = k_rep.summary()
        parts[f"t={t}"] = {
            pol: executor_parts(TD, executor, backends, streaming, base, ps, pol, dev)
            for pol in ("nearest_copy", "nearest_copy_dp")}
    print(f"executor launches per call: {per_call}", flush=True)
    for key, s in summaries.items():
        print(f"executor summary {key}: {s}", flush=True)
    for key, p in parts.items():
        print(f"executor call by part {key}: {p}", flush=True)
    out = {"phase": "executor", "seconds": time.perf_counter() - t0, "paths": ps.n_paths,
           "queries": ps.n_queries, "n_servers": 6, "cases": cases,
           "kernel_equals_torch": True, "launches": launches, "summaries": summaries,
           "repair": repairs, "call_by_part": parts}
    emit(out)
    return out


def load_script(rel: str):
    """A script of the repository (``examples/``, ``benchmarks/``) as a module."""
    import importlib.util

    path = pathlib.Path(__file__).resolve().parent / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_quickstart(counters) -> dict:
    """``examples/torch_quickstart.py``'s table on the card, kernel backend
    (counters zeroed just before, read just after), then again on the torch
    backend: every t feasible, the same masks, replicas and executor
    summaries."""
    t0 = time.perf_counter()
    qs = load_script("examples/torch_quickstart.py")
    zero_counts(counters)
    tk = time.perf_counter()
    _, workload, rows = qs.table(backend="kernel")
    kernel_s = time.perf_counter() - tk
    launches = read_counts(counters)
    tt = time.perf_counter()
    _, _, plain = qs.table(backend="torch")
    torch_s = time.perf_counter() - tt
    check(launches["path_latency"] > 0 and launches["routed_walk"] > 0,
          f"quickstart: the kernels were not launched ({launches})")
    table = []
    for k, p in zip(rows, plain):
        check(k["feasible"] and p["feasible"], f"quickstart t={k['t']}: not feasible")
        check(k["replicas"] == p["replicas"] and np.array_equal(k["scheme"].mask,
                                                                 p["scheme"].mask),
              f"quickstart t={k['t']}: kernel and torch replicas differ")
        check(k["summary"] == p["summary"], f"quickstart t={k['t']}: executor summaries differ")
        table.append({key: k[key] for key in ("t", "feasible", "overhead", "mean_us", "p99_us",
                                              "replicas")})
        print(f"quickstart t={k['t']}: overhead {k['overhead']:.3f} mean_us "
              f"{k['mean_us']:.1f} p99_us {k['p99_us']:.1f} replicas {k['replicas']}", flush=True)
    out = {"phase": "quickstart", "seconds": time.perf_counter() - t0,
           "paths": workload.n_paths, "queries": workload.n_queries, "table": table,
           "kernel_s": kernel_s, "torch_s": torch_s, "launches": launches,
           "kernel_equals_torch": True}
    emit(out)
    return out


# BENCH_tenants.json's frontier replicas at t_gnn 3 / 2 / 1 / 0 (JAX package)
TENANT_REPLICAS = [2431, 2431, 3270, 4481]


def phase_tenants(T, counters) -> dict:
    """``benchmarks/torch_tenant_frontier.py``'s frontier at scale 1 on the
    kernel backend (counters zeroed just before, read just after) and on
    the torch backend: overhead monotone, 0 failed paths, every scheme
    feasible, kernel masks equal to torch masks, and the home-first
    latencies of every scheme equal on both backends; then its drift part
    (the arbitrating controller over three drift phases) on both backends,
    equal."""
    t0 = time.perf_counter()
    fr = load_script("benchmarks/torch_tenant_frontier.py")
    zero_counts(counters)
    tk = time.perf_counter()
    rows, k_schemes = fr.frontier(backend="kernel")
    kernel_s = time.perf_counter() - tk
    launches = read_counts(counters)
    check(launches["path_latency"] > 0, f"tenants: path_latency not launched ({launches})")
    tt = time.perf_counter()
    plain, t_schemes = fr.frontier(backend="torch")
    torch_s = time.perf_counter() - tt
    sps, gps, _, _ = fr.frontier_workload()
    ps = T.PathSet.concatenate([sps, gps])
    prev = -1.0
    for r, p in zip(rows, plain):
        tg = r["t_gnn"]
        check(r["failed_paths"] == 0 and r["feasible"], f"tenants t_gnn={tg}: failed or infeasible")
        check(r["overhead"] >= prev - 1e-9, f"tenants t_gnn={tg}: overhead not monotone")
        prev = r["overhead"]
        check(np.array_equal(k_schemes[tg].mask, t_schemes[tg].mask),
              f"tenants t_gnn={tg}: kernel and torch masks differ")
        check(np.array_equal(T.path_latencies(ps, k_schemes[tg], backend="kernel"),
                             T.path_latencies(ps, k_schemes[tg], backend="torch")),
              f"tenants t_gnn={tg}: kernel and torch latencies differ")
        print(f"tenants t_gnn={tg}: replicas {r['replicas']} overhead {r['overhead']:.4f} "
              f"failed {r['failed_paths']}", flush=True)
    replicas = [r["replicas"] for r in rows]
    matches = replicas == TENANT_REPLICAS
    print(f"tenants: replicas equal BENCH_tenants.json's {TENANT_REPLICAS}: {matches}",
          flush=True)
    # the drift part: the arbitrating controller over three drift phases,
    # kernel (counters zeroed just before, read just after) against torch
    zero_counts(counters)
    td = time.perf_counter()
    drift = fr.drift(backend="kernel")
    drift_kernel_s = time.perf_counter() - td
    drift_launches = {k: v for k, v in read_counts(counters).items() if v}
    td = time.perf_counter()
    check(drift == fr.drift(backend="torch"), "tenants drift: kernel and torch differ")
    drift_torch_s = time.perf_counter() - td
    check(drift_launches.get("path_latency", 0) > 0 and drift_launches.get("routed_walk", 0) > 0,
          f"tenants drift: the walks were not launched ({drift_launches})")
    for row in drift["per_tenant_p99"]:
        print(f"tenants drift {row['scheme']}: snb p99 {row['snb']['p99_us']} gnn p99 "
              f"{row['gnn']['p99_us']} us", flush=True)
    out = {"phase": "tenants", "seconds": time.perf_counter() - t0, "frontier": rows,
           "kernel_s": kernel_s, "torch_s": torch_s, "launches": launches,
           "kernel_equals_torch": True, "replicas_match_bench_tenants": matches,
           "drift": drift, "drift_kernel_s": drift_kernel_s, "drift_torch_s": drift_torch_s,
           "drift_launches": drift_launches}
    emit(out)
    return out


PLANE_POLICIES = ("home_first", "nearest_copy", "queue_aware", "nearest_copy_dp")
STREAM_CHUNKS = 8
PLANE_COUNTERS = ("path_latency", "routed_walk", "scored_walk", "fused_update")


def plane_policy(engine_mod, name):
    return engine_mod.nearest_copy_dp(2) if name == "nearest_copy_dp" else name


def greedy_counts(st) -> dict:
    return {k: getattr(st, k) for k in ("replicas", "failed_paths", "fallback_paths",
                                        "routed_skips", "routed_violations", "paths_processed",
                                        "total_cost", "resilient_violations",
                                        "resilience_rounds", "resilience_orphans")}


def planes_incremental(T, engine_mod, counters, scheme, ps, dev) -> dict:
    """The dirty-set cache on the main drive's engine: 1,000 seeded adds,
    500 removes, then a mixed batch; after each step, under every policy,
    the incremental latencies on ``kernel`` against a full evaluation and
    the torch backend (a second engine on the card fed the same deltas),
    bit for bit."""
    n, S = scheme.mask.shape
    kern = engine_mod.LatencyEngine(T.ReplicationScheme(scheme.mask.copy(), scheme.shard.copy()),
                                    device=dev)
    plain = engine_mod.LatencyEngine(T.ReplicationScheme(scheme.mask.copy(),
                                                         scheme.shard.copy()),
                                     backend="torch", device=dev)
    rng = np.random.default_rng(20)
    load = rng.random(S).astype(np.float32)
    pols = {name: plane_policy(engine_mod, name) for name in PLANE_POLICIES}
    loads = {name: load if name == "queue_aware" else None for name in PLANE_POLICIES}
    seed = {}
    for name, pol in pols.items():
        t0 = time.perf_counter()
        kern.path_latencies(ps, policy=pol, load=loads[name], incremental=True)
        seed[name] = time.perf_counter() - t0
    add_o = rng.integers(0, n, 1000)
    add_s = rng.integers(0, S, 1000)
    # removes: 500 of the replicas the main drive placed (never an original)
    rep_o, rep_s = np.nonzero(scheme.mask)
    rep = rep_s != scheme.shard[rep_o]
    pick = rng.choice(np.nonzero(rep)[0], 500, replace=False)
    rm_o, rm_s = rep_o[pick], rep_s[pick]
    mix = rng.choice(np.nonzero(rep)[0], 200, replace=False)
    steps = [("add", [("add", add_o, add_s)]),
             ("remove", [("remove", rm_o, rm_s)]),
             ("mixed", [("add", rng.integers(0, n, 300), rng.integers(0, S, 300)),
                        ("remove", rep_o[mix], rep_s[mix])])]
    out = {"seed_s": seed, "steps": {}}
    for step, ops in steps:
        changed = []
        for op, o, s in ops:
            for eng in (kern, plain):
                (eng.add_replicas if op == "add" else eng.remove_replicas)(o, s)
            changed.append(o)
        cache = kern.incremental.caches[id(ps)]
        dirty = int(len(cache.index.dirty_paths(np.concatenate(changed))))
        rows = {}
        for name, pol in pols.items():
            with engine_mod.TRANSFER.scope() as tr:
                before = read_counts(counters)  # the part's counts run on
                t0 = time.perf_counter()
                inc = kern.path_latencies(ps, policy=pol, load=loads[name], incremental=True)
                inc_s = time.perf_counter() - t0
                launches = {k: v - before[k] for k, v in read_counts(counters).items()
                            if k in PLANE_COUNTERS and v > before[k]}
                gathered = tr.gathered_bytes
            t0 = time.perf_counter()
            full = kern.path_latencies(ps, policy=pol, load=loads[name])
            full_s = time.perf_counter() - t0
            ref = plain.path_latencies(ps, policy=pol, load=loads[name])
            check(np.array_equal(inc, full) and np.array_equal(inc, ref),
                  f"planes incremental {step}/{name}: incremental, full and torch differ")
            rows[name] = {"dirty_rows": dirty, "gathered_bytes": gathered,
                          "launches": launches, "incremental_s": inc_s, "full_s": full_s}
            print(f"planes incremental {step} {name}: dirty rows {dirty} gathered_bytes "
                  f"{gathered} launches {launches} incremental_s {inc_s} full_s {full_s}",
                  flush=True)
        out["steps"][step] = rows
    return out


def planes_delta(T, TS, engine_mod, snb, shard, f, dev) -> dict:
    """``snb_drift`` on the scale-10 graph: phase 0 from scratch, phases 1
    and 2 as ``replicate_delta`` on the engine, separate and fused, kernel
    against torch (masks, additions, stats), each phase's workload feasible
    under ``nearest_copy`` once its delta has run (the union of the phases
    need not be: the receding-horizon walk is not monotone under later
    additions, and the JAX package leaves one union query over budget on
    the scale-1 drift too; the count is printed); then
    the aligned-batch identity (delta = from-scratch over the concatenated
    paths) on the same paths."""
    t0 = time.perf_counter()
    phases = TS.snb_drift(snb, n_phases=3, queries_per_phase=2000, seed=0)
    deltas = list(TS.drift_stream(phases))
    union = T.PathSet.concatenate([p.pathset for p in phases])
    drift_s = time.perf_counter() - t0
    out = {"drift_s": drift_s, "phase_paths": [d.pathset.n_paths for d in deltas],
           "added_paths": [d.added.n_paths for d in deltas], "runs": {}}
    for fused in (False, True):
        res = {}
        # fused runs price with unit sizes: the class kernel sums each
        # candidate's cost in its own order, so with non-integer sizes a
        # near-tie can resolve differently from the torch batches (ROADMAP
        # trap c); with unit sizes every cost is exact
        fd = None if fused else f
        for backend in (None, "torch"):  # None: the device's kernel backend
            ts = time.perf_counter()
            # no prune of phase 0 (as benchmarks/torch_provisioning_policies.py):
            # a pruned scheme is tight, and the receding-horizon walk is not
            # monotone under the deltas' additions
            scheme, st0, eng = T.replicate_workload(
                deltas[0].pathset, shard, 6, 1, f=fd, policy="nearest_copy", fused=fused,
                policy_prune=False, return_engine=True, policy_backend=backend, device=dev)
            if backend == "torch":
                eng = engine_mod.LatencyEngine(scheme, backend="torch", device=dev)
            adds, stats, secs = [], [], []
            feasible = eng.is_feasible(deltas[0].pathset, 1, policy="nearest_copy")
            for d in deltas[1:]:
                td = time.perf_counter()
                st, add = T.replicate_delta(d.added, eng, 1, f=fd, policy="nearest_copy",
                                            fused=fused, policy_backend=backend)
                secs.append(time.perf_counter() - td)
                adds.append(add)
                stats.append(greedy_counts(st))
                feasible &= eng.is_feasible(d.pathset, 1, policy="nearest_copy")
            union_viol = int((eng.query_slack(union, 1, policy="nearest_copy") < 0).sum())
            res[backend] = (eng.host_mask(), adds, stats, feasible, secs,
                            time.perf_counter() - ts, union_viol)
        k, p = res[None], res["torch"]
        check(np.array_equal(k[0], p[0]), f"planes delta fused={fused}: kernel and torch masks")
        check(all(np.array_equal(a, b) for x, y in zip(k[1], p[1]) for a, b in zip(x, y)),
              f"planes delta fused={fused}: kernel and torch additions differ")
        check(k[2] == p[2], f"planes delta fused={fused}: kernel and torch stats differ")
        check(k[3] and p[3], f"planes delta fused={fused}: a phase not feasible after its delta")
        check(k[6] == p[6], f"planes delta fused={fused}: union violations differ")
        key = "fused" if fused else "separate"
        out["runs"][key] = {"additions": [len(a[0]) for a in k[1]], "stats": k[2],
                            "delta_s": k[4], "sequence_s": k[5], "torch_sequence_s": p[5],
                            "union_violating_queries": k[6]}
        print(f"planes delta {key}: additions {out['runs'][key]['additions']} delta_s {k[4]} "
              f"phases feasible, union violating queries {k[6]} of {union.n_queries}, "
              "kernel=torch", flush=True)
    # aligned batches: phase 0's paths cut to a multiple of 256, then the
    # phase-1 additions as a delta, against one run over both
    bs = 256
    a = deltas[0].pathset
    a = a.select(np.arange(a.n_paths - a.n_paths % bs))
    b = deltas[1].added
    ab = T.PathSet.concatenate([a, b])
    for fused in (False, True):
        kw = dict(f=f, prune=False, batch_size=bs, fused=fused, device=dev)
        _, _, eng = T.replicate_workload(a, shard, 6, 1, return_engine=True, **kw)
        T.replicate_delta(b, eng, 1, f=f, prune=False, batch_size=bs, fused=fused)
        full, _ = T.replicate_workload(ab, shard, 6, 1, **kw)
        check(np.array_equal(eng.host_mask(), full.mask),
              f"planes aligned delta fused={fused}: delta differs from the from-scratch run")
    out["aligned"] = {"rows_a": a.n_paths, "rows_b": b.n_paths, "delta_equals_scratch": True}
    print(f"planes aligned delta: {a.n_paths} + {b.n_paths} rows, delta = from-scratch "
          "(separate and fused)", flush=True)
    return out


def planes_stream(T, engine_mod, ps, shard, f, dev) -> dict:
    """``replicate_stream`` over a PathStream of the scale-10 paths in 8
    chunks against 8 chunked ``replicate_delta`` calls (fused, t = 1)."""
    step = -(-ps.n_paths // STREAM_CHUNKS)
    spans = [(i, min(i + step, ps.n_paths)) for i in range(0, ps.n_paths, step)]

    def gen():
        for lo, hi in spans:
            yield ps.select(np.arange(lo, hi))

    eng = engine_mod.LatencyEngine(T.ReplicationScheme.from_sharding(shard, 6), device=dev)
    t0 = time.perf_counter()
    for c in gen():
        T.replicate_delta(c, eng, 1, f=f, fused=True)
    chunked_s = time.perf_counter() - t0
    stream = engine_mod.PathStream(gen())
    t0 = time.perf_counter()
    scheme, st = T.replicate_stream(stream, shard, 6, t=1, f=f, fused=True, device=dev)
    stream_s = time.perf_counter() - t0
    check(np.array_equal(scheme.mask, eng.host_mask()),
          "planes stream: replicate_stream differs from the chunked deltas")
    check(st.peak_resident_paths <= step and stream.stats.chunks == len(spans),
          f"planes stream: {st.peak_resident_paths} paths resident, chunk {step}")
    out = {"chunks": len(spans), "chunk_paths": step, "peak_resident_paths":
           st.peak_resident_paths, "ingest_overlap_s": st.ingest_overlap_s,
           "stream_s": stream_s, "chunked_deltas_s": chunked_s, "replicas": st.replicas}
    print(f"planes stream: {len(spans)} chunks, peak resident {st.peak_resident_paths}, "
          f"overlap_s {st.ingest_overlap_s} stream_s {stream_s} chunked_s {chunked_s}",
          flush=True)
    return out


def planes_resilience(T, engine_mod, ps, shard, f, dev) -> dict:
    """``replicate_workload(resilience=1)`` at t = 1 under home_first and
    nearest_copy (sizes ``f``, separate UPDATE), and under nearest_copy with
    ``fused=True`` (unit sizes, so the masked repair's class launches are
    exact against torch): kernel against torch, 0 violations,
    resilient-feasible on the card."""
    out = {}
    for key, pol, fused, fd in (("home_first", "home_first", False, f),
                                ("nearest_copy", "nearest_copy", False, f),
                                ("nearest_copy_fused", "nearest_copy", True, None)):
        res = {}
        for backend in (None, "torch"):  # None: the device's kernel backend
            t0 = time.perf_counter()
            scheme, st = T.replicate_workload(ps, shard, 6, 1, f=fd, policy=pol, resilience=1,
                                              fused=fused, policy_backend=backend, device=dev)
            res[backend] = (scheme, st, time.perf_counter() - t0)
        (ks, kst, k_s), (tsch, tst, t_s) = res[None], res["torch"]
        check(np.array_equal(ks.mask, tsch.mask), f"planes resilience {key}: kernel != torch")
        check(greedy_counts(kst) == greedy_counts(tst),
              f"planes resilience {key}: kernel and torch stats differ")
        check(kst.resilient_violations == 0, f"planes resilience {key}: violations remain")
        eng = engine_mod.LatencyEngine(ks, device=dev)
        tf = time.perf_counter()
        ok = eng.is_resilient_feasible(ps, 1, 1, policy=pol)
        check_s = time.perf_counter() - tf
        check(ok, f"planes resilience {key}: not resilient-feasible on the card")
        out[key] = {"rounds": kst.resilience_rounds, "orphans": kst.resilience_orphans,
                    "replicas": kst.replicas,
                    "overhead": ks.replication_overhead(f.astype(np.float64)),
                    "stage_s": kst.stage_s, "seconds": k_s, "torch_seconds": t_s,
                    "resilient_feasible_check_s": check_s}
        print(f"planes resilience {key}: rounds {kst.resilience_rounds} orphans "
              f"{kst.resilience_orphans} replicas {kst.replicas} overhead "
              f"{out[key]['overhead']} case walks {kst.stage_s.get('resilience_eval')} s "
              f"masked UPDATE {kst.stage_s.get('resilience_repair')} s", flush=True)
    return out


def phase_planes(T, TS, engine_mod, counters, case, dev) -> dict:
    """The engine planes on the main cell (SNB scale 10, 6 servers, t = 1,
    ``nearest_copy``, the drive with ``return_engine=True``): incremental,
    delta, stream, resilience, then the SNB provisioning figures of
    ``benchmarks/torch_provisioning_policies.py`` with their flag.  The
    counters are zeroed just before and read just after."""
    t0 = time.perf_counter()
    snb, ps, shard, f = case
    zero_counts(counters)
    scheme, st, _ = T.replicate_workload(ps, shard, 6, 1, f=f, policy="nearest_copy",
                                         return_engine=True, device=dev)
    drive = read_counts(counters)
    parts, launches = {}, {}
    for name, fn in (
        ("incremental", lambda: planes_incremental(T, engine_mod, counters, scheme, ps, dev)),
        ("delta", lambda: planes_delta(T, TS, engine_mod, snb, shard, f, dev)),
        ("stream", lambda: planes_stream(T, engine_mod, ps, shard, f, dev)),
        ("resilience", lambda: planes_resilience(T, engine_mod, ps, shard, f, dev)),
    ):
        tp = time.perf_counter()
        zero_counts(counters)
        parts[name] = fn()
        counts = read_counts(counters)
        launches[name] = {k: counts[k] for k in PLANE_COUNTERS}
        parts[name]["seconds"] = time.perf_counter() - tp
        check(sum(launches[name].values()) > 0, f"planes {name}: no kernel launched")
    check(launches["resilience"]["path_latency"] > 0 and launches["resilience"]["routed_walk"] > 0,
          f"planes resilience: case walks not launched ({launches['resilience']})")
    check(launches["delta"]["fused_update"] > 0, "planes delta: fused_update not launched")
    tb = time.perf_counter()
    prov = load_script("benchmarks/torch_provisioning_policies.py").snb_row(device=dev)
    print(f"planes provisioning snb: hf shipped {prov['hf']['shipped_bytes']} resident "
          f"{prov['hf']['resident_bytes']}; policy shipped {prov['policy']['shipped_bytes']} "
          f"resident {prov['policy']['resident_bytes']}; equals BENCH_provisioning.json: "
          f"{prov['matches_bench_provisioning']}", flush=True)
    out = {"phase": "planes", "seconds": time.perf_counter() - t0, "paths": ps.n_paths,
           "drive_replicas": st.replicas, "drive_launches": drive, "launches": launches,
           **parts, "provisioning_snb": prov, "provisioning_s": time.perf_counter() - tb}
    emit(out)
    return out


# the mesh phase's drives of the main cell: (policy, t)
MESH_DRIVES = (("nearest_copy", 1), ("nearest_copy", 2), ("home_first", 1),
               ("nearest_copy_dp", 1))


def provisioning_meshes(S, dev) -> dict:
    """Every visible card when there are several; else 4 shards on the one
    card, and a 1-shard mesh."""
    if torch.cuda.device_count() > 1:
        return {f"{torch.cuda.device_count()} cards": S.provisioning_mesh()}
    return {"4 shards on one card": S.ProvisioningMesh((dev,) * 4),
            "1 shard": S.provisioning_mesh(1, device=dev)}


@contextlib.contextmanager
def watch_mesh(greedy):
    """While the block runs: count greedy's launching ``fused_update`` rounds
    (one per shard and batch on a mesh) and ``fused_update_class`` calls,
    and keep every mesh drive built, to read its replicas."""
    seen = {"rounds": 0, "class_calls": 0, "drives": []}
    orig = (greedy.fused_update, greedy.fused_update_class, greedy._MeshDrive)

    def rnd(words, objects, *args, **kwargs):
        if objects.is_cuda and objects.shape[0]:
            seen["rounds"] += 1
        return orig[0](words, objects, *args, **kwargs)

    def cls(words, objects, *args, **kwargs):
        if objects.shape[0]:
            seen["class_calls"] += 1
        return orig[1](words, objects, *args, **kwargs)

    class Kept(orig[2]):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen["drives"].append(self)

    greedy.fused_update, greedy.fused_update_class, greedy._MeshDrive = rnd, cls, Kept
    try:
        yield seen
    finally:
        greedy.fused_update, greedy.fused_update_class, greedy._MeshDrive = orig


def replicas_equal(drives) -> bool:
    """Every shard's replica equals the first (the sacrificial last row,
    which takes each shard's masked-out writes, aside)."""
    return all(torch.equal(d.words(0)[:-1].cpu(), d.words(s)[:-1].cpu())
               for d in drives for s in range(d.mesh.size))


def mesh_drive(T, S, greedy, counters, run, mesh) -> dict:
    """``run(mesh)`` with the launch counters zeroed just before and read
    just after, the exchange counters and seconds: on several shards
    ``fused_update`` must launch once per shard and batch and never as a
    class launch, on one shard as the single-card class launch only; every
    replica must be equal after it."""
    zero_counts(counters)
    S.EXCHANGE.reset()
    with watch_mesh(greedy) as seen:
        ts = time.perf_counter()
        res = run(mesh)
        secs = time.perf_counter() - ts
    launches = read_counts(counters)
    check(launches["fused_update"] > 0, f"mesh {mesh.devices}: fused_update not launched")
    if mesh.size == 1:
        check(launches["fused_update"] == seen["class_calls"] and seen["rounds"] == 0,
              f"mesh: {launches['fused_update']} fused_update launches for "
              f"{seen['class_calls']} class calls and {seen['rounds']} rounds (expected "
              "the class launch only on one shard)")
    else:
        check(launches["fused_update"] == seen["rounds"] and seen["class_calls"] == 0,
              f"mesh: {launches['fused_update']} fused_update launches for {seen['rounds']} "
              f"rounds and {seen['class_calls']} class calls (expected one round per "
              "shard and batch, no class launch)")
    # the last drive's: an earlier call's other replicas are left behind
    # once a later call (a stream's next chunk) writes the shared first one
    check(seen["drives"] and replicas_equal(seen["drives"][-1:]), "mesh: replicas differ")
    return {"res": res, "seconds": secs, "launches": launches["fused_update"],
            "exchange": S.EXCHANGE.snapshot(), "drives": len(seen["drives"])}


def same_counts(a: dict, b: dict, n_terms: int) -> bool:
    """``greedy_counts`` equal, ``total_cost`` within the float32 rounding
    of two summation orders of at most ``n_terms`` non-negative costs: the
    class launch adds its rows one by one, a mesh its shards' partials, and
    each float32 sum of n terms is within n * 2^-24 of the exact sum
    relative to it.  Unit sizes make every sum exact; the mesh phase's
    delta compares them exactly."""
    bound = 2 * n_terms * 2.0 ** -24 * max(abs(a["total_cost"]), abs(b["total_cost"]))
    return ({k: v for k, v in a.items() if k != "total_cost"}
            == {k: v for k, v in b.items() if k != "total_cost"}
            and abs(a["total_cost"] - b["total_cost"]) <= bound)


def mesh_delta_stream(T, TS, engine_mod, S, greedy, counters, case, meshes: dict, dev) -> dict:
    """The planes phase's fused delta (phase 1's added paths of
    ``snb_drift`` at scale 10 on the engine of phase 0, unit sizes,
    ``nearest_copy``) and its 8-chunk ``replicate_stream`` (f, t = 1) on
    each mesh, equal to their single-device runs (masks, additions and
    stats)."""
    snb, ps, shard, f = case
    deltas = list(TS.drift_stream(TS.snb_drift(snb, n_phases=3, queries_per_phase=2000,
                                               seed=0)))

    def engine():
        return T.replicate_workload(deltas[0].pathset, shard, 6, 1, policy="nearest_copy",
                                    fused=True, policy_prune=False, return_engine=True,
                                    device=dev)[2]

    def delta(mesh, eng):
        ts = time.perf_counter()
        st, add = T.replicate_delta(deltas[1].added, eng, 1, policy="nearest_copy",
                                    fused=True, mesh=mesh)
        return eng.host_mask(), add, greedy_counts(st), time.perf_counter() - ts, st.stage_s

    step = -(-ps.n_paths // STREAM_CHUNKS)

    def stream(mesh):
        chunks = (ps.select(np.arange(lo, min(lo + step, ps.n_paths)))
                  for lo in range(0, ps.n_paths, step))
        scheme, st = T.replicate_stream(engine_mod.PathStream(chunks), shard, 6, t=1, f=f,
                                        fused=True, mesh=mesh, device=dev)
        return scheme.mask, greedy_counts(st), st.stage_s

    single = {"delta": delta(None, engine()), "stream": stream(None)}
    out = {"delta_paths": deltas[1].added.n_paths, "stream_chunks": STREAM_CHUNKS,
           "single": {"delta_s": single["delta"][3], "delta_stage_s": single["delta"][4],
                      "stream_stage_s": single["stream"][2]}}
    for name, mesh in meshes.items():
        d = mesh_drive(T, S, greedy, counters, lambda m, eng=engine(): delta(m, eng), mesh)
        want = single["delta"]
        check(np.array_equal(d["res"][0], want[0]), f"mesh {name} delta: masks differ")
        check(all(np.array_equal(a, b) for a, b in zip(d["res"][1], want[1])),
              f"mesh {name} delta: additions differ")
        check(d["res"][2] == want[2], f"mesh {name} delta: stats differ")
        s = mesh_drive(T, S, greedy, counters, stream, mesh)
        check(np.array_equal(s["res"][0], single["stream"][0]),
              f"mesh {name} stream: masks differ")
        check(same_counts(s["res"][1], single["stream"][1], ps.n_paths + s["launches"]),
              f"mesh {name} stream: stats differ ({s['res'][1]} against one card's "
              f"{single['stream'][1]})")
        out[name] = {"delta_s": d["res"][3], "delta_stage_s": d["res"][4],
                     "delta_launches": d["launches"], "delta_exchange": d["exchange"],
                     "stream_s": s["seconds"], "stream_stage_s": s["res"][2],
                     "stream_launches": s["launches"], "stream_exchange": s["exchange"],
                     "stream_drives": s["drives"], "additions": len(want[1][0])}
        print(f"mesh {name}: delta ({len(want[1][0])} additions) and {STREAM_CHUNKS}-chunk "
              "stream equal to one card", flush=True)
    return out


def phase_mesh(T, TS, engine_mod, S, greedy, counters, case, fused_schemes: dict,
               dev) -> dict:
    """The path-sharded fused greedy on the main cell (SNB scale 10, 6 hash
    servers, f = object sizes, kernel backend): ``replicate_workload(fused
    =True, mesh=)`` under nearest_copy at t = 1 and 2 and home_first and
    nearest_copy_dp at t = 1, on each mesh of :func:`provisioning_meshes`,
    counters zeroed just before each drive and read just after;
    ``fused_update`` launched once per shard and batch on several shards
    and as the class launch on one; masks, integer stats and total cost
    (within float32 rounding) equal to a single-device drive at the rounded batch size (and to
    the fused phase's drive where that is 256 rows), every replica equal;
    then, untimed with ``track_rm``, each drive's resharding map equal to
    one card's and the first mesh's total cost equal to the float64 sum of
    f over its map within its own float32 rounding.  Then one ``replicate_delta``
    and one 8-chunk ``replicate_stream`` on each mesh.  Printed: the
    devices, shards, rounded batch, seconds per stage beside the
    single-device drive's, launches and the bytes exchanged."""
    t0 = time.perf_counter()
    snb, ps, shard, f = case
    meshes = provisioning_meshes(S, dev)
    out = {"phase": "mesh", "cards": torch.cuda.device_count(),
           "cross_card": torch.cuda.device_count() > 1,
           "meshes": {name: {"devices": [str(d) for d in m.devices], "shards": m.size,
                             "batch_size": m.round_batch(256)} for name, m in meshes.items()},
           "runs": {}}
    print(f"mesh: {out['meshes']}", flush=True)
    single = {}
    for name, mesh in meshes.items():
        bs = mesh.round_batch(256)
        for pol, t in MESH_DRIVES:
            if (pol, t, bs) not in single:
                ts = time.perf_counter()
                sc, st = T.replicate_workload(ps, shard, 6, t, f=f, policy=pol, fused=True,
                                              batch_size=bs, device=dev)
                single[pol, t, bs] = (sc, st, time.perf_counter() - ts)
                if bs == 256 and (pol, t) in fused_schemes:
                    check(np.array_equal(sc.mask, fused_schemes[pol, t].mask),
                          f"mesh: single-device {pol} t={t} differs from the fused phase's")
            sc1, st1, secs1 = single[pol, t, bs]
            d = mesh_drive(T, S, greedy, counters, lambda m, pol=pol, t=t: T.replicate_workload(
                ps, shard, 6, t, f=f, policy=pol, fused=True, mesh=m), mesh)
            sc, st = d["res"]
            what = f"mesh {name} {pol} t={t}"
            check(np.array_equal(sc.mask, sc1.mask), f"{what}: masks differ from one card")
            for k in ("replicas", "failed_paths", "routed_skips", "routed_violations",
                      "pruned_replicas", "fallback_paths"):
                check(getattr(st, k) == getattr(st1, k), f"{what}: {k} differs from one card")
            check(same_counts(greedy_counts(st), greedy_counts(st1), ps.n_paths + d["launches"]),
                  f"{what}: stats or total_cost differ from one card ({greedy_counts(st)} "
                  f"against {greedy_counts(st1)})")
            out["runs"][f"{name}/{pol}/t={t}"] = {
                "seconds": d["seconds"], "single_seconds": secs1, "stage_s": st.stage_s,
                "single_stage_s": st1.stage_s, "fused_update_launches": d["launches"],
                "exchange": d["exchange"], "replicas": st.replicas,
                "failed_paths": st.failed_paths, "routed_skips": st.routed_skips,
                "total_cost": st.total_cost, "single_total_cost": st1.total_cost}
            print(f"{what}: {d['seconds']} s (one card {secs1} s), UPDATE "
                  f"{st.stage_s.get('update')} s (one card {st1.stage_s.get('update')} s), "
                  f"{d['launches']} fused_update launches, exchanged {d['exchange']}",
                  flush=True)
    # untimed, with the resharding map (the additions in row order): the
    # map equals one card's, and the first mesh's total cost is held
    # against the float64 sum of f over its map's entries, within the
    # float32 rounding of its own sums: a row's cost over at most L (L + 1)
    # cells, a shard's block of at most a batch, one add per launch (a
    # stat partial dropped or added twice is far outside it)
    name, mesh = next(iter(meshes.items()))
    f64 = np.asarray(f, np.float64)
    L = np.asarray(ps.objects).shape[1]
    out["rm"] = {}
    for pol, t in MESH_DRIVES:
        _, st1 = T.replicate_workload(ps, shard, 6, t, f=f, policy=pol, fused=True,
                                      batch_size=mesh.round_batch(256), track_rm=True,
                                      device=dev)
        zero_counts(counters)
        _, st = T.replicate_workload(ps, shard, 6, t, f=f, policy=pol, fused=True, mesh=mesh,
                                     track_rm=True)
        n_launch = read_counts(counters)["fused_update"]
        what = f"mesh {name} {pol} t={t}"
        check(st.rm == st1.rm, f"{what}: the resharding map differs from one card")
        exact = float(f64[[v for _, v, _ in st.rm]].sum())
        bound = (L * (L + 1) + 256 + n_launch) * 2.0 ** -24 * exact
        check(abs(st.total_cost - exact) <= bound,
              f"{what}: total_cost {st.total_cost} is not the map's {exact} (bound {bound})")
        out["rm"][f"{pol}/t={t}"] = {"entries": len(st.rm), "total_cost": st.total_cost,
                                     "single_total_cost": st1.total_cost, "map_cost": exact,
                                     "bound": bound}
    out["planes"] = mesh_delta_stream(T, TS, engine_mod, S, greedy, counters, case, meshes,
                                      dev)
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


SERVE_RATE_QPS = 20_000.0
SERVE_REROUTE_EVERY = 2_000  # ~10 mid-run rebuilds over the 20,000 arrivals
SERVE_CLIENTS = 64
SERVE_HARNESS_QUERIES = 200
SERVE_HARNESS_SCALE = 5e-4  # real seconds per model µs: 200 queries at 20,000 qps ~ 5 s
SERVE_WALKS = ("routed_walk", "scored_walk")


@contextlib.contextmanager
def serve_parts(simulator, executor, dev):
    """While the block runs, split ``simulate``'s host seconds: the routing
    variants' builds (``_build_variant``), and within them the walks
    (``trace_paths``: the host fail-over map and packing, the uploads, the
    walk's enqueue, the readback, each synchronised); the rest of a run is
    its event loop.  Every walk's arguments and outputs are kept, so the
    same walks can be re-run on the torch backend afterwards."""
    parts = {"build_s": 0.0, "trace_s": 0.0, "pack_s": 0.0, "upload_s": 0.0,
             "launch_s": 0.0, "readback_s": 0.0, "walks": 0, "walk_rows": 0}
    calls = []
    orig = (simulator._build_variant, simulator.trace_paths, executor.walk_inputs,
            executor.to_device, executor.access_trace, executor.to_host)

    def clocked(key, fn):
        def wrapped(*args, **kwargs):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            parts[key] += time.perf_counter() - t0
            return res
        return wrapped

    def walk(pathset, scheme, alive, start=None, policy=None, load=None, device=None,
             backend=None):
        t0 = time.perf_counter()
        out = orig[1](pathset, scheme, alive, start, policy, load, device, backend)
        parts["trace_s"] += time.perf_counter() - t0
        # chaos flips ``alive`` in place: keep the walk's own copy
        calls.append((pathset, scheme, alive.copy(), start, policy, load, out))
        if pathset.n_paths:
            parts["walks"] += 1
            parts["walk_rows"] += int(pathset.n_paths)
        return out

    simulator._build_variant = clocked("build_s", orig[0])
    simulator.trace_paths = walk
    executor.walk_inputs = clocked("pack_s", orig[2])
    executor.to_device = clocked("upload_s", orig[3])
    executor.access_trace = clocked("launch_s", orig[4])
    executor.to_host = clocked("readback_s", orig[5])
    try:
        yield parts, calls
    finally:
        (simulator._build_variant, simulator.trace_paths, executor.walk_inputs,
         executor.to_device, executor.access_trace, executor.to_host) = orig


def retrace_on_torch(executor, calls, dev) -> bool:
    """Every recorded walk, re-run on the torch backend: the same servers and
    locality, bit for bit."""
    for ps, scheme, alive, start, policy, load, (srv, loc) in calls:
        s2, l2 = executor.trace_paths(ps, scheme, alive, start, policy, load, dev, "torch")
        if not (np.array_equal(srv, s2) and np.array_equal(loc, l2)):
            return False
    return True


def sim_reports_equal(a, b) -> bool:
    """Every field of two ``SimReport``s (arrays bit for bit, the batch
    stats by their summary) and both ``summary()``s."""
    for fld in dataclasses.fields(a):
        x, y = getattr(a, fld.name), getattr(b, fld.name)
        if fld.name == "batch_stats":
            same = (x is None and y is None) or (x is not None and y is not None
                                                 and x.summary() == y.summary())
        elif isinstance(x, np.ndarray):
            same = isinstance(y, np.ndarray) and x.dtype == y.dtype and np.array_equal(x, y)
        else:
            same = x == y
        if not same:
            return False
    return a.summary() == b.summary()


def adapt_reports_equal(a, b) -> bool:
    """Two ``AdaptationReport``s (or Nones), every field but ``runtime_s``."""
    if a is None or b is None:
        return a is None and b is None
    for fld in dataclasses.fields(a):
        if fld.name == "runtime_s":
            continue
        x, y = getattr(a, fld.name), getattr(b, fld.name)
        if fld.name == "additions":
            same = all(np.array_equal(u, v) for u, v in zip(x, y))
        else:
            same = x == y
        if not same:
            return False
    return True


def serve_case_kwargs(TD, TS, T, scheme, n: int) -> dict:
    """name -> (a function giving a fresh run's keyword arguments, whether
    the whole report is held against the torch backend's)."""
    mid = 0.5 * n / SERVE_RATE_QPS * 1e6  # the arrivals' midpoint, µs
    return {
        "home_first": (lambda: dict(policy="home_first"), True),
        "nearest_copy": (lambda: dict(policy="nearest_copy"), False),
        "nearest_copy_dp": (lambda: dict(policy="nearest_copy_dp"), False),
        "replica_lb": (lambda: dict(policy="nearest_copy",
                                    router=TD.Router(scheme, "replica_lb")), False),
        "hedged": (lambda: dict(policy="nearest_copy", router=TD.Router(scheme, "hedged")),
                   False),
        "queue_aware_reroute": (lambda: dict(policy="queue_aware",
                                             reroute_every=SERVE_REROUTE_EVERY), True),
        "batched_admission_hedge": (lambda: dict(
            policy="nearest_copy", slo=T.SLOSpec.uniform(1, n), batching=TS.BatchingConfig(),
            admission=TS.AdmissionConfig(stretch=4.0), hedge=TS.HedgePolicy()), False),
        "chaos": (lambda: dict(policy="nearest_copy", chaos=[
            TD.ChaosEvent(mid, "kill", 0), TD.ChaosEvent(1.5 * mid, "revive", 0)]), True),
        "hop_feedback_closed": (lambda: dict(policy="queue_aware", hop_feedback=True,
                                             clients=SERVE_CLIENTS), False),
    }


def serve_simulate(T, TD, TS, simulator, executor, counters, scheme, ps, dev) -> dict:
    """``simulate`` on the main t = 1 ``nearest_copy`` scheme, open loop at
    20,000 qps (the hop-feedback case closed loop), one case per routing
    policy, router and plane: on the kernel backend with the launches
    counted (zeroed just before, read just after) and the host seconds
    split; every walk re-run on torch and equal; three cases' whole
    reports held against the torch backend's."""
    n = ps.n_queries
    out = {}
    for name, (kwargs, whole) in serve_case_kwargs(TD, TS, T, scheme, n).items():
        cluster = TD.Cluster(scheme)
        with serve_parts(simulator, executor, dev) as (parts, calls):
            zero_counts(counters)
            t0 = time.perf_counter()
            rep = TS.simulate(cluster, ps, rate_qps=SERVE_RATE_QPS, seed=0, device=dev,
                              **kwargs())
            total = time.perf_counter() - t0
            counts = read_counts(counters)
        launches = {k: counts[k] for k in SERVE_WALKS}
        check(sum(launches.values()) == parts["walks"],
              f"serve {name}: {launches} launches for {parts['walks']} walks")
        check((parts["walks"] == 0) == (name == "hop_feedback_closed"),
              f"serve {name}: {parts['walks']} walks")
        check(rep.latency_us.shape == (n,) and np.isfinite(rep.latency_us).all(),
              f"serve {name}: latencies malformed")
        t1 = time.perf_counter()
        check(retrace_on_torch(executor, calls, dev),
              f"serve {name}: a walk differs between kernel and torch")
        retrace_s = time.perf_counter() - t1
        torch_s = None
        if whole:
            t1 = time.perf_counter()
            plain = TS.simulate(TD.Cluster(scheme), ps, rate_qps=SERVE_RATE_QPS, seed=0,
                                device=dev, backend="torch", **kwargs())
            torch_s = time.perf_counter() - t1
            check(sim_reports_equal(rep, plain),
                  f"serve {name}: the kernel and torch SimReports differ")
        s = rep.summary()
        seconds = {"total": total, "trace": parts["trace_s"], "pack": parts["pack_s"],
                   "upload": parts["upload_s"], "launch": parts["launch_s"],
                   "readback": parts["readback_s"],
                   "tree_build": parts["build_s"] - parts["trace_s"],
                   "event_loop": total - parts["build_s"]}
        out[name] = {"p50_us": s["p50_us"], "p99_us": s["p99_us"], "p999_us": s["p999_us"],
                     "achieved_qps": s["achieved_qps"], "max_utilization": s["max_utilization"],
                     "failed_queries": s["failed_queries"],
                     "shed_queries": s.get("admission", {}).get("n_shed", 0),
                     "reroutes": rep.reroutes, "launches": launches, "walks": parts["walks"],
                     "walk_rows": parts["walk_rows"], "seconds": seconds,
                     "retrace_s": retrace_s, "torch_report_equal": whole,
                     "torch_s": torch_s}
        extra = {k: s[k] for k in ("chaos", "hedging", "batching") if k in s}
        out[name].update(extra)
        print(f"serve {name}: p50 {s['p50_us']} p99 {s['p99_us']} p999 {s['p999_us']} us, "
              f"qps {s['achieved_qps']}, max util {s['max_utilization']}, failed "
              f"{s['failed_queries']}, shed {out[name]['shed_queries']}, launches {launches}, "
              f"seconds {seconds}, whole report kernel=torch: {whole}", flush=True)
    return out


def serve_controller(T, TD, TS, engine_mod, counters, snb, shard, f, dev) -> dict:
    """``snb_drift`` at scale 10 (3 phases x 2,000 queries): phase 0 driven
    with ``return_engine=True``, then each phase simulated and observed by an
    ``AdaptiveController`` on that engine (kernel) and by a twin on a torch
    engine: reports (all but ``runtime_s``) and masks equal after every
    step, each phase feasible after its repair; one ``on_liveness_change``
    with server 2 failed, resilient-feasible with 0 violations; then a
    capacity tight enough to evict (a home-first controller on the card),
    after which every window's incremental re-check equals a full
    evaluation and a fresh engine's.  The kernel steps must launch the
    walks (``routed_walk``; ``path_latency`` in the home-first one)."""
    t0 = time.perf_counter()
    phases = TS.snb_drift(snb, n_phases=3, queries_per_phase=2000, seed=0)
    deltas = list(TS.drift_stream(phases))
    # no prune of phase 0, as in the planes phase: a pruned scheme is tight,
    # and the receding-horizon walk is not monotone under later additions
    scheme, _, eng = T.replicate_workload(deltas[0].pathset, shard, 6, 1, f=f,
                                          policy="nearest_copy", policy_prune=False,
                                          return_engine=True, device=dev)
    drive_mask = scheme.mask.copy()
    twin = engine_mod.LatencyEngine(T.ReplicationScheme(scheme.mask.copy(), scheme.shard.copy()),
                                    backend="torch", device=dev)
    sides = {"kernel": eng, "torch": twin}
    clusters = {k: TD.Cluster(e.scheme, f=f) for k, e in sides.items()}
    ctls = {k: TS.AdaptiveController(
        clusters[k], TS.ControllerConfig(t=1, window=2000, min_queries=200,
                                         score_policy="nearest_copy"), f=f, engine=e)
        for k, e in sides.items()}
    steps = []
    for d in deltas:
        got = {}
        for k in ("kernel", "torch"):
            zero_counts(counters)
            ts = time.perf_counter()
            rep = TS.simulate(clusters[k], d.pathset, rate_qps=SERVE_RATE_QPS, seed=d.phase,
                              device=dev, backend=sides[k].backend)
            sim_s = time.perf_counter() - ts
            ts = time.perf_counter()
            act = ctls[k].observe(d.pathset, latency_us=rep.latency_us)
            observe_s = time.perf_counter() - ts
            got[k] = (rep, act, sides[k].scheme.mask.copy(), read_counts(counters), sim_s,
                      observe_s)
        (kr, ka, km, kc, ks, ko), (tr, ta, tm, _, tsim, tobs) = got["kernel"], got["torch"]
        check(sim_reports_equal(kr, tr), f"serve controller phase {d.phase}: SimReports differ")
        check(adapt_reports_equal(ka, ta),
              f"serve controller phase {d.phase}: AdaptationReports differ")
        check(np.array_equal(km, tm), f"serve controller phase {d.phase}: masks differ")
        check(np.array_equal(eng.host_mask(), km),
              f"serve controller phase {d.phase}: engine words and host mask differ")
        feasible = eng.is_feasible(d.pathset, 1, policy="nearest_copy")
        check(feasible, f"serve controller phase {d.phase}: not feasible after its repair")
        row = {"phase": d.phase, "paths": d.pathset.n_paths, "added_paths": d.added.n_paths,
               "p99_us": kr.p99_us, "adapted": ka is not None,
               "launches": {k: v for k, v in kc.items() if v},
               "simulate_s": ks, "observe_s": ko, "torch_simulate_s": tsim,
               "torch_observe_s": tobs}
        if ka is not None:
            row.update(trigger=ka.trigger, paths_repaired=ka.paths_repaired,
                       replicas_added=ka.replicas_added, bytes_added=ka.bytes_added,
                       feasible_after=ka.feasible_after, runtime_s=ka.runtime_s,
                       torch_runtime_s=ta.runtime_s)
        steps.append(row)
        print(f"serve controller phase {d.phase}: {row}", flush=True)
    # a server fails: one liveness repair over the dead set
    live = {}
    for k in ("kernel", "torch"):
        clusters[k].fail_server(2)
        zero_counts(counters)
        ts = time.perf_counter()
        act = ctls[k].on_liveness_change(deltas[-1].pathset)
        live[k] = (act, sides[k].scheme.mask.copy(), read_counts(counters),
                   time.perf_counter() - ts)
        clusters[k].recover_server(2)
    (ka, km, kc, ks), (ta, tm, _, tls) = live["kernel"], live["torch"]
    walked = sum(st["launches"].get("routed_walk", 0) for st in steps)
    check(walked > 0 and kc.get("routed_walk", 0) > 0,
          f"serve controller: routed_walk not launched ({walked}, liveness {kc})")
    check(adapt_reports_equal(ka, ta) and np.array_equal(km, tm),
          "serve controller liveness: kernel and torch differ")
    res = engine_mod.KResilient(k=1, domains=((2,),))
    h = eng.resilient_path_latencies(deltas[-1].pathset, res, policy="nearest_copy")
    hq = np.zeros((h.shape[0], deltas[-1].pathset.n_queries), np.int32)
    for c in range(h.shape[0]):
        np.maximum.at(hq[c], np.asarray(deltas[-1].pathset.query_ids), h[c])
    violations = int((hq > 1).any(axis=0).sum())
    check(ka is not None and ka.feasible_after and violations == 0,
          f"serve controller liveness: {violations} resilient violations")
    liveness = {"replicas_added": ka.replicas_added, "bytes_added": ka.bytes_added,
                "resilient_violations": violations, "seconds": ks, "torch_seconds": tls,
                "launches": {k: v for k, v in kc.items() if v}}
    print(f"serve controller liveness (server 2 failed): {liveness}", flush=True)
    # eviction: cold copies of 4,000 objects no phase touches, on every
    # server, push each one over a capacity of the drive scheme's fullest
    # load plus half those copies' bytes, so a repair evicts; scored
    # home-first, so the re-checks launch path_latency
    used = np.unique(np.concatenate([np.asarray(d.pathset.objects).ravel() for d in deltas]))
    cold = np.random.default_rng(0).choice(
        np.setdiff1d(np.arange(drive_mask.shape[0]), used), 4000, replace=False)
    ev_scheme = T.ReplicationScheme(drive_mask.copy(), scheme.shard.copy())
    cap = float(ev_scheme.storage_per_server(f).max() + 0.5 * f[cold].sum())
    ev_scheme.mask[cold] = True
    ev = TS.AdaptiveController(TD.Cluster(ev_scheme, f=f), TS.ControllerConfig(
        t=1, window=2000, min_queries=200, capacity=cap), f=f, device=dev)
    zero_counts(counters)
    ts = time.perf_counter()
    acts = [ev.observe(d) for d in (deltas[0].pathset, deltas[1].pathset)]
    evict_s = time.perf_counter() - ts
    ev_launches = {k: v for k, v in read_counts(counters).items() if v}
    act = next((a for a in acts if a is not None and a.replicas_evicted), None)
    check(act is not None, "serve controller: nothing evicted")
    check(ev_launches.get("path_latency", 0) > 0,
          f"serve controller eviction: path_latency not launched ({ev_launches})")
    fresh = engine_mod.LatencyEngine(ev_scheme.copy(), backend="torch", device=dev)
    for w in ev._tenants.values():
        for e in w.entries:
            inc = ev.engine.path_latencies(e.pathset, incremental=True)
            full = ev.engine.path_latencies(e.pathset)
            want = fresh.path_latencies(e.pathset)
            check(np.array_equal(e.path_lats, want) and np.array_equal(inc, want)
                  and np.array_equal(full, want),
                  "serve controller eviction: a window's re-check differs from a full one")
    eviction = {"cold_objects": len(cold), "capacity": cap, "step": act.step,
                "replicas_evicted": act.replicas_evicted, "bytes_evicted": act.bytes_evicted,
                "replicas_added": act.replicas_added, "feasible_after": act.feasible_after,
                "seconds": evict_s, "launches": ev_launches, "incremental_equals_full": True}
    print(f"serve controller eviction: {eviction}", flush=True)
    return {"seconds": time.perf_counter() - t0, "steps": steps, "liveness": liveness,
            "eviction": eviction}


def serve_harness(T, TD, TS, scheme, ps, dev) -> dict:
    """``harness_simulate`` on the first 200 queries beside ``simulate`` at
    the same seed: every query completes, the failed flags equal the
    simulator's; the percentiles are printed, not compared (the harness
    runs on a real clock)."""
    sub = ps.select_queries(0, SERVE_HARNESS_QUERIES)
    kw = dict(rate_qps=SERVE_RATE_QPS, seed=0, policy="nearest_copy", device=dev)
    sim = TS.simulate(TD.Cluster(scheme), sub, **kw)
    t0 = time.perf_counter()
    har = TS.harness_simulate(TD.Cluster(scheme), sub, time_scale=SERVE_HARNESS_SCALE, **kw)
    seconds = time.perf_counter() - t0
    check(har.latency_us.shape == (sub.n_queries,) and np.isfinite(har.latency_us).all(),
          "serve harness: a query did not complete")
    check(np.array_equal(har.query_failed, sim.query_failed),
          "serve harness: failed flags differ from the simulator's")
    out = {"queries": sub.n_queries, "time_scale": SERVE_HARNESS_SCALE, "seconds": seconds,
           "harness_p50_us": har.p50_us, "harness_p99_us": har.p99_us,
           "simulate_p50_us": sim.p50_us, "simulate_p99_us": sim.p99_us}
    print(f"serve harness: {out}", flush=True)
    return out


def phase_serve(T, TD, TS, engine_mod, counters, case, scheme, dev) -> dict:
    """The serving stack on the main cell (SNB scale 10, 20,000 queries,
    146,907 paths, 6 servers, the main phase's t = 1 ``nearest_copy``
    scheme): the simulator's cases, the adaptive controller over
    ``snb_drift``, and the asyncio harness."""
    from repro_torch.distsys import executor
    from repro_torch.serve import simulator

    t0 = time.perf_counter()
    snb, ps, shard, f = case
    sims = serve_simulate(T, TD, TS, simulator, executor, counters, scheme, ps, dev)
    sim_s = time.perf_counter() - t0
    ctl = serve_controller(T, TD, TS, engine_mod, counters, snb, shard, f, dev)
    har = serve_harness(T, TD, TS, scheme, ps, dev)
    out = {"phase": "serve", "seconds": time.perf_counter() - t0, "simulate_s": sim_s,
           "paths": ps.n_paths, "queries": ps.n_queries, "rate_qps": SERVE_RATE_QPS,
           "cases": sims, "controller": ctl, "harness": har,
           "launches": {name: {case: c["launches"][name] for case, c in sims.items()}
                        for name in SERVE_WALKS}}
    emit(out)
    return out


# GPU clock cycles (~1 ms) of the sleep kernel that `time_ms(busy_first=True)`
# runs before its start event
SLEEP_CYCLES = 2_000_000


def time_ms(fn, reps: int = 5, setup=None, busy_first: bool = False) -> float:
    """Median time of ``fn`` over ``reps`` runs after one warm-up, between
    CUDA events recorded just before and just after the call; ``setup``
    (untimed) runs before each call.  The card is idle when the start event
    is recorded, so a call whose host enqueue outlasts its kernels is timed
    from the host: this is the "ms" of the kernels line.  With
    ``busy_first`` a sleep kernel runs just before the start event, so the
    host has queued the whole call before the card reaches it, and the time
    is the call's device time from its first kernel to its last."""
    if setup is not None:
        setup()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if busy_first:
            torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def timed(key: str, fn, reps: int = 5, setup=None) -> dict:
    """``{key}_ms`` (the call, :func:`time_ms`) and ``{key}_device_ms`` (its
    device time, ``busy_first``) of ``fn``."""
    return {f"{key}_ms": time_ms(fn, reps, setup),
            f"{key}_device_ms": time_ms(fn, reps, setup, busy_first=True)}


def sweep_scored(rw, backends, objects, lengths, wd, sd, start, W: int, chunk: int) -> dict:
    """The scored walk over row chunks of the sweep's paths (the full
    [P, L, W*32] score plane would not fit): exact against the plain
    version, then kernel, plain and DP-table times summed over chunks.
    The bound counts the routed walk's bytes plus 4 bytes for every holder
    score a remote hop reads."""
    P, L = objects.shape
    out = {"bytes": 0, "score_reads": 0, "chunk_rows": chunk}
    for r in range(0, P, chunk):
        o, ln, st = objects[r : r + chunk], lengths[r : r + chunk], start[r : r + chunk]
        scores = backends._dp_score_tables(o, ln, wd, -1)
        s, loc = rw.scored_walk(o, ln, wd, sd, st, scores)
        ws, wl = rw.scored_walk_plain(o, ln, wd, sd, st, scores)
        check(torch.equal(s, ws) and torch.equal(loc, wl), f"sweep scored_walk rows {r}: kernel vs plain")
        valid = torch.arange(L, device=o.device)[None, :] < ln[:, None]
        remote = valid & ~loc
        holders = backends.unpack_bits(wd[o.clamp_min(0).long()]).sum(dim=-1)
        reads = int(holders[remote].sum())
        sum_len = int(ln.long().sum())
        touched = int(torch.unique(o[valid]).numel())
        out["score_reads"] += reads
        out["bytes"] += (8 * len(o) + 4 * sum_len + (4 * W + 4) * touched
                         + 5 * len(o) * L + 4 * reads)
        for key, ms in {**timed("kernel", lambda: rw.scored_walk(o, ln, wd, sd, st, scores)),
                        **timed("plain", lambda: rw.scored_walk_plain(o, ln, wd, sd, st, scores)),
                        **timed("dp_tables", lambda: backends._dp_score_tables(o, ln, wd, -1)),
                        }.items():
            out[key] = out.get(key, 0.0) + ms
        del scores, holders
    return out


def sweep_fused(pu, backends, engine_mod, routing, combi, T, case, dev,
                rows_list=(256, 65_536)) -> dict:
    """One fused UPDATE round (every row on one snapshot) on the first 256
    and 65,536 (``rows_list``) SNB scale 10 paths at t = 1 against the sharding-only snapshot (the words are restored
    before each timed call), with the routed and the scored gate.  Bound:
    the larger of the bytes over the memory rate and the candidate loop's
    sum_b n_cand(h_b) * L * Hp1 mask operations over the 32-bit rate."""
    _, ps, shard, f = case
    packed = engine_mod.PackedScheme.from_sharding(shard, 6, dev)
    w0 = packed.words
    W = w0.shape[1]
    f_d = torch.from_numpy(f).to(dev)
    rank = backends._load_vector(None, w0)
    out = {}
    for rows in rows_list:
        o = torch.from_numpy(np.asarray(ps.objects[:rows], np.int32)).to(dev)
        ln = torch.from_numpy(np.asarray(ps.lengths[:rows], np.int32)).to(dev)
        B = o.shape[0]
        _, _, h = T.subpath_structure(o, ln, packed.shard)
        H = combi.max_h_within_budget(1, 2048, int(h.max()))
        tab_np, cnt_np = combi.stacked_tables(max(H, 1), 1)
        tables = torch.from_numpy(tab_np).to(dev)
        counts = torch.from_numpy(cnt_np).to(dev)
        t = torch.ones(B, dtype=torch.int32, device=dev)
        _, C, Hp1 = tables.shape
        ops = int(counts[h.clamp(0, Hp1 - 1).long()].sum()) * o.shape[1] * Hp1
        for gate, pol in (("routed", routing.resolve_policy("nearest_copy")),
                          ("scored", routing.nearest_copy_dp())):
            w = w0.clone()
            args = (o, ln, packed.shard, f_d, tables, counts, t, rank)
            got = pu.fused_update(w.clone(), *args, pol=pol)
            want = pu.fused_update_plain(w.clone(), *args, pol=pol)
            check(all(torch.equal(g, x) for g, x in zip(got[1:], want[1:]))
                  and torch.equal(got[0][:-1], want[0][:-1]),
                  f"sweep fused_update {gate} B={rows}: kernel vs plain")
            additions = int(got[3].sum())
            nbytes = fused_batch_bytes(o, ln, W, tables, additions, gate)
            restore = lambda: w.copy_(w0)  # noqa: E731
            out[f"{gate}/B={rows}"] = {
                **timed("kernel", lambda: pu.fused_update(w, *args, pol=pol), setup=restore),
                **timed("plain", lambda: pu.fused_update_plain(w, *args, pol=pol),
                        setup=restore),
                "rows": B, "bytes": nbytes, "int_ops": ops, "additions": additions,
                "candidates": int(counts[h.clamp(0, Hp1 - 1).long()].sum()),
                "C": C, "Hp1": Hp1,
                "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3,
                "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / INT32_OPS_PER_S
                            else "operations",
            }
    return out


def fused_batch_bytes(o, ln, W: int, tables, additions: int, gate: str) -> int:
    """Bytes one fused UPDATE round over rows ``o`` must move, each read
    once: the objects, lengths and budgets, each touched object's home,
    size and words, the tables, the rank vector (routed gate; the scored
    gate's scores follow from the words), the chosen plane, the subpath
    servers, the per-row outputs and one word per addition."""
    B, L = o.shape
    Hc, _, Hp1 = tables.shape
    valid = torch.arange(L, device=o.device)[None, :] < ln[:, None]
    touched = int(torch.unique(o[valid]).numel())
    return (4 * B * L + 8 * B + (8 + 4 * W) * touched + tables.numel() + 4 * Hc
            + (4 * W * 32 if gate == "routed" else 0)
            + B * L * Hp1 + 4 * B * Hp1 + 6 * B + 4 * additions)


def class_timing(pu, engine_mod, streaming, routing, combi, T, case, dev, rows=None,
                 batch: int = 256) -> dict:
    """The fused UPDATE of a t = 1 ``nearest_copy`` class of SNB scale 10
    paths (all of them, or the first ``rows``, cycled) against the
    sharding-only words, in ``batch``-row snapshot batches: one
    ``fused_update_class`` launch, and the sequence of per-batch calls it
    replaced (per batch three uploads from the host, one ``fused_update``
    call, the statistics added on the device), from the same starting
    words.  Both
    must give the same words and rows, and the class kernel its plain
    version's (``fused_update_class_plain``, timed once).  The bound sums
    each batch's bytes (:func:`fused_batch_bytes`) and mask operations."""
    _, ps, shard, f = case
    packed = engine_mod.PackedScheme.from_sharding(shard, 6, dev)
    w0 = packed.words
    W = w0.shape[1]
    sd = packed.shard
    f_d = torch.from_numpy(f).to(dev)
    rank = torch.zeros(W * 32, dtype=torch.float32, device=dev)
    N = ps.n_paths if rows is None else rows
    idx = np.arange(N) % ps.n_paths
    o_np = np.ascontiguousarray(np.asarray(ps.objects, np.int32)[idx])
    l_np = np.ascontiguousarray(np.asarray(ps.lengths, np.int32)[idx])
    t_np = np.ones(N, np.int32)
    o, ln, t = (torch.from_numpy(a).to(dev) for a in (o_np, l_np, t_np))
    _, _, h = T.subpath_structure(o, ln, sd)
    H = combi.max_h_within_budget(1, 2048, int(h.max()))
    tab_np, cnt_np = combi.stacked_tables(max(H, 1), 1)
    tables, counts = torch.from_numpy(tab_np).to(dev), torch.from_numpy(cnt_np).to(dev)
    Hp1 = tables.shape[2]
    pol = routing.resolve_policy("nearest_copy")
    w = w0.clone()
    acc = torch.zeros(3, dtype=torch.float32, device=dev)

    def restore():
        w.copy_(w0)
        acc.zero_()

    def one_launch():
        return pu.fused_update_class(w, o, ln, sd, f_d, tables, counts, t, rank, acc,
                                     batch_size=batch, pol=pol)

    def per_batch():
        outs = []
        for i in range(0, N, batch):
            o_d, l_d, t_d = (streaming.to_device(a[i : i + batch], dev)
                             for a in (o_np, l_np, t_np))
            res = pu.fused_update(w, o_d, l_d, sd, f_d, tables, counts, t_d, rank, pol=pol)
            acc.add_(torch.stack([res[1].sum(), res[2].sum(dtype=torch.float32),
                                  res[5].sum(dtype=torch.float32)]))
            outs.append(res[1:])
        return [torch.cat(x) for x in zip(*outs)]

    restore()
    got = one_launch()[1:]
    w_cls, acc_cls = w.clone(), acc.clone()
    restore()
    seq = per_batch()
    check(torch.equal(w[:-1], w_cls[:-1]) and all(torch.equal(a, b) for a, b in zip(got, seq)),
          f"fused_update_class N={N}: one launch differs from the per-batch sequence")
    restore()
    (plain, plain_s) = synced(lambda: pu.fused_update_class_plain(
        w, o, ln, sd, f_d, tables, counts, t, rank, acc, batch_size=batch, pol=pol))
    check(torch.equal(w[:-1], w_cls[:-1]) and torch.equal(acc, acc_cls)
          and all(torch.equal(a, b) for a, b in zip(got, plain[1:])),
          f"fused_update_class N={N}: kernel vs plain")
    adds = got[2].flatten(1).sum(dim=1)
    nbytes = ops = 0
    for i in range(0, N, batch):
        sl = slice(i, i + batch)
        nbytes += fused_batch_bytes(o[sl], ln[sl], W, tables, int(adds[sl].sum()), "routed")
        ops += int(counts[h[sl].clamp(0, Hp1 - 1).long()].sum()) * o.shape[1] * Hp1
    return {**timed("kernel", one_launch, setup=restore),
            **timed("per_batch", per_batch, setup=restore),
            "plain_ms": plain_s * 1e3, "plain_device_ms": None,
            "rows": N, "batch": batch, "batches": -(-N // batch), "C": tables.shape[1],
            "Hp1": Hp1, "additions": int(adds.sum()), "bytes": nbytes, "int_ops": ops,
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / INT32_OPS_PER_S
                        else "operations",
            "acc": acc_cls.tolist()}


PRUNE_PREFIX = 2_000  # candidates of the main path's t = 1 prune held against the plain loop


def csr_index(objects: torch.Tensor, n: int):
    """(starts int32 [n + 1], rows int32 [nnz]) of the object -> path index
    (``engine.incremental.PathIndex``'s layout), built on the device."""
    P, L = objects.shape
    valid = objects >= 0
    flat_v = objects[valid].long()
    flat_p = torch.arange(P, device=objects.device).repeat_interleave(L)[valid.flatten()]
    order = torch.argsort(flat_v, stable=True)
    starts = torch.searchsorted(flat_v[order], torch.arange(n + 1, device=objects.device))
    return starts.int(), flat_p[order].int()


def prune_bytes(cand_v: np.ndarray, cand_s: np.ndarray, starts: np.ndarray,
                rows: np.ndarray, objects: np.ndarray, W: int, rank: bool = True) -> int:
    """Bytes the sweep must move, each read once: the candidates and their
    keep flags, their objects' CSR ranges and row entries, each touched
    path's objects, length and budget, each object on those paths' home
    and words, one word written per edited cell, and the rank vector (not
    read by the scored sweep, ``rank=False``)."""
    uv = np.unique(cand_v)
    lo, hi = starts[uv].astype(np.int64), starts[uv + 1].astype(np.int64)
    entries = int((hi - lo).sum())
    idx = np.repeat(lo - np.concatenate([[0], np.cumsum(hi - lo)[:-1]]), hi - lo)
    paths = np.unique(rows[idx + np.arange(entries)])
    objs = objects[paths]
    touched = np.unique(objs[objs >= 0]).size
    cells = np.unique(cand_v.astype(np.int64) * W + cand_s // 32).size
    return (9 * len(cand_v) + 8 * len(uv) + 4 * entries
            + int((objs >= 0).sum()) * 4 + 8 * len(paths)
            + (4 + 4 * W) * touched + 4 * cells + (4 * W * 32 if rank else 0))


def random_prune_case(backends, seed: int, n_obj: int, n_srv: int, P: int, L: int, C: int,
                      dev):
    """Seeded random prune_walk inputs on the device (C candidates)."""
    objects, lengths, words, shard, _, load = random_case(seed, P, L, n_srv, n_obj, dev)
    shard = shard.clamp_min(0)
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    starts, rows = csr_index(objects, n_obj)
    bits = backends.unpack_bits(words[:-1])[:, :n_srv].clone()
    bits[torch.arange(n_obj, device=dev), shard.long()] = False
    vs, ss = torch.nonzero(bits, as_tuple=True)
    pick = torch.randperm(len(vs), generator=g, device=dev)[:C]
    # budgets of about half a path: some removals stay, some are restored
    t_path = torch.randint(L // 2, L, (P,), generator=g, device=dev, dtype=torch.int32)
    return (words, vs[pick].int(), ss[pick].int(), starts, rows, objects, lengths, t_path,
            shard, load)


def prune_inputs(T, engine_mod, case, t: int, dev) -> dict:
    """The main path's serial prune inputs at budget t: the nearest_copy
    greedy's scheme before its prune, its candidates in prune order (f
    descending) and the CSR index, on the device."""
    _, ps, shard, f = case
    scheme, _ = T.replicate_workload(ps, shard, 6, t, f=f, policy="nearest_copy",
                                     policy_prune=False)
    return sweep_inputs(engine_mod, case, scheme, t, dev)


def sweep_inputs(engine_mod, case, scheme, t: int, dev) -> dict:
    """A pre-prune scheme's serial prune inputs at budget t (see
    :func:`prune_inputs`)."""
    _, ps, _, f = case
    n = scheme.n_objects
    objects_np = np.asarray(ps.objects, np.int32)
    index = engine_mod.PathIndex(objects_np, n)
    repl = scheme.mask.copy()
    repl[np.arange(n), scheme.shard] = False
    vs, ss = np.nonzero(repl)
    order = np.argsort(-f.astype(np.float64)[vs], kind="stable")
    cand_v, cand_s = vs[order].astype(np.int32), ss[order].astype(np.int32)
    packed = engine_mod.PackedScheme.from_mask(scheme.mask, scheme.shard, dev)
    d = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    starts_np = index.starts.astype(np.int32)
    rest = (d(starts_np), d(index.rows), d(objects_np),
            d(np.asarray(ps.lengths, np.int32)),
            torch.full((ps.n_paths,), t, dtype=torch.int32, device=dev), packed.shard)
    return {"scheme": scheme, "index": index, "objects_np": objects_np,
            "lengths_np": np.asarray(ps.lengths, np.int32), "starts_np": starts_np,
            "cand_v": cand_v, "cand_s": cand_s, "cv": d(cand_v),
            "cs": d(cand_s), "w0": packed.words.clone(), "rest": rest}


def int_err(*pairs) -> int:
    """max |a - b| over the pairs of integer or bool tensors (0 when equal)."""
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0 for a, b in pairs)


def whole_sweep_check(T, pw, engine_mod, case, inp: dict, t: int, main_out: dict,
                      rank, dev, policy: str = "nearest_copy") -> dict:
    """The whole serial prune at budget t through ``prune_walk`` (under
    ``nearest_copy``; ``prune_walk_scored`` under ``nearest_copy_dp``),
    against an independent version: the batched prune (``fused=True``) on
    the torch backend (plain torch walks, no kernel) from the same scheme,
    which makes the serial sweep's decisions.  Keep flags, final words and
    mask equal; the drive's (``main_out``) count and mask equal the
    reference's."""
    _, ps, _, f = case
    w = inp["w0"].clone()
    if policy == "nearest_copy_dp":
        keep = pw.prune_walk_scored(w, inp["cv"], inp["cs"], *inp["rest"])
    else:
        keep = pw.prune_walk(w, inp["cv"], inp["cs"], *inp["rest"], rank, home_first=False,
                             lookahead=True)
    ref = inp["scheme"].copy()
    tr = time.perf_counter()
    n_ref, _ = T.prune_scheme_replicas(ref, ps, t, policy=policy, f=f,
                                       backend="torch", fused=True, device=dev)
    ref_s = time.perf_counter() - tr
    keep_ref = torch.from_numpy(~ref.mask[inp["cand_v"], inp["cand_s"]]).to(dev)
    w_ref = engine_mod.PackedScheme.from_mask(ref.mask, ref.shard, dev).words
    check(w.shape == w_ref.shape, f"t={t}: words {tuple(w.shape)} vs {tuple(w_ref.shape)}")
    err = int_err((keep, keep_ref), (w, w_ref))
    check(err == 0, f"{policy} whole t={t} sweep vs the torch batched prune: "
                    f"max |diff| {err}")
    check(int(keep.sum()) == n_ref,
          f"{policy} sweep t={t} removed {int(keep.sum())}, the reference {n_ref}")
    check(main_out["runs"][t]["pruned"] == n_ref,
          f"{policy} drive t={t} pruned {main_out['runs'][t]['pruned']}, the reference {n_ref}")
    check(np.array_equal(main_out["schemes"][t].mask, ref.mask),
          f"{policy} drive t={t} mask vs the reference prune's")
    return {"candidates": len(inp["cand_v"]), "removed": n_ref,
            "kept": len(inp["cand_v"]) - n_ref, "max_abs_err": err, "reference_s": ref_s}


def phase_prune(T, pw, rw, backends, engine_mod, case, main_out: dict, dev) -> dict:
    """The serial prune's kernel on the main path's inputs (see
    :func:`prune_inputs`).  The first PRUNE_PREFIX t = 1 candidates go
    through ``prune_walk`` and ``prune_walk_plain`` under home_first,
    nearest_copy and queue_aware (a seeded load with ties): keep flags and
    words identical; seeded random cases do the same for the plain-loop
    bucket (L 9, W 2).  The whole t = 1 and t = 2 sweeps are held against
    an independent version (:func:`whole_sweep_check`).  The t = 1 sweep is
    timed with its µs per candidate, and the routed walk is timed at the old
    per-candidate prune's median row count (the launch this kernel
    replaces)."""
    t0 = time.perf_counter()
    _, ps, _, _ = case
    inp = prune_inputs(T, engine_mod, case, 1, dev)
    n = inp["scheme"].n_objects
    objects_np, index, starts_np = inp["objects_np"], inp["index"], inp["starts_np"]
    cand_v, cand_s, cv, cs, w0, rest = (inp[k] for k in ("cand_v", "cand_s", "cv", "cs",
                                                          "w0", "rest"))
    W = w0.shape[1]
    d = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    zero = backends._load_vector(None, w0)
    qload = backends._load_vector(np.random.default_rng(5).integers(0, 3, 6), w0)
    modes = {"home_first": (zero, True, False), "nearest_copy": (zero, False, True),
             "queue_aware": (qload, False, True)}
    pre_v, pre_s = cv[:PRUNE_PREFIX], cs[:PRUNE_PREFIX]
    parity = {}
    errs = []
    for mode, (rank, hf, la) in modes.items():
        wk, wp = w0.clone(), w0.clone()
        keep_k = pw.prune_walk(wk, pre_v, pre_s, *rest, rank, home_first=hf, lookahead=la)
        keep_p = pw.prune_walk_plain(wp, pre_v, pre_s, *rest, rank, home_first=hf,
                                     lookahead=la)
        errs.append(int_err((keep_k, keep_p), (wk, wp)))
        check(errs[-1] == 0,
              f"prune_walk {mode}: kernel vs plain on the main path's first "
              f"{PRUNE_PREFIX} candidates")
        parity[mode] = {"candidates": PRUNE_PREFIX, "kept_removed": int(keep_k.sum())}
    for seed, (n_srv, L) in enumerate(((6, 9), (40, 6))):
        for mode, (_, hf, la) in modes.items():
            words, *args = random_prune_case(backends, 100 + seed, 20_000, n_srv, 30_000, L,
                                             500, dev)
            if mode != "queue_aware":
                args[-1] = torch.zeros_like(args[-1])
            wk, wp = words.clone(), words.clone()
            keep_k = pw.prune_walk(wk, *args, home_first=hf, lookahead=la)
            keep_p = pw.prune_walk_plain(wp, *args, home_first=hf, lookahead=la)
            errs.append(int_err((keep_k, keep_p), (wk, wp)))
            check(errs[-1] == 0, f"prune_walk {mode} random L={L} S={n_srv}: kernel vs plain")
            parity[f"{mode}/random L={L} S={n_srv}"] = {"candidates": 500,
                                                        "kept_removed": int(keep_k.sum())}
    # the whole t = 1 and t = 2 sweeps against the independent batched prune
    whole_check = {1: whole_sweep_check(T, pw, engine_mod, case, inp, 1, main_out, zero, dev)}
    whole_check[2] = whole_sweep_check(T, pw, engine_mod, case,
                                       prune_inputs(T, engine_mod, case, 2, dev), 2, main_out,
                                       zero, dev)
    errs += [c["max_abs_err"] for c in whole_check.values()]
    w = w0.clone()
    restore = lambda: w.copy_(w0)  # noqa: E731
    C = len(cand_v)
    whole = timed("kernel", lambda: pw.prune_walk(w, cv, cs, *rest, zero, lookahead=True),
                  setup=restore)
    prefix = {
        **timed("kernel", lambda: pw.prune_walk(w, pre_v, pre_s, *rest, zero, lookahead=True),
                setup=restore),
        **timed("plain", lambda: pw.prune_walk_plain(w, pre_v, pre_s, *rest, zero,
                                                     lookahead=True), reps=1, setup=restore),
        "candidates": PRUNE_PREFIX, "max_abs_err": max(errs),
    }
    prefix["bytes"] = prune_bytes(cand_v[:PRUNE_PREFIX], cand_s[:PRUNE_PREFIX], starts_np,
                                  index.rows, objects_np, W)
    prefix.update(bound_ms=prefix["bytes"] / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    whole_bytes = prune_bytes(cand_v, cand_s, starts_np, index.rows, objects_np, W)
    # where a decision's time goes: C candidates on objects that lie on no
    # path (the loop alone: barriers, thread 0's stores, the next
    # candidate's loads), and one candidate with one path, C times over
    # (its data cached: the walk of one path without scattered reads)
    rows_of = np.diff(index.starts)
    no_path = np.nonzero(rows_of == 0)[0]
    one = int(np.nonzero(rows_of[cand_v] == 1)[0][0])
    probes = {"no_path": (d(np.resize(no_path, C).astype(np.int32)), torch.zeros_like(cv)),
              "one_path_repeated": (torch.full_like(cv, int(cand_v[one])),
                                    torch.full_like(cs, int(cand_s[one])))}
    per_candidate = {
        name: time_ms(lambda: pw.prune_walk(w, pv, ps_, *rest, zero, lookahead=True),
                      setup=restore) * 1e3 / C
        for name, (pv, ps_) in probes.items()}
    # the old sweep launched the routed walk once per candidate on its
    # object's distinct rows
    v_of = np.repeat(np.arange(n), np.diff(index.starts))
    new = np.ones(len(index.rows), bool)
    new[1:] = (index.rows[1:] != index.rows[:-1]) | (v_of[1:] != v_of[:-1])
    distinct = np.bincount(v_of[new], minlength=n)[cand_v]
    med = int(statistics.median_low(distinct[distinct > 0].tolist()))
    c_med = int(np.nonzero(distinct == med)[0][0])
    prow = np.unique(index.rows[index.starts[cand_v[c_med]]:index.starts[cand_v[c_med] + 1]])
    before = walk_timing(rw, backends, d(objects_np[prow]),
                         d(np.asarray(ps.lengths, np.int32)[prow]), w0, rest[5])
    out = {
        "phase": "prune", "seconds": time.perf_counter() - t0, "candidates": C,
        "parity": parity, "whole_sweep_vs_reference": whole_check,
        "us_per_candidate_probes": per_candidate,
        "whole": {**whole, "candidates": C, "us_per_candidate": whole["kernel_ms"] * 1e3 / C,
                  "bytes": whole_bytes,
                  "bound_ms": whole_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"},
        "prefix": prefix,
        "old_prune_rows_per_launch": {"min": int(distinct[distinct > 0].min()), "median": med,
                                      "max": int(distinct.max()),
                                      "launches": int((distinct > 0).sum())},
        "routed_walk_at_old_prune_median": before,
    }
    emit(out)
    return out


def old_dp_loop(backends, engine_mod, streaming, inp: dict, t: int, n: int, pol, dev):
    """The per-candidate ``nearest_copy_dp`` prune that ``prune_walk_scored``
    replaces (``prune_scheme_replicas``' loop before the scored sweep), on
    the first ``n`` candidates: per candidate a bit clear, the affected
    rows' upload, the DP gate walk (the score tables in torch ops and one
    ``scored_walk`` launch), a blocking readback and a restore on a
    violation.  Returns (keep bool [n], final words, host seconds)."""
    scheme, index = inp["scheme"], inp["index"]
    packed = engine_mod.PackedScheme.from_mask(scheme.mask, scheme.shard, dev)
    rank = backends._load_vector(None, packed.words)
    keep = np.ones(n, bool)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(n):
        v, s = int(inp["cand_v"][c]), int(inp["cand_s"][c])
        packed.set_bit(v, s, False)
        idx = index.paths_of(v)
        if len(idx):
            h = backends.gate_counts(streaming.to_device(inp["objects_np"][idx], dev),
                                     streaming.to_device(inp["lengths_np"][idx], dev),
                                     packed.words, packed.shard, pol, rank, backend="kernel")
            if not np.all(streaming.to_host(h) <= t):
                packed.set_bit(v, s, True)
                keep[c] = False
    torch.cuda.synchronize()
    return keep, packed.words, time.perf_counter() - t0


def phase_dp_prune(T, pw, rw, backends, engine_mod, streaming, routing, counters, case,
                   dev) -> dict:
    """``nearest_copy_dp``'s separate drive and its serial prune (see the
    module docstring).  The drive runs as shipped, timed; each prune is
    then replayed, untimed, from the greedy's pre-prune scheme
    (``policy_prune=False``), with the scored launches counted inside it,
    and the replay must give the drive's mask and count."""
    t0 = time.perf_counter()
    _, ps, shard, f = case
    pol = "nearest_copy_dp"
    runs, schemes = {}, {}
    # the drive: counters zeroed just before, read just after
    zero_counts(counters)
    for t in (1, 2):
        ts = time.perf_counter()
        scheme, st = T.replicate_workload(ps, shard, 6, t, f=f, policy=pol)
        greedy_s = time.perf_counter() - ts
        tf = time.perf_counter()
        feasible = T.is_latency_feasible(ps, scheme, t, policy=pol)
        feas_s = time.perf_counter() - tf
        check(feasible, f"{pol} t={t}: scheme not feasible under {pol}")
        check(st.failed_paths == 0, f"{pol} t={t}: {st.failed_paths} failed paths")
        check(st.routed_violations == 0,
              f"{pol} t={t}: {st.routed_violations} routed violations")
        schemes[t] = scheme
        runs[t] = {
            "replicas": st.replicas, "pruned": st.pruned_replicas,
            "overhead": scheme.replication_overhead(f.astype(np.float64)),
            "failed_paths": st.failed_paths, "routed_violations": st.routed_violations,
            "routed_skips": st.routed_skips, "fallback_paths": st.fallback_paths,
            "feasible": feasible, "greedy_s": greedy_s,
            "stage_s": dict(st.stage_s, feasibility=feas_s),
        }
    launches = read_counts(counters)
    check(launches["prune_walk_scored"] == 2,
          f"prune_walk_scored launched {launches['prune_walk_scored']} times in the "
          f"{pol} drive, expected 2 (one serial prune per t)")
    # the replay: the prune's only scored_walk launches are its h0
    # feasibility walk over all paths (one per engine chunk), none per
    # candidate
    keys = ("prune_walk_scored", "scored_walk", "h0_walk_scored_walk")
    inside, pre = [], {}
    for t in (1, 2):
        pre[t], _ = T.replicate_workload(ps, shard, 6, t, f=f, policy=pol, policy_prune=False)
        replay = pre[t].copy()
        sw, sc = rw.SCORED_LAUNCHES, pw.SCORED_LAUNCHES
        n = T.prune_scheme_replicas(replay, ps, t, policy=pol, f=f, device=dev)[0]
        r = {"scored_walk": rw.SCORED_LAUNCHES - sw, "prune_walk_scored": pw.SCORED_LAUNCHES - sc}
        check(n == runs[t]["pruned"] and np.array_equal(replay.mask, schemes[t].mask),
              f"{pol} t={t}: the replayed prune ({n} removed) differs from the drive's "
              f"({runs[t]['pruned']})")
        before = rw.SCORED_LAUNCHES
        engine_mod.LatencyEngine(pre[t]).path_latencies(ps, policy=pol)
        r["h0_walk_scored_walk"] = rw.SCORED_LAUNCHES - before
        inside.append(r)
    check(all(r["prune_walk_scored"] == 1 and r["scored_walk"] == r["h0_walk_scored_walk"]
              for r in inside),
          f"{pol} prunes: {[tuple(r[k] for k in keys) for r in inside]} ({', '.join(keys)}) "
          "launches, expected (1, n, n) each")
    inp = {t: sweep_inputs(engine_mod, case, pre[t], t, dev) for t in (1, 2)}
    i1 = inp[1]
    cv, cs, w0, rest = i1["cv"], i1["cs"], i1["w0"], i1["rest"]
    pre_v, pre_s = cv[:PRUNE_PREFIX], cs[:PRUNE_PREFIX]
    errs, parity = [], {}
    # the "before": the old per-candidate loop on the first PRUNE_PREFIX candidates
    keep_old, w_old, old_s = old_dp_loop(backends, engine_mod, streaming, i1, 1, PRUNE_PREFIX,
                                         routing.resolve_policy(pol), dev)
    plain = {}
    for depth in (-1, 2):
        wk, wp = w0.clone(), w0.clone()
        keep_k = pw.prune_walk_scored(wk, pre_v, pre_s, *rest, depth=depth)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        keep_p = pw.prune_walk_scored_plain(wp, pre_v, pre_s, *rest, depth=depth)
        b.record()
        torch.cuda.synchronize()
        plain[depth] = a.elapsed_time(b)
        errs.append(int_err((keep_k, keep_p), (wk, wp)))
        check(errs[-1] == 0, f"prune_walk_scored depth={depth}: kernel vs plain on the "
                             f"{pol} drive's first {PRUNE_PREFIX} t = 1 candidates")
        if depth < 0:
            errs.append(int_err((keep_k, torch.from_numpy(keep_old).to(dev)), (wk, w_old)))
            check(errs[-1] == 0, f"prune_walk_scored vs the old per-candidate loop on the "
                                 f"first {PRUNE_PREFIX} t = 1 candidates")
        parity[f"depth={depth}"] = {"candidates": PRUNE_PREFIX,
                                    "kept_removed": int(keep_k.sum())}
    for seed, (n_srv, L) in enumerate(((6, 6), (6, 9), (40, 6))):
        words, *args = random_prune_case(backends, 200 + seed, 20_000, n_srv, 30_000, L, 300,
                                         dev)
        # about 3% of the objects without any holder: the DP's dead state
        g = torch.Generator(device=dev).manual_seed(300 + seed)
        words[:-1][torch.rand(words.shape[0] - 1, generator=g, device=dev) < 0.03] = 0
        for depth in (-1, 2):
            wk, wp = words.clone(), words.clone()
            keep_k = pw.prune_walk_scored(wk, *args[:-1], depth=depth)
            keep_p = pw.prune_walk_scored_plain(wp, *args[:-1], depth=depth)
            errs.append(int_err((keep_k, keep_p), (wk, wp)))
            check(errs[-1] == 0,
                  f"prune_walk_scored depth={depth} random L={L} S={n_srv}: kernel vs plain")
            parity[f"depth={depth}/random L={L} S={n_srv}"] = {
                "candidates": len(keep_k), "kept_removed": int(keep_k.sum())}
    drive = {"runs": runs, "schemes": schemes}
    whole_check = {t: whole_sweep_check(T, pw, engine_mod, case, inp[t], t, drive, None, dev,
                                        policy=pol) for t in (1, 2)}
    errs += [c["max_abs_err"] for c in whole_check.values()]
    w = w0.clone()
    restore = lambda: w.copy_(w0)  # noqa: E731
    C = len(i1["cand_v"])
    W = w0.shape[1]
    whole = timed("kernel", lambda: pw.prune_walk_scored(w, cv, cs, *rest), setup=restore)
    whole_bytes = prune_bytes(i1["cand_v"], i1["cand_s"], i1["starts_np"], i1["index"].rows,
                              i1["objects_np"], W, rank=False)
    prefix = {
        **timed("kernel", lambda: pw.prune_walk_scored(w, pre_v, pre_s, *rest), setup=restore),
        "plain_ms": plain[-1], "plain_device_ms": None,
        "candidates": PRUNE_PREFIX, "max_abs_err": max(errs),
        "bytes": prune_bytes(i1["cand_v"][:PRUNE_PREFIX], i1["cand_s"][:PRUNE_PREFIX],
                             i1["starts_np"], i1["index"].rows, i1["objects_np"], W,
                             rank=False),
    }
    prefix.update(bound_ms=prefix["bytes"] / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    out = {
        "phase": "dp_prune", "seconds": time.perf_counter() - t0, "policy": pol,
        "paths": ps.n_paths, "n_servers": 6, "runs": runs, "launches": launches,
        "prunes": inside,
        "candidates": {t: len(inp[t]["cand_v"]) for t in (1, 2)},
        "parity": parity, "whole_sweep_vs_reference": whole_check,
        "old_loop": {"candidates": PRUNE_PREFIX, "seconds": old_s,
                     "ms_per_candidate": old_s * 1e3 / PRUNE_PREFIX,
                     "kept_removed": int(keep_old.sum())},
        "plain_ms_depth2": plain[2],
        "whole": {**whole, "candidates": C, "us_per_candidate": whole["kernel_ms"] * 1e3 / C,
                  "bytes": whole_bytes, "bound_ms": whole_bytes / HBM_BYTES_PER_S * 1e3,
                  "bound_by": "bytes"},
        "prefix": prefix,
    }
    emit(out)
    return out


def walk_timing(rw, backends, o, ln, wd, sd) -> dict:
    """The nearest_copy routed walk on these rows: kernel vs plain (exact),
    both timed, with the sweep's byte count."""
    P, L = o.shape
    W = wd.shape[1]
    start = backends._root_home(o, sd)
    zero = backends._load_vector(None, wd)
    s, loc = rw.routed_walk(o, ln, wd, sd, start, zero)
    ws, wl = rw.routed_walk_plain(o, ln, wd, sd, start, zero)
    check(torch.equal(s, ws) and torch.equal(loc, wl), f"routed_walk P={P}: kernel vs plain")
    valid = torch.arange(L, device=o.device)[None, :] < ln[:, None]
    touched = int(torch.unique(o[valid]).numel())
    nbytes = 8 * P + 4 * int(ln.long().sum()) + (4 * W + 4) * touched + 4 * W * 32 + 5 * P * L
    return {**timed("kernel", lambda: rw.routed_walk(o, ln, wd, sd, start, zero)),
            **timed("plain", lambda: rw.routed_walk_plain(o, ln, wd, sd, start, zero)),
            "rows": P, "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


def path_latency_launch_facts(pl, objects, lengths, W: int) -> dict:
    """The launch plan ``path_latency`` takes for these rows, and
    ``sector_bytes``: 32 bytes for each distinct 32-byte sector of the word
    rows (positions 1 .. len - 1, the whole row) and of the home entries
    (positions 0 .. len - 1) the walk reads, plus the objects span, the
    lengths and the output, and ``sector_bound_ms``, those bytes over the
    card's memory rate (a bound, not a time taken).  Beside the byte bound,
    which counts 4 bytes per table entry, it says what random gathers must
    move."""
    P, L = objects.shape
    plan = pl.launch_plan(P, L, W)
    pos = torch.arange(L, device=objects.device)[None, :]
    valid = pos < lengths[:, None]
    v = objects.clamp_min(0).long()
    home_sectors = torch.unique(v[valid] // 8).numel()
    first = v[valid & (pos >= 1)] * (4 * W)
    starts = first // 32
    ends = (first + 4 * W - 1) // 32
    span = int((ends - starts).max()) + 1 if starts.numel() else 0
    ids = starts[:, None] + torch.arange(span, device=objects.device)[None, :]
    row_sectors = torch.unique(ids[ids <= ends[:, None]]).numel()
    sector_bytes = 32 * (home_sectors + row_sectors) + 4 * P * L + 8 * P
    return {"plan": dataclasses.asdict(plan), "sector_bytes": sector_bytes,
            "sector_bound_ms": sector_bytes / HBM_BYTES_PER_S * 1e3}


def phase_shapes(pl, rw, pu, backends, engine_mod, streaming, routing, combi, T, case,
                 main_out: dict, fused_out: dict, dev) -> dict:
    """Rows 1-4 timed once at the median rows per launch of the path that
    launches them (main: path_latency, routed_walk; fused: scored_walk,
    fused_update), on the first P paths of SNB scale 10 and the main t = 1
    scheme's words (fused_update: a class launch of P rows on the
    sharding-only words, :func:`class_timing`): ms, device_ms, plain, and
    the byte bound at that shape."""
    t0 = time.perf_counter()
    _, ps, shard, f = case
    med = {**{k: v["median"] for k, v in main_out["rows_per_launch"].items()
              if k in ("path_latency", "routed_walk")},
           **{k: v["median"] for k, v in fused_out["rows_per_launch"].items()
              if k in ("scored_walk", "fused_update")}}
    packed = engine_mod.PackedScheme.from_mask(main_out["schemes"][1].mask, shard, dev)
    wd, sd = packed.words, packed.shard
    W = wd.shape[1]
    objects_np = np.asarray(ps.objects, np.int32)
    lengths_np = np.asarray(ps.lengths, np.int32)
    # P rows from the start of the workload (cycled: a launch's P may count
    # padding rows past the workload's end)
    rows = lambda P: (torch.from_numpy(objects_np[np.arange(P) % ps.n_paths]).to(dev),  # noqa: E731
                      torch.from_numpy(lengths_np[np.arange(P) % ps.n_paths]).to(dev))
    timings = {}
    o, ln = rows(med["path_latency"])
    got = pl.path_latency(o, ln, wd, sd)
    check(torch.equal(got, pl.path_latency_plain(o, ln, wd, sd)), "path_latency: kernel vs plain")
    valid = torch.arange(o.shape[1], device=dev)[None, :] < ln[:, None]
    nbytes = (8 * o.shape[0] + 4 * int(ln.long().sum())
              + 8 * int(torch.unique(o[valid]).numel()))
    timings["path_latency"] = {
        **timed("kernel", lambda: pl.path_latency(o, ln, wd, sd)),
        **timed("plain", lambda: pl.path_latency_plain(o, ln, wd, sd)),
        "rows": o.shape[0], "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", **path_latency_launch_facts(pl, o, ln, W)}
    timings["routed_walk"] = walk_timing(rw, backends, *rows(med["routed_walk"]), wd, sd)
    o, ln = rows(med["scored_walk"])
    sc = sweep_scored(rw, backends, o, ln, wd, sd, backends._root_home(o, sd), W,
                      chunk=o.shape[0])
    sc.update(rows=o.shape[0], bound_ms=sc["bytes"] / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    timings["scored_walk"] = sc
    # fused_update: one class launch at the median class size
    timings["fused_update"] = class_timing(pu, engine_mod, streaming, routing, combi, T, case,
                                           dev, rows=med["fused_update"])
    out = {"phase": "shapes", "seconds": time.perf_counter() - t0, "median_rows": med,
           "timings": timings}
    emit(out)
    return out


def phase_sweep(pl, rw, pu, graph_mod, workload_mod, engine_mod, backends, streaming, routing,
                combi, T, main_case, scale: int, n_queries: int, dev, launches: dict) -> dict:
    t0 = time.perf_counter()
    snb = graph_mod.snb_like(scale=scale, seed=0)
    ps = workload_mod.snb_workload_materialized(snb, n_queries=n_queries, seed=0)
    n = snb.graph.n_nodes
    n_srv = 128
    shard = graph_mod.hash_partition(n, n_srv)
    rng = np.random.default_rng(1)
    W = (n_srv + 31) // 32
    words = np.zeros((n + 1, W), np.uint32)
    s = shard.astype(np.int64)
    words[np.arange(n), s // 32] |= np.uint32(1) << (s % 32).astype(np.uint32)
    extra = np.nonzero(rng.random(n) < 0.25)[0]
    es = rng.integers(0, n_srv, len(extra))
    np.bitwise_or.at(words, (extra, es // 32), np.uint32(1) << (es % 32).astype(np.uint32))
    packed = engine_mod.PackedScheme.from_numpy(words, shard, device=dev, n_servers=n_srv)
    load = rng.integers(0, 4, n_srv).astype(np.float32)  # ties
    eng_k = engine_mod.LatencyEngine(packed=packed, backend="kernel")
    eng_t = engine_mod.LatencyEngine(packed=packed, backend="torch")
    dp = eng_k.prepare(ps)
    setup_s = time.perf_counter() - t0
    objects, lengths = dp.objects, dp.lengths
    wd, sd = packed.words, packed.shard
    start = backends._root_home(objects, sd)
    zero = backends._load_vector(None, wd)
    qload = backends._load_vector(load, wd)

    # exact comparison through the engines, per policy
    h = {}
    for pol in ("home_first", "nearest_copy", "queue_aware"):
        hk = eng_k.path_latencies(dp, policy=pol, load=load)
        ht = eng_t.path_latencies(dp, policy=pol, load=load)
        check(np.array_equal(hk, ht), f"sweep {pol}: kernel vs plain")
        h[pol] = hk
    # bytes each walk must move (each input byte read once, each output
    # byte written once; only what this data needs)
    valid = torch.arange(ps.max_len, device=dev)[None, :] < lengths[:, None]
    sum_len = int(lengths.long().sum())
    touched = int(torch.unique(objects[valid]).numel())
    P, L = ps.n_paths, ps.max_len
    bytes_pl = 4 * P + 4 * sum_len + 8 * touched + 4 * P
    bytes_rw = 8 * P + 4 * sum_len + (4 * W + 4) * touched + 4 * W * 32 + 5 * P * L
    timings = {
        "path_latency": {
            **timed("kernel", lambda: pl.path_latency(objects, lengths, wd, sd)),
            **timed("plain", lambda: pl.path_latency_plain(objects, lengths, wd, sd)),
            "bytes": bytes_pl, **path_latency_launch_facts(pl, objects, lengths, W),
        }
    }
    for pol, lv, kw in (("home_first", zero, dict(home_first=True, lookahead=False)),
                        ("nearest_copy", zero, dict(home_first=False, lookahead=True)),
                        ("queue_aware", qload, dict(home_first=False, lookahead=True))):
        timings[f"routed_walk/{pol}"] = {
            **timed("kernel", lambda: rw.routed_walk(objects, lengths, wd, sd, start, lv, **kw)),
            **timed("plain", lambda: rw.routed_walk_plain(objects, lengths, wd, sd, start, lv,
                                                          **kw)),
            "bytes": bytes_rw,
        }
    timings["scored_walk"] = sweep_scored(rw, backends, objects, lengths, wd, sd, start,
                                          W, chunk=262_144)
    for name, v in sweep_fused(pu, backends, engine_mod, routing, combi, T,
                               main_case, dev).items():
        timings[f"fused_update/{name}"] = v
    # the whole scale 10 workload as one t = 1 class
    timings["fused_update/class"] = class_timing(pu, engine_mod, streaming, routing, combi,
                                                 T, main_case, dev)
    for name, v in timings.items():
        v.setdefault("bound_ms", v["bytes"] / HBM_BYTES_PER_S * 1e3)
        v.setdefault("bound_by", "bytes")
        v["launches"] = launches[name.split("/")[0]]  # on its path
    out = {
        "phase": "sweep", "seconds": time.perf_counter() - t0, "setup_s": setup_s,
        "scale": scale, "n_queries": n_queries, "objects": int(n), "paths": P,
        "max_len": L, "sum_len": sum_len, "touched_objects": touched,
        "n_servers": n_srv, "extra_copies": int(len(extra)),
        "mean_h": {k: float(v.mean()) for k, v in h.items()},
        "exact": True, "timings": timings,
        "library_ms": None,
        "library_note": "no single PyTorch call computes these data-dependent walks "
                        "or the fused UPDATE round",
    }
    emit(out)
    return out


def seeded(g, shape, dtype, dev) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def close_err(got, want, tol: float) -> tuple[float, bool]:
    """(max |got - want|, whether |got - want| <= tol + tol * |want| everywhere)."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    return float(d.max()), bool((d <= tol + tol * want.abs()).all())


def row_scaled_err(got, want) -> float:
    """max |got - want| over the rms of ``want`` across its last axis (hd),
    taken per (query row, head).  An attention output's scale falls along
    the sequence (an early row averages few values of v, a late one
    thousands), so an absolute tolerance, or one rms per head, set at the
    early rows' scale would pass a late row that lost a whole key tile."""
    got, want = got.float(), want.float()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
    return float(((got - want).abs() / rms).max())


def tile_mutants(q, k, v, h: int, want) -> dict:
    """How far :func:`row_scaled_err` moves when a kernel loses or repeats
    one 64-key tile: the exact attention of kv head ``h`` for the last
    query tile (its 128 rows: the last 128 // G positions), with the keys
    at the middle of the sequence dropped from its softmax or counted
    twice, rounded to bf16, against ``want`` (the exact output of the
    same rows)."""
    S, G, hd = q.shape[1], q.shape[3], q.shape[4]
    n = max(128 // G, 1)
    qh = q[:, S - n:, h].float()                                  # [B, n, G, hd]
    s = torch.einsum("bqgh,bth->bgqt", qh, k[:, :, h].float()) / hd ** 0.5
    s = torch.where(torch.arange(S, device=q.device)[None, :]
                    <= torch.arange(S - n, S, device=q.device)[:, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    k0 = S // 2 // 64 * 64
    out = {}
    for name, w in (("tile_dropped", 0.0), ("tile_doubled", 2.0)):
        pm = p.clone()
        pm[..., k0:k0 + 64] *= w
        pm = pm / pm.sum(-1, keepdim=True)
        mut = torch.einsum("bgqt,bth->bqgh", pm, v[:, :, h].float()).to(q.dtype)
        out[name] = row_scaled_err(mut, want[:, S - n:, 0])
    return out


def bound(ops: float, nbytes: float, ops_per_s: float) -> dict:
    """The least time for ``ops`` operations at ``ops_per_s`` and ``nbytes``
    moved once at the memory rate, and which of the two bounds it."""
    t_ops, t_bytes = ops / ops_per_s, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3, "ops": ops, "bytes": nbytes,
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def flash_bound(B: int, S: int, KV: int, G: int, hd: int, window: int, elt: int) -> dict:
    """Causal GQA attention: 4 * hd flops per (query head, key) pair the
    mask keeps, at the bf16 tensor-core rate, against q, k, v and the output
    moved once."""
    keys = torch.arange(1, S + 1, dtype=torch.float64)
    pairs = float((keys.clamp(max=window) if window > 0 else keys).sum())
    nbytes = (2 * B * S * KV * G * hd + 2 * B * S * KV * hd) * elt
    return bound(4.0 * B * KV * G * hd * pairs, nbytes, BF16_FLOPS_PER_S)


def phase_lm_parity(fp, da, eb, dev) -> dict:
    """Each new kernel against its plain version on seeded inputs."""
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(13)
    max_err = {"flash_prefill": 0.0, "decode_attention": 0.0, "embedding_bag": 0.0}
    cases = {}  # "kernel/dtype" -> number of cases, tolerance, largest error

    def record(kernel, case, got, want, tol):
        err, ok = close_err(got, want, tol)
        max_err[kernel] = max(max_err[kernel], err)
        key = f"{kernel}/{case['dtype']}"
        cases[key] = {"cases": cases.get(key, {"cases": 0})["cases"] + 1, "tol": tol,
                      "max_abs_err": max(err, cases.get(key, {}).get("max_abs_err", 0.0))}
        check(ok, f"{kernel} {case}: kernel vs plain beyond {tol} (max err {err})")

    dtypes = ((torch.float32, "float32"), (torch.bfloat16, "bfloat16"))
    # bf16 flash (decode below too): the kernel against the plain version in f32 on
    # the same bf16 values (the exact output, not rounded), by
    # row_scaled_err at FLASH_BF16_REL; at G = 16 also the ratio a kernel
    # that lost or repeated one key tile would give, which must fail it
    flash_rel, mutants = {}, {}
    for B, S, KV, G, hd, win in ((2, 256, 2, 4, 64, 0), (1, 128, 1, 8, 32, 0),
                                 (2, 256, 4, 2, 64, 48), (1, 4096, 4, 7, 128, 0),
                                 (1, 2048, 2, 16, 128, 700), (1, 384, 2, 5, 32, 0),
                                 (1, 8192, 8, 4, 120, 4096), (1, 4096, 4, 16, 128, 0)):
        for dt, name in dtypes:
            q = seeded(g, (B, S, KV, G, hd), dt, dev)
            k = seeded(g, (B, S, KV, hd), dt, dev)
            v = seeded(g, (B, S, KV, hd), dt, dev)
            got = fp.flash_prefill(q, k, v, win)
            case = dict(B=B, S=S, KV=KV, G=G, hd=hd, window=win, dtype=name)
            # the plain version one kv head at a time bounds its [S, S] scores
            for h in range(KV):
                sl = slice(h, h + 1)
                if dt == torch.float32:
                    record("flash_prefill", dict(case, kv_head=h), got[:, :, sl],
                           fp.flash_prefill_plain(q[:, :, sl], k[:, :, sl], v[:, :, sl], win),
                           2e-5)
                    continue
                want = fp.flash_prefill_plain(q[:, :, sl].float(), k[:, :, sl].float(),
                                              v[:, :, sl].float(), win)
                rel = row_scaled_err(got[:, :, sl], want)
                max_err["flash_prefill"] = max(max_err["flash_prefill"],
                                               float((got[:, :, sl].float() - want).abs().max()))
                key = f"B{B}_S{S}_KV{KV}_G{G}_hd{hd}_w{win}"
                flash_rel[key] = max(flash_rel.get(key, 0.0), rel)
                check(rel <= FLASH_BF16_REL, f"flash_prefill {case} kv head {h}: error "
                      f"{rel} of the row rms beyond {FLASH_BF16_REL}")
                if G == 16 and win == 0 and h == KV - 1:
                    mutants[key] = tile_mutants(q, k, v, h, want)
                    for m_name, m_rel in mutants[key].items():
                        check(m_rel > FLASH_BF16_REL, f"flash_prefill {case}: a kernel with "
                              f"one key tile {m_name} passes ({m_rel})")
                del want
            del q, k, v, got
    cases["flash_prefill/bfloat16"] = {"check": "row_scaled_err vs the f32 plain version",
                                       "limit": FLASH_BF16_REL, "by_case": flash_rel,
                                       "one_tile_mutants": mutants}
    decode_rel = {}
    for B, KV, G, hd, T, lens in ((2, 2, 4, 64, 300, None), (1, 1, 8, 128, 1024, None),
                                  (3, 4, 1, 64, 77, None),
                                  (9, 4, 7, 128, 4100, [0, 1, 2, 31, 32, 33, 2050, 4099, 4100]),
                                  (4, 4, 7, 128, 1040, [1040, 63, 64, 65]),
                                  (6, 8, 4, 120, 3001, [0, 1, 63, 64, 65, 3001])):
        if lens is None:
            lengths = torch.randint(1, T + 1, (B,), generator=g, device=dev, dtype=torch.int32)
        else:
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        for dt, name in dtypes:
            q = seeded(g, (B, KV, G, hd), dt, dev)
            k = seeded(g, (B, T, KV, hd), dt, dev)
            v = seeded(g, (B, T, KV, hd), dt, dev)
            case = dict(B=B, KV=KV, G=G, hd=hd, T=T, dtype=name, lengths=lengths.tolist())
            got = da.decode_attention(q, k, v, lengths)
            if dt == torch.float32:
                record("decode_attention", case, got, da.decode_attention_plain(q, k, v, lengths),
                       2e-5)
                continue
            # bf16 as flash: against the f32 plain version, row-scaled
            want = da.decode_attention_plain(q.float(), k.float(), v.float(), lengths)
            rel = row_scaled_err(got, want)
            max_err["decode_attention"] = max(max_err["decode_attention"],
                                              float((got.float() - want).abs().max()))
            decode_rel[f"B{B}_KV{KV}_G{G}_hd{hd}_T{T}"] = rel
            check(rel <= FLASH_BF16_REL, f"decode_attention {case}: error {rel} of the row rms "
                  f"beyond {FLASH_BF16_REL}")
    cases["decode_attention/bfloat16"] = {"check": "row_scaled_err vs the f32 plain version",
                                          "limit": FLASH_BF16_REL, "by_case": decode_rel}
    N, d, B, L = 100_000, 64, 1024, 50
    ids = torch.randint(0, N, (B, L), generator=g, device=dev, dtype=torch.int32)
    ids[torch.rand((B, L), generator=g, device=dev) < 0.1] = -1
    ids[:8] = -1                      # all-padding bags
    ids[8, :3] = torch.tensor([N, N + 7, 2**31 - 1], dtype=torch.int32)  # past the table
    for dt, name in dtypes:
        table = seeded(g, (N, d), dt, dev)
        for mode in ("mean", "sum"):
            got = eb.embedding_bag(table, ids, mode)
            check(bool((got[:8] == 0).all()), f"embedding_bag {mode} {name}: all-padding bag not 0")
            record("embedding_bag", dict(N=N, d=d, B=B, L=L, mode=mode, dtype=name),
                   got, eb.embedding_bag_plain(table, ids, mode), 1e-5)
    torch.cuda.synchronize()
    out = {"phase": "lm_parity", "seconds": time.perf_counter() - t0,
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32, "max_abs_err": max_err,
           "cases": cases}
    emit(out)
    return out


def set_cfg(model, **changes) -> None:
    """Replace fields of the config of the model and of every layer."""
    cfg = dataclasses.replace(model.cfg, **changes)
    for m in (model, *model.layers):
        m.cfg = cfg


def logit_gap(a, b) -> dict:
    d = (a - b).abs()
    return {"max_abs": float(d.max()), "mean_abs": float(d.mean()),
            "argmax_agree": float((a.argmax(-1) == b.argmax(-1)).float().mean()),
            "ref_std": float(b.std())}


def check_gap(gap: dict, what: str) -> None:
    check(gap["max_abs"] <= LOGIT_MAX_TOL and gap["mean_abs"] <= LOGIT_MEAN_TOL,
          f"{what}: logits differ by {gap} (tolerance max {LOGIT_MAX_TOL}, "
          f"mean {LOGIT_MEAN_TOL})")


def synced(fn):
    """(result, host seconds) of ``fn`` run to completion on the card."""
    torch.cuda.synchronize()
    ts = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - ts


def time_flash(fp, F, cfg, dev) -> dict:
    """flash_prefill at the forward's per-layer shape, beside its plain
    version and scaled_dot_product_attention (causal, GQA)."""
    g = torch.Generator(device=dev).manual_seed(5)
    B, S, KV, hd = 2, 4096, cfg.n_kv_heads, cfg.hd
    G = cfg.n_heads // KV
    q = seeded(g, (B, S, KV, G, hd), cfg.dtype, dev)
    k = seeded(g, (B, S, KV, hd), cfg.dtype, dev)
    v = seeded(g, (B, S, KV, hd), cfg.dtype, dev)
    qh = q.reshape(B, S, KV * G, hd).transpose(1, 2).contiguous()
    kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    lib = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, enable_gqa=True)
    lib_err = float((lib.transpose(1, 2).reshape(q.shape).float()
                     - fp.flash_prefill(q, k, v).float()).abs().max())
    out = {"shape": [B, S, KV, G, hd], "dtype": str(cfg.dtype),
           **timed("kernel", lambda: fp.flash_prefill(q, k, v)),
           **timed("plain", lambda: fp.flash_prefill_plain(q, k, v)),
           **timed("library", lambda: F.scaled_dot_product_attention(
               qh, kh, vh, is_causal=True, enable_gqa=True)),
           "library_vs_kernel_max_abs": lib_err}
    out.update(flash_bound(B, S, KV, G, hd, 0, q.element_size()))
    # the f32 route (the CUDA-core kernel) on the same values
    q32, k32, v32 = q.float(), k.float(), v.float()
    before = fp.TC_LAUNCHES
    out["f32_kernel_ms"] = time_ms(lambda: fp.flash_prefill(q32, k32, v32), reps=3)
    check(fp.TC_LAUNCHES == before, "flash_prefill f32 went to the tensor-core kernel")
    return out


def time_decode(da, F, q, k, v, lengths) -> dict:
    """decode_attention on a cache, beside its plain version and
    scaled_dot_product_attention with a length mask (GQA)."""
    B, KV, G, hd = q.shape
    T = k.shape[1]
    qh = q.reshape(B, KV * G, 1, hd)
    kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = (torch.arange(T, device=q.device)[None, :] < lengths[:, None])[:, None, None, :]
    lib = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, enable_gqa=True)
    lib_err = float((lib.reshape(q.shape).float()
                     - da.decode_attention(q, k, v, lengths).float()).abs().max())
    rows = int(lengths.clamp(0, T).sum())
    elt = q.element_size()
    out = {"shape": [B, KV, G, hd, T], "dtype": str(q.dtype),
           **timed("kernel", lambda: da.decode_attention(q, k, v, lengths)),
           **timed("plain", lambda: da.decode_attention_plain(q, k, v, lengths)),
           **timed("library", lambda: F.scaled_dot_product_attention(
               qh, kh, vh, attn_mask=mask, enable_gqa=True)),
           "library_vs_kernel_max_abs": lib_err}
    out.update(bound(4.0 * B * KV * G * hd * T, 2 * rows * KV * hd * elt + 2 * q.numel() * elt
                     + 4 * B, BF16_FLOPS_PER_S))
    return out


def phase_lm(TM, qwen2, fp, da, ops, F, counters, dev) -> dict:
    """qwen2-7b at full width in bf16: flash and torch-op forwards, then a
    few requests served by prefill and greedy decode steps."""
    t0 = time.perf_counter()
    cfg = qwen2.FULL
    stage_s = {}
    g = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        model, stage_s["init"] = synced(lambda: TM.Transformer(
            cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0)))
        n_params = sum(p.numel() for p in model.parameters())
        tokens = torch.randint(0, cfg.vocab, (2, 4096), generator=g, device=dev)
        # the main path: counters zeroed just before, read just after
        zero_counts(counters)
        set_cfg(model, use_flash_prefill=True)
        flash_logits, stage_s["forward_flash"] = synced(lambda: model(tokens))
        set_cfg(model, use_flash_prefill=False)
        torch_logits, stage_s["forward_torch_ops"] = synced(lambda: model(tokens))
        check(bool(torch.isfinite(flash_logits).all()), "flash forward: non-finite logits")
        check(flash_logits.shape == (*tokens.shape, cfg.vocab), "flash forward: logits malformed")
        forward_gap = logit_gap(flash_logits, torch_logits)
        del flash_logits, torch_logits
        check_gap(forward_gap, "forward flash vs torch ops")
        # serving: 4 prompts of 1,024 tokens, 16 greedy decode steps
        prompts = torch.randint(0, cfg.vocab, (4, 1024), generator=g, device=dev)
        (cache, lg), stage_s["prefill"] = synced(lambda: model.prefill(prompts, max_len=1040))
        step_logits, gen, decode_s = [lg], [lg.argmax(-1)], []
        for _ in range(16):
            (cache, lg), sec = synced(lambda: model.decode_step(cache, gen[-1]))
            decode_s.append(sec)
            step_logits.append(lg)
            gen.append(lg.argmax(-1))
        full = torch.cat([prompts, torch.stack(gen[:16], dim=1)], dim=1)
        ref, stage_s["forward_1040"] = synced(lambda: model(full))
        serve_gaps = [logit_gap(step_logits[i], ref[:, 1023 + i]) for i in range(17)]
        for i, gap in enumerate(serve_gaps):
            check_gap(gap, "prefill vs forward" if i == 0 else f"decode step {i} vs forward")
        del ref, step_logits
        # decode_attention on layer 0's cache, lengths = the cache index
        KV, G, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
        q = seeded(g, (4, KV, G, hd), cfg.dtype, dev)
        k0, v0 = cache["k"][0], cache["v"][0]
        lengths = torch.full((4,), cache["index"], dtype=torch.int32, device=dev)
        (dec, stage_s["decode_attention_op"]) = synced(
            lambda: ops.decode_attention(q, k0, v0, lengths))
        dec_err, ok = close_err(dec, da.decode_attention_plain(q, k0, v0, lengths), 2e-2)
        check(ok, f"decode_attention on the layer-0 cache: max err {dec_err}")
        launches = read_counts(counters)
        check(launches["flash_prefill"] > 0, "flash_prefill kernel not launched on the lm path")
        check(launches["flash_prefill_tc"] == launches["flash_prefill"] == cfg.n_layers,
              f"flash_prefill: {launches['flash_prefill_tc']} of {launches['flash_prefill']} "
              f"launches on the tensor-core kernel, expected all {cfg.n_layers}")
        check(launches["decode_attention"] > 0, "decode_attention kernel not launched")
        timings = {"flash_prefill": time_flash(fp, F, cfg, dev),
                   "decode_attention": time_decode(da, F, q, k0, v0, lengths)}
        del model, cache, k0, v0
        torch.cuda.empty_cache()
        # f32 at full width, 2 layers: the flash branch within 1e-4 of torch ops
        cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
        m32 = TM.Transformer(cfg32, device=dev, generator=torch.Generator(device=dev).manual_seed(2))
        t32 = torch.randint(0, cfg.vocab, (1, 1024), generator=g, device=dev)
        set_cfg(m32, use_flash_prefill=True)
        a = m32(t32)
        set_cfg(m32, use_flash_prefill=False)
        f32_err, ok = close_err(a, m32(t32), 1e-4)
        check(ok, f"f32 forward flash vs torch ops: max err {f32_err} beyond 1e-4")
        del m32, a
        torch.cuda.empty_cache()
    out = {"phase": "lm", "seconds": time.perf_counter() - t0, "config": cfg.name,
           "params": n_params, "dtype": str(cfg.dtype), "forward_tokens": list(tokens.shape),
           "forward_flash_vs_torch_ops": forward_gap,
           "logit_tol": {"max_abs": LOGIT_MAX_TOL, "mean_abs": LOGIT_MEAN_TOL},
           "serve": {"prompts": list(prompts.shape), "max_len": 1040, "decode_steps": 16,
                     "gaps_vs_forward": serve_gaps, "decode_step_s": decode_s,
                     "tokens_per_s": 4 * 16 / sum(decode_s)},
           "decode_attention_layer0_max_abs_err": dec_err,
           "f32_two_layer_flash_vs_torch_ops_max_abs": f32_err,
           "flash_prefill_tc_launches": launches["flash_prefill_tc"],
           "flash_prefill_f32_ms": timings["flash_prefill"]["f32_kernel_ms"],
           "forward_s": {"flash": stage_s["forward_flash"],
                         "torch_ops": stage_s["forward_torch_ops"]},
           "stage_s": stage_s, "launches": launches, "timings": timings,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(out)
    return out


def phase_bag(eb, ops, F, counters, dev) -> dict:
    """ops.embedding_bag at MIND's widths (src/repro/configs/mind.py: 2^26
    items x 64, history length 50), 4,096 bags with ~10% padding."""
    t0 = time.perf_counter()
    N, d, B, L = 2**26, 64, 4096, 50
    g = torch.Generator(device=dev).manual_seed(3)
    table = torch.randn((N, d), generator=g, device=dev)
    # ids below N - 1, the padding row F.embedding_bag is given below
    ids = torch.randint(0, N - 1, (B, L), generator=g, device=dev, dtype=torch.int32)
    ids[torch.rand((B, L), generator=g, device=dev) < 0.1] = -1
    setup_s = time.perf_counter() - t0
    # the main path: counters zeroed just before, read just after
    zero_counts(counters)
    got = {mode: ops.embedding_bag(table, ids, mode) for mode in ("mean", "sum")}
    torch.cuda.synchronize()
    launches = read_counts(counters)
    check(launches["embedding_bag"] > 0, "embedding_bag kernel not launched on the bag path")
    errs = {}
    for mode, out_ in got.items():
        check(out_.shape == (B, d) and bool(torch.isfinite(out_).all()), f"bag {mode}: malformed")
        errs[mode], ok = close_err(out_, eb.embedding_bag_plain(table, ids, mode), 1e-5)
        check(ok, f"bag {mode}: kernel vs plain max err {errs[mode]}")
    lib_ids = torch.where(ids < 0, N - 1, ids)
    lib = F.embedding_bag(lib_ids, table, mode="mean", padding_idx=N - 1)
    real = int((ids >= 0).sum())
    timing = {**timed("kernel", lambda: eb.embedding_bag(table, ids, "mean")),
              **timed("plain", lambda: eb.embedding_bag_plain(table, ids, "mean")),
              **timed("library", lambda: F.embedding_bag(lib_ids, table, mode="mean",
                                                         padding_idx=N - 1)),
              "library_vs_kernel_max_abs": float((lib - got["mean"]).abs().max()),
              "rows_read": real}
    timing.update(bound(float(real * d), real * d * 4 + B * L * 4 + B * d * 4, INT32_OPS_PER_S))
    del table, lib, lib_ids
    torch.cuda.empty_cache()
    out = {"phase": "bag", "seconds": time.perf_counter() - t0, "setup_s": setup_s,
           "table": [N, d], "bags": B, "bag_len": L, "padding_share": 1 - real / (B * L),
           "max_abs_err": errs, "launches": launches, "timing": timing}
    emit(out)
    return out


# the MoE LMs at full width, reduced depth (qwen3-moe: 4 MoE layers;
# deepseek-v2: 1 dense + 3 MoE), and MIND at its published widths
MOE_DEPTH = 4
MOE_FORWARD, MOE_PREFILL = (2, 4096), (4, 1024)
MOE_SERVE_PROMPTS, MOE_SERVE_STEPS = (4, 512), 16
MIND_CHECK_USERS, MIND_TOL = 64, 1e-4
# recsys_family's serve and retrieval cells: (users, candidates each, corpus)
MIND_CELLS = {"serve_p99": (512, 100, 0), "serve_bulk": (262_144, 100, 0),
              "retrieval_cand": (1, 0, 1 << 20)}


class RouteLog:
    """While active, wraps ``moe_dispatch_plan`` of the transformer module
    and keeps, per call (one per MoE layer and dispatch chunk), each
    token's K experts in ascending order and whether each was kept (under
    capacity): two [T, K] tensors on the card."""

    def __init__(self, TM):
        self.TM, self.plan_fn, self.calls = TM, TM.moe_dispatch_plan, []

    def __enter__(self):
        self.TM.moe_dispatch_plan = self.recorded
        return self

    def __exit__(self, *exc):
        self.TM.moe_dispatch_plan = self.plan_fn

    def recorded(self, x, router, cfg):
        plan = self.plan_fn(x, router, cfg)
        per_token = torch.argsort(plan.t_sorted, stable=True)
        self.calls.append((plan.e_sorted[per_token].view(-1, cfg.top_k),
                           plan.keep[per_token].view(-1, cfg.top_k)))
        return plan

    @contextlib.contextmanager
    def paused(self):
        """The plain ``moe_dispatch_plan`` for the timed passes: the model
        as served, without the wrapper's sort, gathers and kept tensors."""
        self.TM.moe_dispatch_plan = self.plan_fn
        try:
            yield
        finally:
            self.TM.moe_dispatch_plan = self.recorded

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return calls


def route_diffs(a: list, b: list) -> dict:
    """Two runs' routing over the same tokens: per MoE layer the number of
    tokens whose expert set differs (router flips) and of those whose kept
    flags differ at the same experts (a capacity drop moved by another
    token's flip); and the mask [T] of tokens either touched in any layer."""
    flips, drops = [], []
    touched = torch.zeros(a[0][0].shape[0], dtype=torch.bool, device=a[0][0].device)
    for (ea, ka), (eb, kb) in zip(a, b):
        f = (ea != eb).any(1)
        dk = (ka != kb).any(1) & ~f
        flips.append(int(f.sum()))
        drops.append(int(dk.sum()))
        touched |= f | dk
    return {"router_flips_per_layer": flips, "drop_changes_per_layer": drops,
            "tokens_touched": int(touched.sum())}, touched


def dropped_per_layer(calls: list) -> list:
    return [int((~keep).sum()) for _, keep in calls]


def logit_gap_unperturbed(got, want, touched, what: str) -> dict:
    """The logit gap over the rows no routing difference touched (checked
    at the lm phase's tolerance) and over all rows (reported)."""
    got, want = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    keep = ~touched.reshape(-1)
    check(int(keep.sum()) > 0, f"{what}: every row touched by a routing difference")
    gap = logit_gap(got[keep], want[keep])
    check_gap(gap, what)
    return {"checked_rows": int(keep.sum()), "rows": int(keep.numel()), "gap": gap,
            "gap_all_rows": logit_gap(got, want)}


def check_flip_share(per_layer: list, tokens: int, what: str) -> None:
    """Routing differences between two runs come from near-tied gates, so
    they are a small share of the first MoE layer's choices (the later
    layers add the tokens that an earlier difference already changed); a
    wrong route on one side would differ at most tokens."""
    check(per_layer[0] <= 0.1 * tokens,
          f"{what}: {per_layer[0]} of {tokens} tokens routed differently in the first MoE "
          f"layer ({per_layer} by layer)")


def serve_vs_forward(model, prompts, steps: int, log: RouteLog) -> dict:
    """Prefill ``prompts`` and decode ``steps`` greedy tokens, then one
    ``forward`` over the whole sequence: the prefill's last logits and each
    step's against the forward at the same position, over the rows whose
    token there no routing difference (flip or moved drop) touched in any
    layer.  Its times ("route_log_on") include the RouteLog wrapper in
    every MoE layer; :func:`serve_timed` gives the model's own."""
    B, S = prompts.shape
    St = S + steps
    (cache, lg), prefill_s = synced(lambda: model.prefill(prompts, max_len=St))
    pre_calls = log.take()
    step_logits, gen, decode_s, dec_calls = [lg], [lg.argmax(-1)], [], []
    for _ in range(steps):
        (cache, lg), sec = synced(lambda: model.decode_step(cache, gen[-1]))
        decode_s.append(sec)
        dec_calls.append(log.take())
        step_logits.append(lg)
        gen.append(lg.argmax(-1))
    full = torch.cat([prompts, torch.stack(gen[:steps], dim=1)], dim=1)
    ref = model(full)
    ref_calls = log.take()
    # per layer, the (row, position) tokens routed differently in the two runs
    touched = torch.zeros((B, St), dtype=torch.bool, device=prompts.device)
    per_layer = []
    for li, (fe, fk) in enumerate(ref_calls):
        fe, fk = fe.view(B, St, -1), fk.view(B, St, -1)
        pe, pk = pre_calls[li][0].view(B, S, -1), pre_calls[li][1].view(B, S, -1)
        diff = torch.zeros((B, St), dtype=torch.bool, device=prompts.device)
        diff[:, :S] = ((fe[:, :S] != pe) | (fk[:, :S] != pk)).any(-1)
        for i, calls in enumerate(dec_calls):
            de, dk = calls[li]
            diff[:, S + i] = ((fe[:, S + i] != de) | (fk[:, S + i] != dk)).any(-1)
        per_layer.append(int(diff.sum()))
        touched |= diff
    gaps = []
    for i in range(steps + 1):
        p = S - 1 + i   # the position whose next-token logits step i gives
        gaps.append(logit_gap_unperturbed(step_logits[i], ref[:, p], touched[:, p],
                                          "prefill vs forward" if i == 0
                                          else f"decode step {i} vs forward"))
    dropped = [dropped_per_layer(c) for c in (pre_calls, *dec_calls, ref_calls)]
    check(not any(any(d) for d in dropped), f"serve: assignments dropped {dropped}")
    check_flip_share(per_layer, B * St, "serve vs forward")
    return {"prompts": [B, S], "decode_steps": steps, "routing_differences_per_layer": per_layer,
            "route_log_on": {"prefill_s": prefill_s, "decode_step_s": decode_s,
                             "tokens_per_s": B * steps / sum(decode_s)},
            "rows_touched_by_step": [g["rows"] - g["checked_rows"] for g in gaps],
            "gaps_vs_forward": gaps}


def serve_timed(model, prompts, steps: int, log: RouteLog) -> dict:
    """The serve pass of :func:`serve_vs_forward` again with the RouteLog
    wrapper off, timed: prefill, each greedy decode step, tokens/s."""
    with log.paused():
        (cache, lg), prefill_s = synced(lambda: model.prefill(
            prompts, max_len=prompts.shape[1] + steps))
        tok, decode_s = lg.argmax(-1), []
        for _ in range(steps):
            (cache, lg), sec = synced(lambda: model.decode_step(cache, tok))
            decode_s.append(sec)
            tok = lg.argmax(-1)
    return {"prefill_s": prefill_s, "decode_step_s": decode_s,
            "tokens_per_s": prompts.shape[0] * steps / sum(decode_s)}


def boolean_moe_chunk(TM):
    """``_moe_ffn_chunk`` with the dispatch it had before the sync-free
    form: a store at the boolean-indexed kept assignments (``e_sorted[keep]``,
    ``pos_in_e[keep]``, ``x[t_sorted[keep]]``: a ``nonzero`` and a
    device-to-host sync each).  Kept here to time the two in one call."""
    def chunk(x, lp, cfg):
        T_, d = x.shape
        plan = TM.moe_dispatch_plan(x, lp.router, cfg)
        keep = plan.keep
        buf = x.new_zeros((cfg.n_experts, plan.capacity, d))
        buf[plan.e_sorted[keep], plan.pos_in_e[keep]] = x[plan.t_sorted[keep]]
        h = torch.nn.functional.silu(torch.bmm(buf, lp.we1)) * torch.bmm(buf, lp.we3)
        y_e = torch.bmm(h, lp.we2)
        contrib = y_e[torch.where(keep, plan.e_sorted, 0), torch.where(keep, plan.pos_in_e, 0)]
        contrib = contrib * (plan.gates * keep).to(contrib.dtype)[:, None]
        per_token = torch.argsort(plan.t_sorted, stable=True).view(T_, cfg.top_k)
        y = contrib[per_token[:, 0]]
        for j in range(1, cfg.top_k):
            y = y + contrib[per_token[:, j]]
        if cfg.n_shared_experts:
            y = y + TM.swiglu(x, lp.ws1, lp.ws3, lp.ws2)
        return y.to(x.dtype)

    return chunk


def dispatch_ab(TM, model, prompts, steps: int, log: RouteLog) -> dict:
    """The serve pass timed with the sync-free MoE dispatch and with the
    boolean-index form it replaced, in turns (new, old, old, new): each
    pass's median decode step and its last step's logits, equal between
    the two forms."""
    new_fn, old_fn = TM._moe_ffn_chunk, boolean_moe_chunk(TM)
    out = {"sync_free": [], "boolean_index": []}
    last = {}
    for name in ("sync_free", "boolean_index", "boolean_index", "sync_free"):
        TM._moe_ffn_chunk = new_fn if name == "sync_free" else old_fn
        try:
            r = serve_timed(model, prompts, steps, log)
            with log.paused():
                cache, lg = model.prefill(prompts, max_len=prompts.shape[1] + 1)
                last[name] = model.decode_step(cache, lg.argmax(-1))[1]
        finally:
            TM._moe_ffn_chunk = new_fn
        out[name].append(statistics.median(r["decode_step_s"]))
    check(torch.equal(last["sync_free"], last["boolean_index"]),
          "sync-free MoE dispatch: decode logits differ from the boolean-index form")
    return out


def decode_bound(model, cache_bytes: int) -> dict:
    """A decode step's least time: every layer's weights (all E experts:
    the step's products run over every expert, trap j), ``lm_head`` and the
    cache read once at the memory rate."""
    layer_bytes = sum(p.numel() * p.element_size() for p in model.layers.parameters())
    expert_bytes = sum(getattr(lay, n).numel() * getattr(lay, n).element_size()
                       for lay in model.layers if lay.kind == "moe" for n in ("we1", "we2", "we3"))
    head = model.lm_head.numel() * model.lm_head.element_size()
    nbytes = layer_bytes + head + cache_bytes
    return {"bytes": nbytes, "expert_bytes": expert_bytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "experts_only_bound_ms": expert_bytes / HBM_BYTES_PER_S * 1e3}


def layer_attention_check(TM, fp, model, tokens) -> dict:
    """Each layer's attention on the same hidden states (those of the
    torch-op forward): the flash branch and the torch-op branch, each
    against the exact f32 attention of the layer's bf16 q, k, v (the plain
    flash version on f32 copies, one kv head at a time), by
    :func:`row_scaled_err` at FLASH_BF16_REL."""
    cfg = model.cfg
    KV, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    x = model._embed(tokens)
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    out = {"flash": [], "torch_ops": []}
    for i, layer in enumerate(model.layers):
        h = TM.rms_norm(x, layer.ln_attn, cfg.norm_eps)
        q, k, v = layer.qkv(h, pos)
        q = q.reshape(B, S, KV, G, cfg.hd)
        got = {name: layer.attend(h, pos, flash=flash)[0].view(B, S, KV, G, cfg.hd)
               for name, flash in (("flash", True), ("torch_ops", False))}
        rel = dict.fromkeys(got, 0.0)
        for j in range(KV):
            sl = slice(j, j + 1)
            want = fp.flash_prefill_plain(q[:, :, sl].float(), k[:, :, sl].float(),
                                          v[:, :, sl].float(), cfg.sliding_window)
            for name, a in got.items():
                rel[name] = max(rel[name], row_scaled_err(a[:, :, sl], want))
            del want
        for name, r in rel.items():
            check(r <= FLASH_BF16_REL, f"layer {i}: {name} attention error {r} of the row "
                  f"rms beyond {FLASH_BF16_REL}")
            out[name].append(r)
        del q, k, v, h, got
        x = layer(x, pos)
    return out


def phase_lm_moe(TM, arch, fp, F, counters, dev) -> dict:
    """One MoE LM at full width with MOE_DEPTH layers in bf16 from a seeded
    init: forward 2 x 4,096 (GQA: with and without flash, each layer's
    attention, flash and torch ops, held against the exact f32 attention;
    MLA: blockwise torch ops), prefill
    4 x 1,024 against forward over exactly those prompts at the default
    capacity factor (the same drops), then a copy whose capacity covers
    every token serving 4 x 512 prompts with 16 greedy decode steps, each
    against forward (trap g).  Routing differences between two runs are
    counted (trap h) and the gaps checked on the rows none touched.  The
    forwards, the prefill and the serve pass are timed again with the
    RouteLog wrapper off."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(arch.FULL, n_layers=MOE_DEPTH)
    stage_s = {}
    g = torch.Generator(device=dev).manual_seed(21)
    out = {"phase": "lm_moe", "config": cfg.name, "layers": cfg.layer_kinds(),
           "dtype": str(cfg.dtype), "capacity_factor": cfg.capacity_factor}
    gqa = not cfg.is_mla
    with torch.no_grad(), RouteLog(TM) as log:
        model, stage_s["init"] = synced(lambda: TM.Transformer(
            cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0)))
        out["params"] = sum(p.numel() for p in model.parameters())
        out["param_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
        tokens = torch.randint(0, cfg.vocab, MOE_FORWARD, generator=g, device=dev)
        T = tokens.numel()
        # the main path: counters zeroed just before, read just after
        zero_counts(counters)
        set_cfg(model, use_flash_prefill=gqa)
        logits, stage_s["forward_flash" if gqa else "forward"] = synced(lambda: model(tokens))
        launches = read_counts(counters)
        main_calls = log.take()
        check(bool(torch.isfinite(logits).all()), "forward: non-finite logits")
        check(logits.shape == (*tokens.shape, cfg.vocab), "forward: logits malformed")
        out["dropped_per_layer_forward"] = dropped_per_layer(main_calls)
        want = cfg.n_layers if gqa else 0   # MLA never takes the flash branch
        check(launches["flash_prefill"] == launches["flash_prefill_tc"] == want,
              f"flash_prefill: {launches['flash_prefill_tc']} of {launches['flash_prefill']} "
              f"launches on the tensor-core kernel, expected {want}")
        if gqa:
            set_cfg(model, use_flash_prefill=False)
            torch_logits, stage_s["forward_torch_ops"] = synced(lambda: model(tokens))
            diffs, touched = route_diffs(main_calls, log.take())
            check_flip_share([f + d for f, d in zip(diffs["router_flips_per_layer"],
                                                    diffs["drop_changes_per_layer"])],
                             T, "forward flash vs torch ops")
            out["forward_flash_vs_torch_ops"] = {
                **diffs, **logit_gap_unperturbed(logits, torch_logits, touched,
                                                 "forward flash vs torch ops")}
            del torch_logits
            out["layer_attention_vs_f32"], stage_s["layer_attention_check"] = \
                synced(lambda: layer_attention_check(TM, fp, model, tokens))
            out["layer_attention_vs_f32"]["limit"] = FLASH_BF16_REL
            log.take()   # the routing of the check's own layer walk
        del logits
        # the timed passes run with the RouteLog wrapper off (the model as
        # served), each after its checked pass, which also paid one-time
        # set-up (allocator growth at these shapes)
        timed_s = {"forward": {}}
        with log.paused():
            for name, flash in ((("flash", True), ("torch_ops", False)) if gqa else
                                (("torch_ops", False),)):
                set_cfg(model, use_flash_prefill=flash)
                timed_s["forward"][name] = synced(lambda: model(tokens))[1]
        set_cfg(model, use_flash_prefill=False)
        # prefill at the default capacity against forward over the prompts
        prompts = torch.randint(0, cfg.vocab, MOE_PREFILL, generator=g, device=dev)
        (cache, lg), stage_s["prefill"] = synced(
            lambda: model.prefill(prompts, max_len=MOE_PREFILL[1]))
        pre_calls = log.take()
        ref, stage_s["forward_prompts"] = synced(lambda: model(prompts))
        diffs, touched = route_diffs(pre_calls, log.take())
        out["prefill_vs_forward"] = {
            **diffs, "dropped_per_layer": dropped_per_layer(pre_calls),
            **logit_gap_unperturbed(lg, ref[:, -1], touched.view(prompts.shape)[:, -1],
                                    "prefill vs forward (default capacity)")}
        del cache, ref
        with log.paused():
            timed_s["prefill"] = synced(
                lambda: model.prefill(prompts, max_len=MOE_PREFILL[1]))[1]
        torch.cuda.empty_cache()
        # the no-drop copy: capacity >= every token of a forward (trap g)
        set_cfg(model, capacity_factor=cfg.n_experts / cfg.top_k + 1.0)
        serve_prompts = torch.randint(0, cfg.vocab, MOE_SERVE_PROMPTS, generator=g, device=dev)
        out["serve_no_drop"] = serve_vs_forward(model, serve_prompts, MOE_SERVE_STEPS, log)
        out["serve_no_drop"]["capacity_factor"] = model.cfg.capacity_factor
        timed_s["serve_no_drop"] = serve_timed(model, serve_prompts, MOE_SERVE_STEPS, log)
        timed_s["decode_dispatch_ab"] = dispatch_ab(TM, model, serve_prompts, MOE_SERVE_STEPS,
                                                    log)
        B, St = MOE_SERVE_PROMPTS[0], MOE_SERVE_PROMPTS[1] + MOE_SERVE_STEPS
        width = cfg.mla_kv_lora + cfg.mla_rope_dim if cfg.is_mla else 2 * cfg.n_kv_heads * cfg.hd
        per_token = width * model.embed.element_size() * cfg.n_layers
        out["cache_bytes_per_token"] = per_token
        out["decode_bound"] = decode_bound(model, per_token * B * St)
        out["decode_bound"]["tokens_per_s"] = B / (out["decode_bound"]["bound_ms"] * 1e-3)
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        del model
        torch.cuda.empty_cache()
        if gqa:
            out["flash_timing"] = time_flash(fp, F, cfg, dev)
            # f32 at full width, 2 layers: the flash branch within 1e-4 of torch ops
            cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
            m32 = TM.Transformer(cfg32, device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(2))
            t32 = torch.randint(0, cfg.vocab, (1, 1024), generator=g, device=dev)
            set_cfg(m32, use_flash_prefill=True)
            a = m32(t32)
            a_calls = log.take()
            set_cfg(m32, use_flash_prefill=False)
            b = m32(t32)
            diffs, touched = route_diffs(a_calls, log.take())
            f32_err, ok = close_err(a[0][~touched], b[0][~touched], 1e-4)
            check(ok, f"f32 forward flash vs torch ops: max err {f32_err} beyond 1e-4")
            out["f32_two_layer_flash_vs_torch_ops"] = {"max_abs": f32_err, "tol": 1e-4, **diffs}
            del m32, a, b
            torch.cuda.empty_cache()
    # stage_s: the checked passes (RouteLog on); timed_s: the model as served
    out.update(seconds=time.perf_counter() - t0, launches=launches, stage_s=stage_s,
               timed_s=timed_s, logit_tol={"max_abs": LOGIT_MAX_TOL, "mean_abs": LOGIT_MEAN_TOL})
    emit(out)
    return out


def mind_batch(cfg, B: int, g, rng, zipf_rows, dev, candidates: int = 0,
               corpus: int = 0) -> dict:
    """A batch in ``recsys_family``'s layout: histories of a uniform length
    in 0 .. hist_len (the first 8 users none), uniform profile features,
    and ``candidates`` [B, C] or uniform ``candidate_ids`` [N]; history and
    candidate items drawn by ``workload/recsys.py``'s ``zipf_rows`` from the
    numpy generator ``rng``."""
    def items(shape):
        return torch.from_numpy(zipf_rows(rng, cfg.n_items, shape)).to(dev, torch.int32)

    lens = torch.randint(0, cfg.hist_len + 1, (B,), generator=g, device=dev)
    lens[:8] = 0
    batch = {"hist": items((B, cfg.hist_len)),
             "hist_mask": torch.arange(cfg.hist_len, device=dev)[None] < lens[:, None],
             "user_feats": torch.randint(0, cfg.n_user_feats, (B, cfg.user_feat_len),
                                         generator=g, device=dev, dtype=torch.int32)}
    if candidates:
        batch["candidates"] = items((B, candidates))
    if corpus:
        batch["candidate_ids"] = torch.randint(0, cfg.n_items, (corpus,), generator=g,
                                               device=dev, dtype=torch.int32)
    return batch


def mind_cpu_twin(RM, model, batch: dict, users: int):
    """The same port code on the CPU for the first ``users`` users: a MIND
    whose tables hold just the rows the batch reads (ids remapped), the
    dense weights copied."""
    sub = {k: (v if k == "candidate_ids" else v[:users]).cpu() for k, v in batch.items()}
    keys = [k for k in ("hist", "candidates", "candidate_ids") if k in sub]
    items, inv = torch.unique(torch.cat([sub[k].clamp_min(0).reshape(-1) for k in keys]),
                              return_inverse=True)
    feats, f_inv = torch.unique(sub["user_feats"].reshape(-1), return_inverse=True)
    cfg = dataclasses.replace(model.cfg, n_items=len(items), n_user_feats=len(feats))
    twin = RM.MIND(cfg, device="cpu")
    twin.item_embed.copy_(model.item_embed[items.to(model.item_embed.device)].cpu())
    twin.user_embed.copy_(model.user_embed[feats.to(model.user_embed.device)].cpu())
    for name in ("bilinear", "w_hidden", "b_hidden", "w_out", "b_out"):
        getattr(twin, name).copy_(getattr(model, name).cpu())
    parts = iter(torch.split(inv, [sub[k].numel() for k in keys]))
    for k in keys:
        sub[k] = next(parts).view(sub[k].shape).to(torch.int32)
    sub["user_feats"] = f_inv.view(sub["user_feats"].shape).to(torch.int32)
    return twin, sub


def phase_recsys(RM, mind, zipf_rows, counters, dev) -> dict:
    """MIND FULL in f32 (2^26 x 64 items, 2^20 x 64 user features):
    serve_score at serve_p99 (512 users x 100 candidates) and serve_bulk
    (262,144 x 100), retrieval_score at retrieval_cand (1 user x 2^20
    candidates); each held against the same port code on the CPU for the
    first 64 users at MIND_TOL, and timed."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = mind.FULL
    g = torch.Generator(device=dev).manual_seed(31)
    rng = np.random.default_rng(31)
    with torch.no_grad():
        model, init_s = synced(lambda: RM.MIND(cfg, device=dev,
                                               generator=torch.Generator(device=dev).manual_seed(0)))
        cells = {name: (mind_batch(cfg, users, g, rng, zipf_rows, dev, cands, corpus),
                        "serve_score" if cands else "retrieval_score")
                 for name, (users, cands, corpus) in MIND_CELLS.items()}
        setup_s = time.perf_counter() - t0
        # the main path: counters zeroed just before, read just after
        zero_counts(counters)
        results, call_s = {}, {}
        for name, (batch, fn) in cells.items():
            results[name], call_s[name] = synced(lambda: getattr(model, fn)(batch))
        launches = read_counts(counters)
        out = {"phase": "recsys", "config": cfg.name, "items": [cfg.n_items, cfg.embed_dim],
               "user_feats": [cfg.n_user_feats, cfg.embed_dim], "init_s": init_s,
               "setup_s": setup_s, "first_call_s": call_s, "launches": launches,
               "tol": MIND_TOL, "cells": {}}
        for name, (batch, fn) in cells.items():
            got = results[name]
            B = batch["hist"].shape[0]
            n_cand = batch["candidates"].shape[1] if "candidates" in batch \
                else batch["candidate_ids"].shape[0]
            check(got.shape == (B, n_cand) and bool(torch.isfinite(got).all()),
                  f"recsys {name}: scores malformed")
            users = min(B, MIND_CHECK_USERS)
            twin, sub = mind_cpu_twin(RM, model, batch, users)
            err, ok = close_err(got[:users].cpu(), getattr(twin, fn)(sub), MIND_TOL)
            check(ok, f"recsys {name}: card vs CPU max err {err} beyond {MIND_TOL}")
            rows = batch["hist"].numel() + (batch["candidates"].numel() if "candidates" in batch
                                            else n_cand * B)
            nbytes = (rows * cfg.embed_dim + batch["user_feats"].numel() * cfg.embed_dim) * 4 \
                + sum(v.numel() * v.element_size() for v in batch.values()) + got.numel() * 4
            out["cells"][name] = {
                "fn": fn, "users": B, "candidates": n_cand, "checked_users": users,
                "users_without_history": int((~batch["hist_mask"].any(1)).sum()),
                "max_abs_err_vs_cpu": err,
                **timed("call", lambda: getattr(model, fn)(batch)),
                "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
            del twin, sub
        del model, results, cells
        torch.cuda.empty_cache()
    out.update(seconds=time.perf_counter() - t0,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    emit(out)
    return out


# --- train -------------------------------------------------------------------
# the optimizers of the JAX package's family bundles (the port's bundles
# are a later slice): lm_family.py:23, gnn_family.py:27, recsys_family.py:21
def lm_opt(O):
    return O.AdamW(lr=O.cosine_schedule(3e-4, 2000, 100_000), weight_decay=0.1)


def gnn_opt(O):
    return O.AdamW(lr=O.cosine_schedule(1e-3, 100, 10_000), weight_decay=0.0)


def recsys_opt(O):
    return O.AdamW(lr=O.cosine_schedule(1e-3, 500, 50_000), weight_decay=0.0)


# qwen2-7b at full width: lm_family's train_4k sequence, depth and batch cut
# to fit one card (28 layers' parameters, gradients and AdamW state ~122 GB)
TRAIN_LM_DEPTH, TRAIN_LM_BATCH, TRAIN_LM_SEQ = 4, 8, 4096
TRAIN_LM_STEPS, TRAIN_LM_REPEAT_STEPS, TRAIN_LM_REPEAT_LR = 3, 8, 1e-4
# a rms-normed hidden state against an lm_head of N(0, 1/d) entries gives
# logits N(0, 1) over the vocabulary, so the first loss is ln V + 1/2
TRAIN_FIRST_LOSS_TOL = 0.05
TRAIN_REL_TOL = 1e-4          # card against CPU, f32 with TF32 off, per leaf
# gnn_family's cells (src/repro/configs/gnn_family.py:29-43) at FULL widths
GNN_TRAIN_CELLS = {"graphsage-reddit": "minibatch_lg", "graphcast": "full_graph_sm",
                   "egnn": "molecule", "schnet": "molecule"}
MIND_TRAIN_BATCH, MIND_TRAIN_ITEMS = 65_536, 1 << 24     # train_batch; table 2^26 -> 2^24
MIND_TRAIN_CHECK = (1_024, 1 << 20)                       # card = CPU at (B, items)


def lm_train_flops(TM, cfg, B: int, S: int) -> dict:
    """The step's operations: 6 x the matmul parameters x T (lm_head
    included, the embedding gather not), attention at full S^2 (QK and PV,
    forward and twice in the backward), plus the recompute: with remat one
    more forward of the layers per checkpoint level (two for blocks of
    more than one layer) and with a chunked head one more head forward."""
    T = B * S
    n = cfg.n_layers
    per_layer = sum(math.prod(s) for s in TM.layer_shapes(cfg).values() if len(s) == 2)
    head = cfg.d_model * cfg.vocab
    attn = 4.0 * B * S * S * cfg.n_heads * cfg.hd * n
    layers_fwd = 2.0 * per_layer * n * T + attn
    bk = max(k for k in range(1, min(cfg.remat_block, n) + 1) if n % k == 0)
    levels = (2 if bk > 1 else 1) if cfg.remat else 0
    chunked = bool(cfg.loss_chunk) and T > cfg.loss_chunk and T % cfg.loss_chunk == 0
    model = 3.0 * (layers_fwd + 2.0 * head * T)
    recompute = levels * layers_fwd + (2.0 * head * T if chunked else 0.0)
    return {"flops": model + recompute, "model_flops": model, "recompute_flops": recompute,
            "matmul_params": per_layer * n + head, "remat_levels": levels,
            "loss_chunks": T // cfg.loss_chunk if chunked else 1}


def leaf_errs(got: dict, want: dict) -> dict:
    """Per leaf max |got - want| over max |want| (both dict trees)."""
    out = {}
    for k, w in want.items():
        if isinstance(w, dict):
            out.update({f"{k}.{kk}": v for kk, v in leaf_errs(got[k], w).items()})
        else:
            w = w.detach().float().cpu()
            d = (got[k].detach().float().cpu() - w).abs().max()
            out[k] = float(d / w.abs().max().clamp_min(1e-30))
    return out


def loss_and_grads(O, loss_fn, params: dict):
    """(loss, gradient tree) of ``loss_fn()`` with respect to the leaves of
    the dict tree ``params``; a leaf the loss misses gets zeros."""
    leaves = O.adamw.tree_leaves(params)
    loss = loss_fn()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads))
    return loss.detach(), O.adamw.tree_map(lambda _: next(it), params)


def card_vs_cpu(O, card: tuple, cpu: tuple, what: str, tol: float | None = TRAIN_REL_TOL) -> dict:
    """``card`` and ``cpu``: (loss closure, its parameter tree) of the same
    code on the two devices; the loss and every gradient within ``tol`` of
    its largest entry (``None``: reported, not checked)."""
    loss_c, g_c = loss_and_grads(O, *card)
    loss_h, g_h = loss_and_grads(O, *cpu)
    errs = leaf_errs(g_c, g_h)
    loss_err = float((loss_c.cpu() - loss_h).abs() / loss_h.abs().clamp_min(1e-30))
    worst = max(errs, key=errs.get)
    check(torch.isfinite(loss_c).item(), f"{what}: non-finite loss")
    check(tol is None or (loss_err <= tol and errs[worst] <= tol),
          f"{what}: card vs CPU loss {loss_err}, gradient {worst} {errs[worst]} beyond {tol}")
    return {"loss": float(loss_c), "loss_rel_err": loss_err, "grad_rel_err_max": errs[worst],
            "worst_leaf": worst, "leaves": len(errs)}


def model_twin(build, model, dev):
    """A copy of ``model`` built by ``build(device)`` on ``dev`` holding
    the same weights."""
    twin = build(dev)
    twin.load_state_dict(model.state_dict())
    return twin


def train_lm_full(TM, qwen2, O, make_train_step, lm_batch_fn, shard_batch, counters,
                  dev) -> dict:
    """qwen2-7b at full width in bf16, TRAIN_LM_DEPTH layers, remat blocks
    of 4 with the inner per-layer checkpoint, the head in two 16,384-token
    chunks: TRAIN_LM_STEPS steps of lm_family's optimizer on the seeded
    batches, then TRAIN_LM_REPEAT_STEPS at a constant rate on one batch;
    per step the loss, norm, seconds, tokens/s, peak memory and FLOPs."""
    cfg = dataclasses.replace(qwen2.FULL, n_layers=TRAIN_LM_DEPTH)
    B, S = TRAIN_LM_BATCH, TRAIN_LM_SEQ
    model = TM.Transformer(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    params = dict(model.named_parameters())
    flops = lm_train_flops(TM, cfg, B, S)
    out = {"config": cfg.name, "layers": cfg.n_layers, "batch": [B, S], "dtype": str(cfg.dtype),
           "remat_block": cfg.remat_block, "loss_chunk": cfg.loss_chunk,
           "params": sum(p.numel() for p in params.values()), **flops,
           "bound_s": flops["flops"] / BF16_FLOPS_PER_S,
           "first_loss_want": math.log(cfg.vocab) + 0.5, "ln_vocab": math.log(cfg.vocab)}
    make = lm_batch_fn(cfg.vocab, B, S)

    # one set of AdamW moments for both runs, zeroed in place between them:
    # freeing and re-allocating 16 GB of f32 state fragments the allocator
    # enough that the next step's 3.5 GiB score block finds no room
    moments = lm_opt(O).init(params)

    def run(opt, batches, key):
        for t in (*moments.m.values(), *moments.v.values()):
            t.zero_()
        state = moments._replace(step=torch.zeros_like(moments.step))
        step = make_train_step(lambda p, b: TM.loss_fn(model, b["tokens"], b["labels"]), opt)
        rows = []
        for b in batches:
            batch = shard_batch(make(b), dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ts = time.perf_counter()
            _, state, m = step(params, state, batch)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            sec = time.perf_counter() - ts
            rows.append({"step": b, "loss": loss, "grad_norm": gnorm, "seconds": sec,
                         "tokens_per_s": B * S / sec, "tflops_per_s": flops["flops"] / sec / 1e12,
                         "bound_share": flops["flops"] / BF16_FLOPS_PER_S / sec,
                         "max_memory_allocated": torch.cuda.max_memory_allocated()})
            check(math.isfinite(loss) and math.isfinite(gnorm),
                  f"{key} step {b}: loss {loss}, grad norm {gnorm}")
        return rows

    # the main path: counters zeroed just before, read just after
    zero_counts(counters)
    out["steps"] = run(lm_opt(O), range(TRAIN_LM_STEPS), "lm_family optimizer")
    out["launches"] = read_counts(counters)
    check(out["launches"]["flash_prefill"] == 0, "flash_prefill launched on the training path")
    first = out["steps"][0]["loss"]
    check(abs(first - out["first_loss_want"]) <= TRAIN_FIRST_LOSS_TOL,
          f"first loss {first}: not within {TRAIN_FIRST_LOSS_TOL} of ln V + 1/2 = "
          f"{out['first_loss_want']}")
    out["repeat"] = run(O.AdamW(lr=TRAIN_LM_REPEAT_LR, weight_decay=0.1),
                        [0] * TRAIN_LM_REPEAT_STEPS, f"constant lr {TRAIN_LM_REPEAT_LR}")
    check(out["repeat"][-1]["loss"] < out["repeat"][0]["loss"],
          f"repeated batch: loss {out['repeat'][0]['loss']} -> {out['repeat'][-1]['loss']}")
    del moments
    # the flash kernel has no backward: under grad the model refuses it
    set_cfg(model, use_flash_prefill=True)
    small = shard_batch(lm_batch_fn(cfg.vocab, 1, 128)(0), dev)
    try:
        TM.loss_fn(model, small["tokens"], small["labels"])
        out["flash_under_grad"] = "ran"
    except RuntimeError as err:
        out["flash_under_grad"] = f"raised: {err}"
    check(out["flash_under_grad"].startswith("raised") and "no backward" in out["flash_under_grad"],
          f"flash_prefill under grad: {out['flash_under_grad']}")
    del model, params
    torch.cuda.empty_cache()
    return out


def train_lm_parity(TM, C, O, dev) -> dict:
    """f32 with TF32 off: qwen2 at 2 layers and d_model 448 (its other
    widths full; remat blocks of 2, blockwise attention, a chunked head)
    and the SMOKE qwen3-moe and deepseek-v2 (MoE, MLA): loss and every
    gradient on the card against the CPU within TRAIN_REL_TOL; on the card,
    the loss and gradients with remat off and with the head unchunked."""
    out = {}
    narrow = dataclasses.replace(C.qwen2_7b.FULL, n_layers=2, d_model=448, dtype=torch.float32,
                                 remat_block=2, blockwise_from=256, attn_block_q=256,
                                 loss_chunk=512)
    cases = {"qwen2-narrow": (narrow, (2, 512)),
             "qwen3-moe-smoke": (C.qwen3_moe_235b_a22b.SMOKE, (4, 128)),
             "deepseek-v2-smoke": (C.deepseek_v2_236b.SMOKE, (4, 128))}
    for name, (cfg, (B, S)) in cases.items():
        cpu = TM.Transformer(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
        card = model_twin(lambda d: TM.Transformer(cfg, device=d), cpu, dev)
        rng = np.random.default_rng(4)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
        labels = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
        labels[0, :5] = -1

        def case(model):
            d = next(model.parameters()).device
            return (lambda: TM.loss_fn(model, toks.to(d), labels.to(d)),
                    dict(model.named_parameters()))

        res = card_vs_cpu(O, case(card), case(cpu), name)
        ref_loss, ref_g = loss_and_grads(O, *case(card))
        for variant, change in (("remat_off", dict(remat=False)),
                                ("unchunked", dict(loss_chunk=0))):
            other = model_twin(lambda d: TM.Transformer(dataclasses.replace(cfg, **change),
                                                        device=d), card, dev)
            loss_o, g_o = loss_and_grads(O, *case(other))
            errs = leaf_errs(g_o, ref_g)
            loss_err = float((loss_o - ref_loss).abs() / ref_loss.abs())
            check(loss_err <= TRAIN_REL_TOL and max(errs.values()) <= TRAIN_REL_TOL,
                  f"{name} {variant}: loss {loss_err}, gradients {max(errs.values())}")
            res[variant] = {"loss_rel_err": loss_err, "grad_rel_err_max": max(errs.values())}
            del other
        out[name] = {"layers": cfg.n_layers, "d_model": cfg.d_model, "tokens": [B, S], **res}
        del cpu, card
        torch.cuda.empty_cache()
    return out


def gnn_train_batch(cfg, cell: str, rng, graph=None, gnn_batch_fn=None) -> dict:
    """A host batch of ``cell`` (gnn_family's shapes) from the numpy
    generator ``rng``: the fan-out blocks of the port's sampler for
    minibatch_lg, a random graph for full_graph_sm (cora-sized), 128
    graphs of 30 nodes and 64 edges with float targets for molecule."""
    if cell == "minibatch_lg":
        return gnn_batch_fn(graph, (15, 10), 1024, cfg.d_in, cfg.n_classes)(0)
    if cell == "full_graph_sm":
        N, E = 2708, 10556
        return {"x": rng.standard_normal((N, cfg.d_in), dtype=np.float32),
                "senders": rng.integers(0, N, E).astype(np.int32),
                "receivers": rng.integers(0, N, E).astype(np.int32),
                "edge_feat": rng.standard_normal((E, 4), dtype=np.float32),
                "labels": rng.integers(0, cfg.n_classes, N).astype(np.int32)}
    B, n, e = 128, 30, 64
    return {"x": rng.standard_normal((B, n, cfg.d_in), dtype=np.float32),
            "senders": rng.integers(0, n, (B, e)).astype(np.int32),
            "receivers": rng.integers(0, n, (B, e)).astype(np.int32),
            "pos": rng.standard_normal((B, n, 3), dtype=np.float32),
            "labels": rng.standard_normal(B, dtype=np.float32)}


# gnn_family's cell widths: (input features, classes), as cfg_for_cell sets them
GNN_CELL_WIDTHS = {"minibatch_lg": (602, 41), "full_graph_sm": (1433, 7), "molecule": (32, 1)}
# graphcast's 16 residual interaction layers with sum aggregation grow the
# random-init activations to a loss ~1e5 and a gradient norm ~1e7; in f32
# the card's and the CPU's summation orders then differ by up to ~5e-3 of
# a leaf's largest gradient.  Its card = CPU check runs in f64, where the
# same code must agree within TRAIN_REL_TOL; the f32 errors are printed
GNN_F64_CHECK = ("graphcast",)


def train_gnn(G, GNN_CONFIGS, O, make_train_step, gnn_batch_fn, ogb_like, shard_batch,
              dev) -> dict:
    """One step of each GNN arch on its gnn_family cell at FULL widths
    (d_in and n_classes from the cell): loss, seconds, peak memory; the
    loss and every gradient on the card against the CPU first."""
    out = {}
    rng = np.random.default_rng(41)
    ts = time.perf_counter()
    graph = ogb_like(232_965, mean_deg=50)
    out["reddit_graph_s"] = time.perf_counter() - ts
    for name, cell in GNN_TRAIN_CELLS.items():
        d_in, classes = GNN_CELL_WIDTHS[cell]
        cfg = dataclasses.replace(GNN_CONFIGS[name].FULL, d_in=d_in, n_classes=classes)
        host = gnn_train_batch(cfg, cell, rng, graph, gnn_batch_fn)
        batch = shard_batch(host, dev)
        params = G.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        f64 = name in GNN_F64_CHECK

        def on_both(cfg, card_params, tol):
            cpu_params = O.adamw.tree_map(lambda t: t.detach().cpu().requires_grad_(),
                                          card_params)
            return card_vs_cpu(O, (lambda: G.loss_fn(card_params, batch, cfg), card_params),
                               (lambda: G.loss_fn(cpu_params, host, cfg), cpu_params),
                               f"{name} {cell} {cfg.dtype}", tol)

        res = on_both(cfg, params, None if f64 else TRAIN_REL_TOL)
        if f64:
            p64 = O.adamw.tree_map(lambda t: t.detach().double().requires_grad_(), params)
            res["f64"] = on_both(dataclasses.replace(cfg, dtype=torch.float64), p64,
                                 TRAIN_REL_TOL)
            del p64
        step = make_train_step(lambda p, b: G.loss_fn(p, b, cfg), gnn_opt(O))
        state = gnn_opt(O).init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, state, m = step(params, state, batch)
        loss = float(m["loss"])
        sec = time.perf_counter() - t0
        check(math.isfinite(loss), f"{name} {cell}: loss {loss}")
        out[name] = {"cell": cell, "layers": cfg.n_layers, "d_hidden": cfg.d_hidden,
                     "d_in": d_in, "classes": classes, "loss": loss,
                     "grad_norm": float(m["grad_norm"]), "step_s": sec,
                     "max_memory_allocated": torch.cuda.max_memory_allocated(),
                     "params": sum(x.numel() for v in params.values() for x in v.values()),
                     "card_vs_cpu": res}
        del params, state, batch
        torch.cuda.empty_cache()
    return out


def mind_train_batch(cfg, B: int, g, rng, zipf_rows, dev) -> dict:
    batch = mind_batch(cfg, B, g, rng, zipf_rows, dev)
    batch["target"] = torch.from_numpy(zipf_rows(rng, cfg.n_items, (B,))).to(dev, torch.int32)
    return batch


def train_mind(RM, mind, O, make_train_step, zipf_rows, dev) -> dict:
    """One step of recsys_family's optimizer at train_batch (B = 65,536,
    FULL widths, the item table cut to 2^24 rows), targets and histories
    by zipf_rows: seconds and peak memory; then card = CPU on loss and
    gradients at B = 1,024 over 2^20 items."""
    g = torch.Generator(device=dev).manual_seed(51)
    rng = np.random.default_rng(51)
    cfg = dataclasses.replace(mind.FULL, n_items=MIND_TRAIN_ITEMS)
    torch.cuda.reset_peak_memory_stats()
    model = RM.MIND(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    batch = mind_train_batch(cfg, MIND_TRAIN_BATCH, g, rng, zipf_rows, dev)
    params = dict(model.named_parameters())
    opt = recsys_opt(O)
    state = opt.init(params)
    step = make_train_step(lambda p, b: RM.loss_fn(model, b), opt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, state, m = step(params, state, batch)
    loss = float(m["loss"])
    sec = time.perf_counter() - t0
    check(math.isfinite(loss), f"MIND train_batch: loss {loss}")
    out = {"config": cfg.name, "items": [cfg.n_items, cfg.embed_dim], "batch": MIND_TRAIN_BATCH,
           "loss": loss, "ln_batch": math.log(MIND_TRAIN_BATCH), "grad_norm": float(m["grad_norm"]),
           "step_s": sec, "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del model, batch, params, state
    torch.cuda.empty_cache()
    B, items = MIND_TRAIN_CHECK
    small = dataclasses.replace(mind.FULL, n_items=items)
    cpu = RM.MIND(small, device="cpu", generator=torch.Generator().manual_seed(5))
    card = model_twin(lambda d: RM.MIND(small, device=d), cpu, dev)
    batch = mind_train_batch(small, B, g, rng, zipf_rows, dev)
    host = {k: v.cpu() for k, v in batch.items()}
    out["card_vs_cpu"] = card_vs_cpu(
        O, (lambda: RM.loss_fn(card, batch), dict(card.named_parameters())),
        (lambda: RM.loss_fn(cpu, host), dict(cpu.named_parameters())),
        f"MIND B={B} items={items}")
    out["card_vs_cpu"].update(batch=B, items=items)
    del cpu, card, batch
    torch.cuda.empty_cache()
    return out


def train_restart(train_lm, dev) -> dict:
    """train_lm on qwen2-7b's SMOKE config on the card: uninterrupted, then
    with checkpoints every 2 steps and a failure after step 5, then
    restarted from the latest checkpoint: its losses must equal the
    uninterrupted run's from the restored step on, exactly."""
    kw = dict(steps=10, batch=8, seq=32, log_every=100, device=dev)
    full = train_lm("qwen2-7b", **kw)
    build_dir = pathlib.Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as ck:
        try:
            train_lm("qwen2-7b", ckpt_dir=ck, ckpt_every=2, fail_at=5, **kw)
            failed = False
        except RuntimeError as err:
            failed = "injected failure" in str(err)
        again = train_lm("qwen2-7b", ckpt_dir=ck, ckpt_every=2, **kw)
    start = again["restored_from"]
    check(failed and start == 4, f"train_lm drill: failed {failed}, restored from {start}")
    check(again["losses"] == full["losses"][start:],
          f"train_lm restart: losses {again['losses']} vs {full['losses'][start:]}")
    return {"losses": full["losses"], "restored_from": start,
            "restarted_losses": again["losses"], "equal": True}


# the mesh_train phase: the train phase's qwen2-7b run on a 1 x 1 NCCL
# mesh (a world of one in this process)
MESH_TRAIN_STEPS = TRAIN_LM_STEPS
MESH_DRILL_LAYERS, MESH_DRILL_BATCH, MESH_DRILL_SEQ = 2, 2, 512   # as the launch phase's drill
MESH_AGG_NODES, MESH_AGG_EDGES, MESH_AGG_WIDTH = 250_000, 1_000_000, 128


def mesh_lm_full(TM, qwen2, O, lm_batch_fn, shard_batch, counters, ranks: list,
                 steps: int) -> dict:
    """train_lm_full's first ``steps`` steps (the same config, seed,
    batches and optimizer) on the ("data", "model") mesh over ``ranks``:
    the parameters and AdamW moments DTensors placed by param_specs, the
    batch rows over "data"; per step the loss, norm, seconds and peak
    memory; the kernels' counters zeroed just before and read just after."""
    from torch import nn

    from repro_torch.launch.elastic import build_for_devices
    from repro_torch.launch.train import BATCH_SPECS
    from repro_torch.models.parallel import mesh_device, shard_tensor

    cfg = dataclasses.replace(qwen2.FULL, n_layers=TRAIN_LM_DEPTH)
    B, S = TRAIN_LM_BATCH, TRAIN_LM_SEQ
    mesh, ps, _, _, step = build_for_devices(cfg, ranks, lm_opt(O))
    dev = mesh_device(mesh)
    model = TM.Transformer(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    params = {name: nn.Parameter(shard_tensor(p.detach(), mesh, ps[name].spec))
              for name, p in model.named_parameters()}
    del model
    state = lm_opt(O).init(params)
    make = lm_batch_fn(cfg.vocab, B, S)
    rows = []
    zero_counts(counters)
    for b in range(steps):
        batch = shard_batch(make(b), mesh, BATCH_SPECS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ts = time.perf_counter()
        _, state, m = step(params, state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        rows.append({"step": b, "loss": loss, "grad_norm": gnorm,
                     "seconds": time.perf_counter() - ts,
                     "max_memory_allocated": torch.cuda.max_memory_allocated()})
        check(math.isfinite(loss) and math.isfinite(gnorm),
              f"mesh step {b}: loss {loss}, grad norm {gnorm}")
    launches = read_counts(counters)
    del params, state
    torch.cuda.empty_cache()
    return {"config": cfg.name, "layers": cfg.n_layers, "batch": [B, S],
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "steps": rows,
            "launches": launches}


def mesh_agg_check(G, dev) -> dict:
    """The GNN's split aggregation (``SplitGraph.agg``: each rank's edges
    summed into its node rows, gathered whole) on the 1 x 1 mesh against
    the dense aggregation, sum and mean, values and gradients, in f64."""
    from repro_torch.launch.mesh import make_host_mesh

    g = torch.Generator(device=dev).manual_seed(11)
    N, E, d = MESH_AGG_NODES, MESH_AGG_EDGES, MESH_AGG_WIDTH
    msgs = torch.randn(E, d, generator=g, device=dev, dtype=torch.float64).requires_grad_()
    recv = torch.randint(0, N, (E,), generator=g, device=dev)
    w = torch.randn(N, d, generator=g, device=dev, dtype=torch.float64)
    sp = G.SplitGraph(make_host_mesh())
    out = {"nodes": N, "edges": E, "width": d}
    for kind in ("sum", "mean"):
        got = sp.full(sp.agg(sp.rows(msgs), sp.rows(recv), N, kind), N)
        want = G._agg_dense(msgs, recv, N, kind)
        g_got, = torch.autograd.grad((got * w).sum(), msgs)
        g_want, = torch.autograd.grad((want * w).sum(), msgs)
        out[kind] = {"max_abs_err": float((got - want).detach().abs().max()),
                     "grad_max_abs_err": float((g_got - g_want).abs().max())}
        check(torch.allclose(got, want, atol=1e-12, rtol=1e-12)
              and torch.allclose(g_got, g_want, atol=1e-12, rtol=1e-12),
              f"split aggregation ({kind}) on the 1 x 1 mesh: {out[kind]}")
    return out


def phase_mesh_train(TM, G, C, O, lm_batch_fn, shard_batch, counters, train_lm_out,
                     dev) -> dict:
    """The training path on a mesh: on this card a world-1 NCCL group and
    its 1 x 1 mesh, the train phase's qwen2-7b run (losses and norms equal
    to its one-device ones bit for bit), elastic_drill through the mesh
    (bit-exact; the launch phase runs the same drill on one device), the
    GNN's split aggregation against dense in f64, and compressed_psum
    over the group equal to the no-group result."""
    import torch.distributed as dist

    from repro_torch.launch.elastic import elastic_drill
    from repro_torch.launch.mesh import init_ranks

    t0 = time.perf_counter()
    out = {"phase": "mesh_train", "card": gpu_name_and_power()}
    parts = {}
    ts = time.perf_counter()
    init_ranks("cuda")
    check(dist.get_world_size() == 1 and dist.get_backend() == "nccl",
          f"mesh_train: world {dist.get_world_size()} over {dist.get_backend()}")
    parts["init"] = time.perf_counter() - ts
    try:
        ts = time.perf_counter()
        lm = mesh_lm_full(TM, C.qwen2_7b, O, lm_batch_fn, shard_batch, counters, [0],
                          MESH_TRAIN_STEPS)
        parts["lm"] = time.perf_counter() - ts
        one = train_lm_out["steps"][:MESH_TRAIN_STEPS]
        for got, want in zip(lm["steps"], one):
            got["one_device_seconds"] = want["seconds"]
            got["one_device_max_memory_allocated"] = want["max_memory_allocated"]
        lm["bit_equal"] = all(a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
                              for a, b in zip(lm["steps"], one))
        check(lm["bit_equal"] and len(lm["steps"]) == len(one),
              f"1 x 1 mesh losses {[r['loss'] for r in lm['steps']]} / norms "
              f"{[r['grad_norm'] for r in lm['steps']]} vs one device "
              f"{[r['loss'] for r in one]} / {[r['grad_norm'] for r in one]}")
        check(all(v == 0 for v in lm["launches"].values()),
              f"a kernel launched on the mesh training path: {lm['launches']}")
        out["lm"] = lm
        ts = time.perf_counter()
        dcfg = dataclasses.replace(C.qwen2_7b.FULL, n_layers=MESH_DRILL_LAYERS)
        drill = elastic_drill(dcfg, 3, 3, batch=MESH_DRILL_BATCH, seq=MESH_DRILL_SEQ, seed=0,
                              device=dev, ranks=[0])
        check(drill["bit_exact"], f"elastic drill on the 1 x 1 mesh: {drill}")
        out["drill"] = drill
        parts["drill"] = time.perf_counter() - ts
        ts = time.perf_counter()
        out["agg"] = mesh_agg_check(G, dev)
        parts["agg"] = time.perf_counter() - ts
        x = torch.randn(1 << 22, generator=torch.Generator(device=dev).manual_seed(12),
                        device=dev)
        out["psum_equal"] = bool(torch.equal(O.compressed_psum(x, group=dist.group.WORLD),
                                             O.compressed_psum(x)))
        check(out["psum_equal"], "compressed_psum over the world-1 NCCL group differs from "
                                 "the no-group result")
    finally:
        dist.destroy_process_group()
    out.update(seconds=time.perf_counter() - t0, part_s=parts)
    emit(out)
    return out


MESH_SERVE_LAYERS = 4


def mesh_serve_lm(TM, C, counters, mesh, dev) -> dict:
    """qwen2-7b (MESH_SERVE_LAYERS layers, bf16) served on one device (after
    a warm-up run), then on ``mesh`` with the same parameters placed by the
    decode_32k layout: prefill 4 x 1,024 into 1,040 slots, 16 decode steps
    fed the one-device greedy tokens; logits and cache compared bit for
    bit."""
    from repro_torch.models.parallel import MeshParallel, P, local, place_tree

    cfg = dataclasses.replace(C.qwen2_7b.FULL, n_layers=MESH_SERVE_LAYERS)
    bundle = C.get_arch("qwen2-7b")
    (pspecs, cspecs, bspecs), _ = bundle.shardings("decode_32k")
    g = torch.Generator(device=dev).manual_seed(41)
    model = TM.Transformer(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab, (4, 1024), generator=g, device=dev)

    def serve(m, prompts, feed=None):
        steps, secs = [], []
        (cache, lg), sec = synced(lambda: m.prefill(prompts, max_len=1040))
        steps.append(local(lg))
        secs.append(sec)
        picks = []
        for i in range(16):
            tok = lg.argmax(-1) if feed is None else feed[i]
            picks.append(tok)
            (cache, lg), sec = synced(lambda: m.decode_step(cache, tok))
            steps.append(local(lg))
            secs.append(sec)
        return steps, cache, picks, secs

    with torch.no_grad():
        serve(model, prompts)   # warm-up: the first calls' library set-up out of the times
        one, one_cache, picks, one_s = serve(model, prompts)
        params = dict(model.named_parameters())
        placed = place_tree(params, {n: pspecs[n] for n in params}, mesh)
        mesh_model = TM.Transformer(cfg, params=placed, par=MeshParallel(mesh))
        # the prompts' rows split as the decode cell's tokens are
        placed_prompts = place_tree(prompts, P(bspecs["tokens"][0], None), mesh)
        zero_counts(counters)
        got, cache, _, mesh_s = serve(mesh_model, local(placed_prompts), picks)
        launches = read_counts(counters)
    logits_equal = [bool(torch.equal(a, b)) for a, b in zip(got, one)]
    cache_equal = {k: bool(torch.equal(local(cache[k]), one_cache[k])) for k in ("k", "v")}
    check(all(logits_equal) and all(cache_equal.values()) and
          cache["index"] == one_cache["index"],
          f"mesh_serve qwen2-7b: logits equal {logits_equal}, cache equal {cache_equal}")
    check(all(v == 0 for v in launches.values()),
          f"mesh_serve qwen2-7b: a kernel launched: {launches}")
    check(all(bool(torch.isfinite(x).all()) for x in got), "mesh_serve qwen2-7b: non-finite")
    out = {"config": f"{cfg.name} ({cfg.n_layers} layers, {cfg.dtype})",
           "layout": {"params": "decode_32k", "cache": str(cspecs["k"]),
                      "tokens": str(bspecs["tokens"])},
           "mesh": list(mesh.shape), "prompts": [4, 1024], "max_len": 1040, "decode_steps": 16,
           "logits_bit_equal": all(logits_equal), "cache_bit_equal": cache_equal,
           "prefill_s": mesh_s[0], "one_device_prefill_s": one_s[0],
           "decode_step_s": mesh_s[1:], "one_device_decode_step_s": one_s[1:],
           "launches": launches}
    del model, mesh_model, params, placed, one, got, cache, one_cache
    torch.cuda.empty_cache()
    return out


def mesh_serve_mind(RM, C, mind, zipf_rows, counters, mesh, dev) -> dict:
    """MIND FULL at serve_p99 on one device (after a warm-up call), then on
    ``mesh`` with the same tables placed by the cell's layout; scores
    compared bit for bit."""
    from repro_torch.models.parallel import MeshParallel, local, place_tree

    cfg = mind.FULL
    (pspecs, bspecs), _ = C.get_arch("mind").shardings("serve_p99")
    g = torch.Generator(device=dev).manual_seed(43)
    rng = np.random.default_rng(43)
    with torch.no_grad():
        model = RM.MIND(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        users, cands, _ = MIND_CELLS["serve_p99"]
        batch = mind_batch(cfg, users, g, rng, zipf_rows, dev, cands)
        model.serve_score(batch)   # warm-up
        one, one_s = synced(lambda: model.serve_score(batch))
        params = dict(model.named_parameters())
        placed = place_tree(params, pspecs, mesh)
        pbatch = place_tree(batch, bspecs, mesh)
        mesh_model = RM.MIND(cfg, params=placed, par=MeshParallel(mesh))
        zero_counts(counters)
        got, mesh_s = synced(lambda: local(mesh_model.serve_score(pbatch)))
        launches = read_counts(counters)
    equal = bool(torch.equal(got, one))
    check(equal, f"mesh_serve mind: scores differ, max {float((got - one).abs().max())}")
    check(all(v == 0 for v in launches.values()), f"mesh_serve mind: a kernel launched: "
                                                   f"{launches}")
    out = {"config": cfg.name, "cell": "serve_p99", "users": users, "candidates": cands,
           "layout": {k: str(v) for k, v in pspecs.items()}, "scores_bit_equal": equal,
           "seconds": mesh_s, "one_device_seconds": one_s, "launches": launches}
    del model, mesh_model, params, placed, batch, pbatch, one, got
    torch.cuda.empty_cache()
    return out


def phase_mesh_serve(TM, RM, C, mind, zipf_rows, counters, dev) -> dict:
    """Serving on a mesh: a world-1 NCCL group and its 1 x 1 mesh, qwen2-7b's
    prefill and decode and MIND's serve_p99 bit-equal to one device."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    out = {"phase": "mesh_serve", "card": gpu_name_and_power()}
    mesh = make_host_mesh(device="cuda")
    check(dist.get_world_size() == 1 and dist.get_backend() == "nccl",
          f"mesh_serve: world {dist.get_world_size()} over {dist.get_backend()}")
    try:
        out["lm"] = mesh_serve_lm(TM, C, counters, mesh, dev)
        out["mind"] = mesh_serve_mind(RM, C, mind, zipf_rows, counters, mesh, dev)
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


def phase_train(TM, RM, G, C, O, make_train_step, train_lm, lm_batch_fn, gnn_batch_fn,
                shard_batch, ogb_like, zipf_rows, counters, dev) -> dict:
    """The training path: qwen2-7b at full width, card = CPU at narrow f32
    widths (dense, MoE, MLA) with the remat and loss_chunk equivalences,
    the four GNNs on their cells, MIND's train_batch, and train_lm's
    failure drill.  The mesh_train phase runs right after the qwen2-7b
    run, before the other parts fragment the card's memory, and prints
    its own line."""
    t0 = time.perf_counter()
    out = {"phase": "train"}
    parts = {}
    ts = time.perf_counter()
    out["lm"] = train_lm_full(TM, C.qwen2_7b, O, make_train_step, lm_batch_fn, shard_batch,
                              counters, dev)
    parts["lm"] = time.perf_counter() - ts
    ts = time.perf_counter()
    phase_mesh_train(TM, G, C, O, lm_batch_fn, shard_batch, counters, out["lm"], dev)
    parts["mesh_train"] = time.perf_counter() - ts
    for key, fn in (("lm_parity", lambda: train_lm_parity(TM, C, O, dev)),
                    ("gnn", lambda: train_gnn(G, C.GNN_CONFIGS, O, make_train_step,
                                              gnn_batch_fn, ogb_like, shard_batch, dev)),
                    ("mind", lambda: train_mind(RM, C.mind, O, make_train_step, zipf_rows, dev)),
                    ("restart", lambda: train_restart(train_lm, dev))):
        ts = time.perf_counter()
        out[key] = fn()
        parts[key] = time.perf_counter() - ts
    out.update(seconds=time.perf_counter() - t0, part_s=parts)
    emit(out)
    return out


# the launch phase: host processes counting the dry-run's cells (on meta)
# while the card runs the serve drives, the smoke steps and the drill
DRYRUN_WORKERS = 6
# pod cells counted per rank on the production meshes (launch.dryrun
# --mesh single / multi), first in the pool
POD_CELLS = [("qwen2-7b", "prefill_32k", "single"), ("deepseek-v2-236b", "decode_32k", "multi"),
             ("graphsage-reddit", "minibatch_lg", "single"), ("mind", "retrieval_cand", "multi")]
KERNEL_MODULES = ("path_latency", "routed_walk", "provision_update", "flash_prefill",
                  "decode_attention", "embedding_bag", "prune_walk")


def pod_cell_row(cell) -> dict:
    """A pod cell's dry-run row, counted in this worker process, with the
    launches every kernel counter of the port read in it."""
    import importlib

    from repro_torch.launch import dryrun

    mods = [importlib.import_module(f"repro_torch.kernels.{m}") for m in KERNEL_MODULES]
    counters = [(m, name) for m in mods for name in ("LAUNCHES", "SCORED_LAUNCHES", "TC_LAUNCHES")
                if hasattr(m, name)]
    zero_counts(counters)
    row = dryrun.cell_row(cell)
    row["launches"] = sum(read_counts(counters).values())
    return row
# a dry-run cell is run for real on the card below this peak (GiB)
REAL_STEP_MAX_GB = 70.0
# each bundle's SMOKE step, card against CPU: the f32 losses
SMOKE_LOSS_REL = 1e-4


def dryrun_order(C) -> list:
    """The 36 cells, the slowest to count first (MoE train and prefill run
    every layer's dispatch chunks), so the pool's wall time is the slowest
    cell's."""
    cells = [(a, s) for a in C.arch_ids() for s in C.get_arch(a).shape_ids()]

    def cost(cell):
        b = C.get_arch(cell[0])
        kind = b.cells[cell[1]].kind
        moe = b.family == "lm" and b.config.is_moe
        return (not moe, kind not in ("train", "prefill"), b.family != "lm", kind != "train")

    return sorted(cells, key=cost)


def launch_serve(serve_mod, counters, dev, scale: int = 10, n_queries: int = 20_000) -> dict:
    """(a) ``launch.serve.serve`` at the main cell (SNB-like scale 10, 20,000
    queries, 6 hash-sharded servers): t = 1 and t = 2 with the server-0
    drill, and t = 1 with ``hedge``, each on the kernel and the torch
    backend; the two reports equal field by field and their masks."""
    runs = {}
    for t, hedge in ((1, False), (2, False), (1, True)):
        key = f"t{t}" + ("_hedge" if hedge else "")
        got = {}
        for backend in ("kernel", "torch"):
            zero_counts(counters)
            ts = time.perf_counter()
            rep, scheme = serve_mod.serve(t, 6, scale, n_queries, "hash", 0, hedge, device=dev,
                                          backend=backend, return_scheme=True)
            torch.cuda.synchronize()
            got[backend] = (rep, scheme, time.perf_counter() - ts, read_counts(counters))
        (rk, sk, sec_k, launches), (rt, st, sec_t, _) = got["kernel"], got["torch"]
        check(dataclasses.astuple(rk) == dataclasses.astuple(rt),
              f"serve {key}: kernel and torch reports differ: {rk} / {rt}")
        check(np.array_equal(sk.mask, st.mask), f"serve {key}: kernel and torch masks differ")
        check(rk.feasible, f"serve {key}: scheme not feasible")
        check(all(math.isfinite(v) for v in (rk.overhead, rk.mean_us, rk.p99_us, rk.qps)),
              f"serve {key}: non-finite report")
        check(launches["path_latency"] > 0 and launches["routed_walk"] > 0,
              f"serve {key}: the walk kernels were not launched: {launches}")
        runs[key] = {"report": dataclasses.asdict(rk), "launches": launches,
                     "kernel_s": sec_k, "torch_s": sec_t}
        print(f"launch serve {key}: {runs[key]}", flush=True)
    return runs


def launch_smoke(C, dev) -> dict:
    """(b) every bundle's ``smoke_step`` on the card and on the CPU from the
    same seed: the f32 losses within 1e-4 relative, every output finite."""
    out = {}
    for arch in C.arch_ids():
        b = C.get_arch(arch)
        res = {}
        for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
            r = b.smoke_step()(b.smoke_batch(np.random.default_rng(0), device=d))
            check(all(bool(torch.isfinite(v).all()) for v in r.values()),
                  f"smoke {arch} on {d}: non-finite output")
            res[side] = float(r["loss"])
        rel = abs(res["card"] - res["cpu"]) / max(abs(res["cpu"]), 1e-30)
        check(rel <= SMOKE_LOSS_REL, f"smoke {arch}: card loss {res['card']} vs cpu {res['cpu']}")
        out[arch] = {"loss_card": res["card"], "loss_cpu": res["cpu"], "rel": rel}
    print(f"launch smoke: {out}", flush=True)
    return out


def launch_real_steps(C, rows: list, counters, dev) -> dict:
    """(c) one real step on the card for each dry-run cell whose counted
    peak is under REAL_STEP_MAX_GB: seeded arguments (``real_args``), the
    step under ``FlopCounterMode`` equal to the ``meta`` count exactly (no
    kernel is on a bundle's path: 0 launches), its seconds and
    ``max_memory_allocated`` beside the counted peak."""
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import FlopCounterMode

    out = {}
    for row in rows:
        if row["peak_mem_gb"] >= REAL_STEP_MAX_GB:
            continue
        b = C.get_arch(row["arch"])
        cell = f"{row['arch']}:{row['shape']}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        args = b.real_args(row["shape"], device=dev, seed=0)
        step = b.step_fn(row["shape"])
        zero_counts(counters)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        with FlopCounterMode(display=False) as fc:
            res = step(*args)
        torch.cuda.synchronize()
        sec = time.perf_counter() - ts
        launches = sum(read_counts(counters).values())
        # the step's result: its last output (metrics, logits or scores);
        # the state before it (parameters, moments, a cache) is written back
        flat = [x for x in tree_flatten(res[-1] if isinstance(res, tuple) else res)[0]
                if isinstance(x, torch.Tensor) and x.is_floating_point()]
        check(bool(flat) and all(bool(torch.isfinite(x).all()) for x in flat),
              f"real step {cell}: non-finite")
        check(launches == 0, f"real step {cell}: {launches} kernel launches")
        check(fc.get_total_flops() == row["hlo_flops"],
              f"real step {cell}: FlopCounterMode {fc.get_total_flops()} vs meta "
              f"{row['hlo_flops']}")
        out[cell] = {"seconds": sec, "flops": fc.get_total_flops(),
                     "max_memory_allocated": torch.cuda.max_memory_allocated(),
                     "peak_mem_gb_meta": row["peak_mem_gb"]}
        print(f"launch real {cell}: {out[cell]}", flush=True)
        del args, res, flat
    return out


def phase_launch(counters, dev) -> dict:
    """The last modules' drives: (c)'s dry-run counted in host processes
    from the start, (a) the serve launcher, (b) the bundles' smoke steps, (d)
    the elastic drill at qwen2-7b's full width, then (c)'s real steps."""
    import multiprocessing as mp

    from repro_torch import configs as C
    from repro_torch.launch import dryrun, elastic
    from repro_torch.launch import serve as serve_mod

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    parts = {}
    pool = mp.get_context("spawn").Pool(DRYRUN_WORKERS)
    try:
        # one cell per task: the slowest cells start at once, one per worker
        pods = pool.map_async(pod_cell_row, POD_CELLS, chunksize=1)
        pending = pool.map_async(dryrun.cell_row, dryrun_order(C), chunksize=1)
        ts = time.perf_counter()
        serve_runs = launch_serve(serve_mod, counters, dev)
        parts["serve"] = time.perf_counter() - ts
        ts = time.perf_counter()
        smoke = launch_smoke(C, dev)
        parts["smoke"] = time.perf_counter() - ts
        ts = time.perf_counter()
        cfg = dataclasses.replace(C.qwen2_7b.FULL, n_layers=2)
        drill = elastic.elastic_drill(cfg, 3, 3, batch=2, seq=512, seed=0, device=dev)
        parts["elastic"] = time.perf_counter() - ts
        check(drill["bit_exact"], f"elastic drill not bit-exact: {drill}")
        print(f"launch elastic: {drill}", flush=True)
        torch.cuda.empty_cache()
        ts = time.perf_counter()
        rows = pending.get()
        pod_rows = pods.get()
        parts["dryrun_wait"] = time.perf_counter() - ts
    finally:
        pool.terminate()
        pool.join()
    for row in rows + pod_rows:
        print(f"launch dryrun: {json.dumps(row, default=str)}", flush=True)
    failed = [(r["arch"], r["shape"], r["status"]) for r in rows if r.get("status") != "ok"]
    check(len(rows) == 36 and not failed, f"dry-run cells failed: {failed}")
    failed = [(r["arch"], r["shape"], r["mesh"], r["status"]) for r in pod_rows
              if r.get("status") != "ok" or r["launches"] != 0]
    check(len(pod_rows) == len(POD_CELLS) and not failed, f"pod cells failed: {failed}")
    ts = time.perf_counter()
    real = launch_real_steps(C, rows, counters, dev)
    parts["real_steps"] = time.perf_counter() - ts
    out = {
        "phase": "launch", "seconds": time.perf_counter() - t0, "part_s": parts,
        "serve": serve_runs, "smoke": smoke,
        "elastic": {k: drill[k] for k in ("bit_exact", "max_abs_gap", "reference")},
        "dryrun": {f"{r['arch']}:{r['shape']}": {
            k: r[k] for k in ("hlo_flops", "model_flops", "hlo_bytes", "peak_mem_gb",
                              "fits_80gb", "bottleneck", "t_count_s")} for r in rows},
        "dryrun_count_s": sum(r["t_count_s"] for r in rows),
        "pod": {f"{r['arch']}:{r['shape']}:{r['mesh']}": {
            k: r[k] for k in ("status", "chips", "hlo_flops", "hlo_bytes", "collective_bytes",
                              "t_collective_s", "peak_mem_gb", "fits_80gb", "bottleneck",
                              "t_count_s", "launches")} for r in pod_rows},
        "real_steps": real,
        # the kernels' launches in the serve launcher's t = 1 drive (kernel backend)
        "launches": serve_runs["t1"]["launches"],
    }
    emit(out)
    return out


def kernel_entry(name: str, source: str, replaces: str, launches: int, err, timing,
                 main_shape: dict | None = None) -> dict:
    """One kernel of the kernels line: "ms", "plain_ms" and "library_ms" time
    each call from the host (:func:`time_ms`), the "*device_ms" keys the same
    calls' device time (``busy_first``).  ``main_shape``: the same kernel
    timed at its path's median rows per launch (phase ``shapes``), under
    "main_shape_*" keys beside the sweep-scale numbers."""
    out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "launches": launches, "max_abs_err": err, "ms": timing["kernel_ms"],
           "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
           "bound_by": timing["bound_by"], "library_ms": timing.get("library_ms"),
           "device_ms": timing["kernel_device_ms"],
           "plain_device_ms": timing["plain_device_ms"],
           "library_device_ms": timing.get("library_device_ms")}
    if main_shape is not None:
        out.update(main_shape_rows=main_shape["rows"], main_shape_ms=main_shape["kernel_ms"],
                   main_shape_device_ms=main_shape["kernel_device_ms"],
                   main_shape_plain_ms=main_shape["plain_ms"],
                   main_shape_bound_ms=main_shape["bound_ms"])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    import repro_torch.core as T
    import repro_torch.distsys as TD
    import repro_torch.serve as TS
    from repro_torch import engine as engine_mod
    from repro_torch import graph as graph_mod
    from repro_torch import workload as workload_mod
    from repro_torch.core import combi
    from repro_torch.core import greedy
    from repro_torch.distsys import executor, faults
    from repro_torch.engine import backends, routing, sharding, streaming
    from repro_torch.engine import engine as engine_core
    import torch.nn.functional as F

    from repro_torch import configs as C
    from repro_torch import optim as O
    from repro_torch.configs import deepseek_v2_236b, mind, qwen2_7b, qwen3_moe_235b_a22b
    from repro_torch.data import gnn_batch_fn, lm_batch_fn, shard_batch
    from repro_torch.graph import ogb_like
    from repro_torch.launch import train_lm
    from repro_torch.launch.train import make_train_step
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import ops
    from repro_torch.kernels import path_latency as pl
    from repro_torch.kernels import provision_update as pu
    from repro_torch.kernels import prune_walk as pw
    from repro_torch.kernels import routed_walk as rw
    from repro_torch.models import gnn as G
    from repro_torch.models import recsys as RM
    from repro_torch.models import transformer as TM
    from repro_torch.workload.recsys import zipf_rows

    dev = torch.device("cuda")
    counters = [(pl, "LAUNCHES"), (rw, "LAUNCHES"), (rw, "SCORED_LAUNCHES"), (pu, "LAUNCHES"),
                (fp, "LAUNCHES"), (fp, "TC_LAUNCHES"), (da, "LAUNCHES"), (eb, "LAUNCHES"),
                (pw, "LAUNCHES"), (pw, "SCORED_LAUNCHES")]
    targets = row_targets(backends, greedy)
    t_all = time.perf_counter()
    b = phase_build(build)
    # first, while the card's memory is unfragmented: qwen2-7b's step peaks
    # at ~73 GB, and after the other phases the cache's free gaps (~17 GB
    # in all) hold no 3.5 GiB block
    phase_train(TM, RM, G, C, O, make_train_step, train_lm, lm_batch_fn, gnn_batch_fn,
                shard_batch, ogb_like, zipf_rows, counters, dev)
    par = phase_parity(pl, rw, pu, backends, routing, combi, dev, P=1_000_000)
    ts = time.perf_counter()
    case = snb_case(graph_mod, workload_mod, scale=10, n_queries=20_000, n_srv=6)
    emit({"phase": "setup", "seconds": time.perf_counter() - ts, "scale": 10,
          "n_queries": 20_000})
    main_out = phase_main(T, counters, targets, case, engine_mod, engine_core, streaming,
                          backends, scale=10, n_queries=20_000)
    fused_out = phase_fused(T, greedy, backends, pu, counters, targets, case,
                            main_out["schemes"], dev)
    ex = phase_executor(T, TD, executor, faults, backends, streaming, rw, counters, case,
                        main_out["schemes"], dev)
    planes = phase_planes(T, TS, engine_mod, counters, case, dev)
    serve = phase_serve(T, TD, TS, engine_mod, counters, case, main_out["schemes"][1], dev)
    mesh = phase_mesh(T, TS, engine_mod, sharding, greedy, counters, case,
                      fused_out["schemes"], dev)
    # each kernel's launches on the path that exercises it
    launches = {
        "path_latency": main_out["launches"]["path_latency"],
        "routed_walk": main_out["launches"]["routed_walk"],
        "prune_walk": main_out["launches"]["prune_walk"],
        "scored_walk": fused_out["launches"]["scored_walk"],
        "fused_update": fused_out["launches"]["fused_update"],
    }
    pr = phase_prune(T, pw, rw, backends, engine_mod, case, main_out, dev)
    dp = phase_dp_prune(T, pw, rw, backends, engine_mod, streaming, routing, counters, case,
                        dev)
    launches["prune_walk_scored"] = dp["launches"]["prune_walk_scored"]
    shapes = phase_shapes(pl, rw, pu, backends, engine_mod, streaming, routing, combi, T, case,
                          main_out, fused_out, dev)
    sw = phase_sweep(pl, rw, pu, graph_mod, workload_mod, engine_mod, backends, streaming,
                     routing, combi, T, case, scale=100, n_queries=150_000, dev=dev,
                     launches=launches)
    del case, main_out, fused_out
    torch.cuda.empty_cache()
    phase_quickstart(counters)
    phase_tenants(T, counters)
    lm_par = phase_lm_parity(fp, da, eb, dev)
    lm = phase_lm(TM, qwen2_7b, fp, da, ops, F, counters, dev)
    bag = phase_bag(eb, ops, F, counters, dev)
    lm_moe = phase_lm_moe(TM, qwen3_moe_235b_a22b, fp, F, counters, dev)
    phase_lm_moe(TM, deepseek_v2_236b, fp, F, counters, dev)
    phase_recsys(RM, mind, zipf_rows, counters, dev)
    phase_mesh_serve(TM, RM, C, mind, zipf_rows, counters, dev)
    launch = phase_launch(counters, dev)
    launches.update(flash_prefill=lm["launches"]["flash_prefill"],
                    decode_attention=lm["launches"]["decode_attention"],
                    embedding_bag=bag["launches"]["embedding_bag"])
    emit({"phase": "total", "seconds": time.perf_counter() - t_all})
    print(b["nvidia_smi"], flush=True)
    tm, at = sw["timings"], shapes["timings"]
    err = par["max_abs_err"]
    prune_entry = kernel_entry("prune_walk", "src/repro_torch/csrc/prune_walk.cu",
                               "src/repro/kernels/routed_walk.py:147", launches["prune_walk"],
                               pr["prefix"]["max_abs_err"], pr["prefix"])
    prune_entry.update(candidates=pr["prefix"]["candidates"],
                       whole_candidates=pr["whole"]["candidates"],
                       whole_ms=pr["whole"]["kernel_ms"],
                       whole_device_ms=pr["whole"]["kernel_device_ms"],
                       whole_bound_ms=pr["whole"]["bound_ms"],
                       us_per_candidate=pr["whole"]["us_per_candidate"])
    dp_entry = kernel_entry("prune_walk_scored", "src/repro_torch/csrc/prune_walk.cu",
                            "src/repro/kernels/routed_walk.py:244",
                            launches["prune_walk_scored"], dp["prefix"]["max_abs_err"],
                            dp["prefix"])
    dp_entry.update(candidates=dp["prefix"]["candidates"],
                    whole_candidates=dp["whole"]["candidates"],
                    whole_ms=dp["whole"]["kernel_ms"],
                    whole_device_ms=dp["whole"]["kernel_device_ms"],
                    whole_bound_ms=dp["whole"]["bound_ms"],
                    us_per_candidate=dp["whole"]["us_per_candidate"],
                    old_loop_ms_per_candidate=dp["old_loop"]["ms_per_candidate"])
    cls = tm["fused_update/class"]
    fused_entry = kernel_entry("fused_update", "src/repro_torch/csrc/provision_update.cu",
                               "src/repro/kernels/provision_update.py:285",
                               launches["fused_update"], err["fused_update"],
                               tm["fused_update/routed/B=256"], at["fused_update"])
    # the class launch (the whole t = 1 class, 256-row batches) beside the
    # 256-row round, and the per-batch sequence it replaced
    fused_entry.update(class_rows=cls["rows"], class_batches=cls["batches"],
                       class_ms=cls["kernel_ms"], class_device_ms=cls["kernel_device_ms"],
                       class_plain_ms=cls["plain_ms"], class_bound_ms=cls["bound_ms"],
                       class_per_batch_ms=cls["per_batch_ms"],
                       class_per_batch_device_ms=cls["per_batch_device_ms"])
    # kernels 1-4's launches on the planes phase's paths, by part
    planes_launches = {name: {part: c[name] for part, c in planes["launches"].items()}
                       for name in PLANE_COUNTERS}
    # kernels 1-4's launches on the serving controller's steps (each phase's
    # simulate + observe, the liveness repair, the home-first eviction
    # drive); the walks' per simulate case come from the serve phase's
    serve_ctl = {name: [st["launches"].get(name, 0) for st in serve["controller"]["steps"]]
                 + [serve["controller"][part]["launches"].get(name, 0)
                    for part in ("liveness", "eviction")]
                 for name in PLANE_COUNTERS}
    fused_entry.update(planes_launches=planes_launches["fused_update"],
                       serve_controller_launches=serve_ctl["fused_update"],
                       # one round per shard and batch on each mesh drive
                       mesh_launches={run: r["fused_update_launches"]
                                      for run, r in mesh["runs"].items()})
    # the walks' launches on the executor's path (every case of its phase)
    routed_entry = kernel_entry("routed_walk", "src/repro_torch/csrc/routed_walk.cu",
                                "src/repro/kernels/routed_walk.py:147", launches["routed_walk"],
                                err["routed_walk"], tm["routed_walk/nearest_copy"],
                                at["routed_walk"])
    routed_entry.update(executor_launches=ex["launches"]["routed_walk"],
                        planes_launches=planes_launches["routed_walk"],
                        serve_launches=serve["launches"]["routed_walk"],
                        serve_controller_launches=serve_ctl["routed_walk"],
                        launch_serve_launches=launch["launches"]["routed_walk"])
    scored_entry = kernel_entry("scored_walk", "src/repro_torch/csrc/scored_walk.cu",
                                "src/repro/kernels/routed_walk.py:244", launches["scored_walk"],
                                err["scored_walk"], tm["scored_walk"], at["scored_walk"])
    scored_entry.update(executor_launches=ex["launches"]["scored_walk"],
                        planes_launches=planes_launches["scored_walk"],
                        serve_launches=serve["launches"]["scored_walk"],
                        serve_controller_launches=serve_ctl["scored_walk"])
    pl_entry = kernel_entry("path_latency", "src/repro_torch/csrc/path_latency.cu",
                            "src/repro/kernels/path_latency.py:93", launches["path_latency"],
                            err["path_latency"], tm["path_latency"], at["path_latency"])
    pl_entry.update(planes_launches=planes_launches["path_latency"],
                    serve_controller_launches=serve_ctl["path_latency"],
                    launch_serve_launches=launch["launches"]["path_latency"])
    # flash_prefill on qwen2-7b's path (G 7), and on qwen3-moe's (G 16):
    # its launches in the lm_moe phase's flash forward, timed at that shape
    flash_entry = kernel_entry("flash_prefill", "src/repro_torch/csrc/flash_prefill.cu",
                               "src/repro/kernels/flash_prefill.py:85", launches["flash_prefill"],
                               lm_par["max_abs_err"]["flash_prefill"],
                               lm["timings"]["flash_prefill"])
    g16 = lm_moe["flash_timing"]
    flash_entry.update(lm_moe_config=lm_moe["config"],
                       lm_moe_launches=lm_moe["launches"]["flash_prefill"],
                       lm_moe_tc_launches=lm_moe["launches"]["flash_prefill_tc"],
                       lm_moe_shape=g16["shape"], lm_moe_ms=g16["kernel_ms"],
                       lm_moe_device_ms=g16["kernel_device_ms"], lm_moe_plain_ms=g16["plain_ms"],
                       lm_moe_library_ms=g16["library_ms"],
                       lm_moe_library_device_ms=g16["library_device_ms"],
                       lm_moe_bound_ms=g16["bound_ms"], lm_moe_bound_by=g16["bound_by"])
    emit({"kernels": [
        pl_entry,
        routed_entry,
        prune_entry,
        scored_entry,
        dp_entry,
        fused_entry,
        kernel_entry("embedding_bag", "src/repro_torch/csrc/embedding_bag.cu",
                     "src/repro/kernels/embedding_bag.py:68", launches["embedding_bag"],
                     lm_par["max_abs_err"]["embedding_bag"], bag["timing"]),
        flash_entry,
        kernel_entry("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
                     "src/repro/kernels/decode_attention.py:83", launches["decode_attention"],
                     lm_par["max_abs_err"]["decode_attention"],
                     lm["timings"]["decode_attention"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
