"""Roofline analysis of a step counted on one card, or as one rank of a
cluster of H100s (torch port of ``repro.analysis.roofline``).

Per (arch x shape x mesh) cell, per card:

  compute term    = FLOPs / peak_FLOP/s
  memory term     = bytes / HBM_bw
  collective term = sum over the rank's collectives of bytes / the
                    slowest link its group spans (0 on one card)

The cluster is H100 SXM nodes of ``NODE_CARDS`` cards: NVLink inside a
node, InfiniBand NDR between nodes, one 400 Gb/s port per card; rank r
sits on node r // ``NODE_CARDS``.  A collective whose group stays inside
one node moves its bytes at ``NVLINK_BW``, one that crosses nodes at
``IB_BW``.  On the production meshes (16, 16) and (2, 16, 16) rank r's
"model" group is 16 consecutive ranks, two nodes, so every collective of
those meshes crosses nodes.

The counts come from the step run once on ``meta`` tensors (the dry-run,
``repro_torch.launch.dryrun``; on a mesh as rank 0 of a placeholder group)
under
:class:`~repro_torch.analysis.hlo.OpCensus`: FLOPs by
``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s), which
count the matrix products (mm / bmm / addmm / baddbmm, and
convolutions); XLA's ``cost_analysis`` counts elementwise work too, so
the two ``hlo_flops`` differ in kind.  Bytes, peak memory and the op
census come from the same run.  Constants: the H100's, as
the port's kernel table uses them (989 TFLOP/s dense bf16, 3.35 TB/s).

The dominant term is the bottleneck; MODEL_FLOPS / FLOPs measures how
much of the counted compute is useful (catches remat and routing waste).
The analytic counts below are the JAX package's, as plain Python.
"""
from __future__ import annotations

import dataclasses

from repro_torch.analysis.hlo import collective_stats, op_census

# NVIDIA H100 SXM (80 GB HBM3), the H100 datasheet
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense
HBM_BW = 3.35e12                # B/s
HBM_BYTES = 80e9                # the card's memory
# the cluster: NVLink 4 gives a card 900 GB/s, 450 GB/s each way (the H100
# datasheet); InfiniBand NDR one 400 Gb/s port per card, 50 GB/s each way
# (ConnectX-7, DGX H100's layout); 8 cards a node (HGX H100 8-GPU)
NVLINK_BW = 450e9               # B/s, inside a node
IB_BW = 50e9                    # B/s, between nodes
NODE_CARDS = 8


def link_bw(ranks) -> float:
    """The slowest link a group of ``ranks`` spans: NVLink when every rank
    sits on one node, InfiniBand otherwise."""
    nodes = {r // NODE_CARDS for r in ranks}
    return NVLINK_BW if len(nodes) == 1 else IB_BW


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # the step's matmul FLOPs (FlopCounterMode)
    hlo_bytes: float            # input + output bytes of every aten op
    collective_bytes: float     # the rank's collectives' output bytes (0 on one card)
    model_flops: float          # analytic useful FLOPs (6ND etc.)
    peak_memory_per_chip: float
    collectives: dict
    ops: dict
    collective_s: float = 0.0   # each collective's bytes over its group's link

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_s

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / (counted FLOPs x chips)."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """max(terms) vs the compute term: how close the step is to being
        compute-bound at peak (1.0 = compute-bound at roofline)."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        return self.t_compute / t if t > 0 else 0.0

    @property
    def fits(self) -> bool:
        """The step's peak live bytes fit the card's 80 GB."""
        return self.peak_memory_per_chip <= HBM_BYTES

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "collective_bytes": self.collective_bytes,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "hlo_flops": self.hlo_flops,
            "useful_frac": self.useful_fraction,
            "roofline_frac": self.roofline_fraction,
            "peak_mem_gb": self.peak_memory_per_chip / 2**30,
            "fits_80gb": self.fits,
        }


def analyze(arch: str, shape: str, mesh_name: str, chips: int,
            counts, model_flops: float) -> Roofline:
    """The roofline of a counted step: ``counts`` is the
    :class:`~repro_torch.analysis.hlo.OpCensus` of its ``meta`` run
    (:func:`~repro_torch.analysis.hlo.count_step`)."""
    coll = collective_stats(counts)
    t_coll = sum(nbytes / link_bw(ranks)
                 for (_, ranks), (_, nbytes) in counts.collective_groups.items())
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=float(counts.flops), hlo_bytes=float(counts.bytes),
        collective_bytes=float(coll.total_bytes),
        model_flops=model_flops,
        peak_memory_per_chip=float(counts.peak_bytes),
        collectives=coll.summary(),
        ops=op_census(counts),
        collective_s=t_coll,
    )


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS per family (6*N*D dense / 6*N_active*D MoE; GNN and
# recsys counted from their dominant einsums).
# ---------------------------------------------------------------------------
def lm_param_count(cfg, active_only: bool = False) -> float:
    d, hd, H, KV, L, V = (cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads,
                          cfg.n_layers, cfg.vocab)
    if cfg.is_mla:
        qd = cfg.mla_nope_dim + cfg.mla_rope_dim
        attn = (d * cfg.mla_q_lora + cfg.mla_q_lora * H * qd
                if cfg.mla_q_lora else d * H * qd)
        attn += d * (cfg.mla_kv_lora + cfg.mla_rope_dim)
        attn += cfg.mla_kv_lora * H * (cfg.mla_nope_dim + cfg.mla_v_dim)
        attn += H * cfg.mla_v_dim * d
    else:
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d
    if cfg.is_moe:
        n_routed = cfg.top_k if active_only else cfg.n_experts
        ffn = 3 * d * cfg.moe_d_ff * n_routed
        if cfg.n_shared_experts:
            sff = cfg.shared_d_ff or cfg.n_shared_experts * cfg.moe_d_ff
            ffn += 3 * d * sff
        moe_layers = cfg.n_layers - cfg.n_dense_layers
        body = moe_layers * (attn + ffn) + cfg.n_dense_layers * (
            attn + 3 * d * cfg.d_ff)
    else:
        body = L * (attn + 3 * d * cfg.d_ff)
    return float(body + 2 * V * d)


def lm_model_flops(cfg, tokens: int, kind: str, kv_len: int = 0) -> float:
    """6*N*D for training; 2*N*D + attention for inference steps.

    The per-head kv dim is hd for GQA and kv_lora+rope for absorbed MLA;
    sliding-window attention caps the effective kv length."""
    n_active = lm_param_count(cfg, active_only=True)
    eff_hd = (cfg.mla_kv_lora + cfg.mla_rope_dim) if cfg.is_mla else cfg.hd
    win = cfg.sliding_window or 0
    if kind == "train":
        S = kv_len or 1
        S_eff = min(S, 2 * win) if win else S  # causal avg vs window
        flops = 6.0 * n_active * tokens
        flops += 6.0 * cfg.n_layers * cfg.n_heads * eff_hd * S_eff * tokens
        return flops
    if kind == "prefill":
        S_eff = min(kv_len, 2 * win) if win else kv_len
        return (2.0 * n_active * tokens
                + 2.0 * cfg.n_layers * cfg.n_heads * eff_hd * S_eff * tokens)
    # decode: per generated token
    S_eff = min(kv_len, win) if win else kv_len
    return (2.0 * n_active * tokens
            + 4.0 * cfg.n_layers * cfg.n_heads * eff_hd * S_eff * tokens)


def gnn_model_flops(cfg, n_nodes: int, n_edges: int, kind="train") -> float:
    d = cfg.d_hidden
    if cfg.arch == "egnn":
        per_edge = 2 * (2 * d + 1) * d + 2 * d * d + 2 * d * 1
        per_node = 2 * (2 * d) * d + 2 * d * d
    elif cfg.arch == "schnet":
        per_edge = 2 * cfg.n_rbf * d + 2 * d * d + d
        per_node = 2 * d * d * 2
    elif cfg.arch == "graphsage":
        per_edge = d  # mean agg adds
        per_node = 2 * 2 * d * d
    else:  # graphcast
        per_edge = 2 * (3 * d) * d + 2 * d * d
        per_node = 2 * (2 * d) * d + 2 * d * d
    fwd = cfg.n_layers * (per_edge * n_edges + per_node * n_nodes)
    fwd += 2 * n_nodes * cfg.d_in * d + 2 * n_nodes * d * cfg.n_classes
    return float(3.0 * fwd if kind == "train" else fwd)


def mind_model_flops(cfg, batch: int, n_cand: int, kind="train") -> float:
    d = cfg.embed_dim
    route = cfg.capsule_iters * 2 * batch * cfg.n_interests * cfg.hist_len * d
    tower = 2 * batch * cfg.n_interests * (2 * d * cfg.d_hidden
                                           + cfg.d_hidden * d)
    bil = 2 * batch * cfg.hist_len * d * d
    score = 2 * batch * cfg.n_interests * n_cand * d
    fwd = route + tower + bil + score
    return float(3.0 * fwd if kind == "train" else fwd)
