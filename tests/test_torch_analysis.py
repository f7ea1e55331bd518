"""The port's analysis (roofline counts, op census, per-layer terms) and
one-card dry-run, on the CPU.

``lm_param_count``, ``lm_model_flops``, ``gnn_model_flops``,
``mind_model_flops`` and the dry-run's ``model_flops_for`` equal the JAX
package's exactly for all 36 cells (the JAX dispatch rebuilt here from
``repro.analysis.roofline`` and ``repro.configs``: ``repro.launch.dryrun``
sets ``XLA_FLAGS`` on import, so no test imports it); the census counts a
hand-built program exactly (ops, FLOPs, bytes, peak live bytes, no
collective bytes) on ``meta`` and on the CPU; the per-layer split's
identity base + n_blocks x block = the direct count holds exactly on cut
4-layer configs (dense, MoE, MLA + MoE, a GNN); the dry-run row completes
on a sample of full-size cells with a MoE and an MLA cell among them.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import dataclasses

import pytest
import torch

import repro.analysis.roofline as JR
import repro.configs as JC
from repro.configs.gnn_family import cfg_for_cell as j_cfg_for_cell
from repro.configs.recsys_family import N_CANDIDATES_ONLINE as J_ONLINE
import repro_torch.analysis as A
import repro_torch.analysis.roofline as R
import repro_torch.configs as C
from repro_torch.analysis.corrected import corrected_cell
from repro_torch.analysis.hlo import OpCensus, collective_stats, count_step, op_census
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun

CELLS = [(a, s) for a in C.arch_ids() for s in C.get_arch(a).shape_ids()]
ROW_KEYS = {"arch", "shape", "mesh", "chips", "t_compute_s", "t_memory_s", "t_collective_s",
            "bottleneck", "model_flops", "hlo_flops", "useful_frac", "roofline_frac",
            "peak_mem_gb"}


def _jax_model_flops(jb, shape_id: str) -> float:
    """``repro.launch.dryrun.model_flops_for``, rebuilt from its parts."""
    cell = jb.cells[shape_id]
    m = cell.meta
    if jb.family == "lm":
        if cell.kind in ("train", "prefill"):
            return JR.lm_model_flops(jb.config, m["batch"] * m["seq"], cell.kind,
                                     kv_len=m["seq"])
        return JR.lm_model_flops(jb.config, m["batch"], "decode", kv_len=m["seq"])
    if jb.family == "gnn":
        cfg = j_cfg_for_cell(jb, shape_id)
        if shape_id == "minibatch_lg":
            B, (f1, f2) = m["batch"], m["fanouts"]
            n, e = B * (1 + f1 + f1 * f2), B * (f1 + f1 * f2)
        elif shape_id == "molecule":
            n, e = m["batch"] * m["n"], m["batch"] * m["e"]
        else:
            n, e = m["n"], m["e"]
        return JR.gnn_model_flops(cfg, n, e, "train")
    if cell.kind == "train":
        return JR.mind_model_flops(jb.config, m["batch"], m["batch"], "train")
    n_cand = J_ONLINE if cell.kind == "serve" else m["n_candidates"]
    return JR.mind_model_flops(jb.config, m["batch"], n_cand, "serve")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_jax(arch, shape):
    b, jb = C.get_arch(arch), JC.get_arch(arch)
    assert dryrun.model_flops_for(b, shape) == _jax_model_flops(jb, shape) > 0


@pytest.mark.parametrize("arch", sorted(C.LM_CONFIGS))
def test_lm_counts_equal_jax(arch):
    cfg, jcfg = C.get_arch(arch).config, JC.get_arch(arch).config
    for active in (False, True):
        assert R.lm_param_count(cfg, active) == JR.lm_param_count(jcfg, active)
    for kind, tokens, kv in (("train", 8192, 4096), ("prefill", 4096, 4096),
                             ("decode", 16, 32768), ("decode", 1, 524288)):
        assert R.lm_model_flops(cfg, tokens, kind, kv) == JR.lm_model_flops(jcfg, tokens, kind, kv)


def test_roofline_constants_are_the_cards():
    assert (A.PEAK_FLOPS_BF16, A.HBM_BW) == (989e12, 3.35e12)
    assert not hasattr(A, "ICI_BW") and not hasattr(A, "DCN_BW")
    assert set(A.__all__) == set(__import__("repro.analysis").analysis.__all__) - {
        "ICI_BW", "DCN_BW"}


def _program(a, b):
    c = a @ b                                   # mm: 2 * 64 * 32 * 32
    d = torch.bmm(c[None], b[None])             # bmm: the same
    e = torch.addmm(a[0], c, b)                 # addmm: the same
    return torch.sort(e, dim=-1)


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_census_counts_a_hand_built_program(device):
    a, b = torch.zeros(64, 32, device=device), torch.zeros(32, 32, device=device)
    c = count_step(_program, (a, b))
    assert op_census(c) == {"fusion": 0, "dot": 3, "convolution": 0, "scatter": 0,
                            "gather": 0, "sort": 1, "while": 0}
    assert c.flops == 3 * 2 * 64 * 32 * 32
    assert collective_stats(c).total_bytes == 0 and collective_stats(c).summary() == {
        "total_bytes": 0}
    # arguments 8,192 + 4,096; c, d, e 8,192 each; the sort's f32 values and
    # int64 indices 8,192 + 16,384, all alive at the sort
    assert c.peak_bytes == 12288 + 3 * 8192 + 8192 + 16384
    # each op's input + output bytes (mm, bmm, addmm, sort; the views
    # unsqueeze and select move none)
    assert c.bytes == sum([12288 + 8192, 12288 + 8192, 128 + 12288 + 8192,
                           8192 + 8192 + 16384])


def test_census_frees_dead_storages():
    def step(x):
        for _ in range(4):
            y = x * 2      # each y dies before the next is made
            del y
        return x

    x = torch.zeros(1024, device="meta")
    c = OpCensus()
    c.track((x,))
    with c:
        step(x)
    assert c.peak_bytes == 2 * 4096 and c.ops["mul"] == 4


def _cut(arch: str, layers: int, shape: str, meta: dict, **changes):
    """A bundle with its SMOKE config at ``layers`` layers as its config and
    one cell cut to ``meta``."""
    b = C.get_arch(arch)
    b.config = dataclasses.replace(b.smoke_config, n_layers=layers, **changes)
    b.cells = {shape: ShapeCell(shape, b.cells[shape].kind, meta)}
    return b


@pytest.mark.parametrize("arch,shape,changes", [
    ("qwen2-7b", "train_4k", dict(remat=True, remat_block=2, loss_chunk=32)),
    ("qwen2-7b", "decode_32k", {}),
    ("qwen3-moe-235b-a22b", "train_4k", dict(remat=True, remat_block=2)),
    ("deepseek-v2-236b", "prefill_32k", dict(remat=True, remat_block=4)),
])
def test_corrected_identity_at_4_layers(arch, shape, changes):
    b = _cut(arch, 4, shape, {"seq": 32, "batch": 2}, **changes)
    out = corrected_cell(arch, shape, bundle=b)
    total = out["base"] + out["n_blocks"] * out["block"]
    assert (total.flops, total.bytes, total.coll) == (out["flops"], out["bytes"], 0)
    assert out["flops"] > 0 and out["layer_flops"] > 0 and out["base_flops"] > 0
    bk = out["block"].flops // out["layer_flops"]
    assert out["layer_flops"] * bk == out["block"].flops


@pytest.mark.parametrize("arch,shape", [("egnn", "full_graph_sm"), ("graphcast", "molecule"),
                                        ("graphsage-reddit", "minibatch_lg")])
def test_corrected_identity_gnn(arch, shape):
    """The FLOPs split exactly for every GNN; the bytes too, except egnn's:
    its coordinate stream's backward grows faster than the depth."""
    b = C.get_arch(arch)
    b.config = dataclasses.replace(b.smoke_config, n_layers=2 if "sage" in arch else 4)
    out = corrected_cell(arch, shape, bundle=b)
    total = out["base"] + out["n_blocks"] * out["block"]
    assert total.flops == out["flops"] > 0
    if arch != "egnn":
        assert total.bytes == out["bytes"]
    assert corrected_cell("mind", "serve_p99") is None


@pytest.mark.parametrize("arch,shape", [("qwen3-moe-235b-a22b", "decode_32k"),
                                        ("deepseek-v2-236b", "decode_32k"),
                                        ("h2o-danube-3-4b", "long_500k"),
                                        ("egnn", "molecule"), ("mind", "serve_p99")])
def test_dryrun_row_completes(arch, shape):
    """A full-size cell on ``meta``: the JAX row's keys with one card, no
    collective term, the analytic FLOPs, the peak at least the arguments."""
    row = dryrun.run_cell(arch, shape, verbose=False)
    assert ROW_KEYS <= set(row) and row["status"] == "ok"
    assert (row["mesh"], row["chips"], row["t_collective_s"]) == ("h100x1", 1, 0.0)
    assert row["model_flops"] == _jax_model_flops(JC.get_arch(arch), shape)
    assert row["hlo_flops"] > 0 and row["hlo_bytes"] > 0 and row["ops"]["dot"] > 0
    assert row["peak_mem_gb"] >= row["arg_gb"] > 0
    assert row["fits_80gb"] == (row["peak_mem_gb"] * 2**30 <= 80e9)
    assert row["bottleneck"] in ("compute", "memory")
    if arch.startswith(("qwen3", "deepseek")):
        assert row["ops"]["sort"] > 0 and row["ops"]["scatter"] > 0
