"""Per-layer roofline terms of a cell (torch port of
``repro.analysis.corrected``).

The JAX package corrects XLA's cost analysis, which counts a while-loop
body once whatever its trip count: it compiles 2-layer configs with the
layer scan unrolled once and twice and extrapolates by the unroll delta,
plus standalone compiles for the inner loops (MoE dispatch chunks,
attention blocks, loss chunks).  Eager torch has no such loop: a step run
under :func:`~repro_torch.analysis.hlo.count_step` counts every layer and
every chunk as it runs.  So :func:`corrected_cell` counts the cell at its
full depth directly (on ``meta`` tensors), and keeps the JAX result's
``{flops, bytes, coll_bytes, notes, layer_flops, base_flops}``.

``layer_flops`` / ``base_flops`` come from the same cell at one and two
blocks of layers (a block is the remat block the full config runs, its
``remat_block`` held at that size; a MoE model keeps its leading dense
layers in the base):

  block = terms(2 blocks) - terms(1 block);  base = terms(1 block) - block
  base + n_blocks x block = the direct count, exactly

The identity holds because every block runs the same ops on the same
shapes (FLOPs and bytes are integer sums); the result also carries
``base`` and ``block`` (:class:`Terms`) and ``n_blocks`` to check it.
GNNs use one and two layers (two and three where the sampler's hops need
two stacked layers); their FLOPs split exactly, their bytes too except
egnn's, whose coordinate updates feed every later layer, so the backward's
bytes grow faster than the depth.  MIND has no layer stack and needs no
split.
"""
from __future__ import annotations

import dataclasses

from repro_torch.analysis.hlo import collective_stats, count_step


@dataclasses.dataclass
class Terms:
    flops: int = 0
    bytes: int = 0
    coll: int = 0

    def __add__(self, o):
        return Terms(self.flops + o.flops, self.bytes + o.bytes,
                     self.coll + o.coll)

    def __sub__(self, o):
        return Terms(self.flops - o.flops, self.bytes - o.bytes,
                     self.coll - o.coll)

    def __mul__(self, k):
        return Terms(self.flops * k, self.bytes * k, self.coll * k)

    __rmul__ = __mul__

    def clamp(self):
        return Terms(max(self.flops, 0), max(self.bytes, 0),
                     max(self.coll, 0))


def measure(step, args) -> Terms:
    """The terms of one run of ``step(*args)`` (``meta`` or real tensors)."""
    c = count_step(step, args)
    return Terms(int(c.flops), int(c.bytes), int(collective_stats(c).total_bytes))


def _cell_terms(bundle, shape_id: str, config) -> Terms:
    saved = bundle.config
    try:
        bundle.config = config
        args = bundle.abstract_args(shape_id)
        step = bundle.step_fn(shape_id)
    finally:
        bundle.config = saved
    return measure(step, args)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------
def _lm_block(cfg) -> int:
    """The remat-block size the full config's layer stack runs (the largest
    divisor of its depth up to ``remat_block``), 1 without remat."""
    L_scan = cfg.n_moe_layers if cfg.is_moe else cfg.n_layers
    if not cfg.remat:
        return 1
    return max(k for k in range(1, min(cfg.remat_block, L_scan) + 1)
               if L_scan % k == 0)


def _lm_small_cfg(cfg, blocks: int):
    bk = _lm_block(cfg)
    L_small = (cfg.n_dense_layers if cfg.is_moe else 0) + blocks * bk
    return dataclasses.replace(cfg, n_layers=L_small, remat_block=bk)


def _split(direct: Terms, one: Terms, two: Terms, n: int, per: int, notes: str) -> dict:
    block = (two - one).clamp()
    base = (one - block).clamp()
    return {"flops": direct.flops, "bytes": direct.bytes, "coll_bytes": direct.coll,
            "notes": notes, "layer_flops": block.flops // per, "base_flops": base.flops,
            "base": base, "block": block, "n_blocks": n}


def corrected_lm_cell(arch: str, shape_id: str, bundle=None) -> dict:
    """``bundle``: count this bundle (a cut config) instead of the
    registry's ``arch``."""
    from repro_torch.configs import get_arch

    bundle = bundle or get_arch(arch)
    cfg = bundle.config
    bk = _lm_block(cfg)
    L_scan = cfg.n_moe_layers if cfg.is_moe else cfg.n_layers
    direct = _cell_terms(bundle, shape_id, cfg)
    one = _cell_terms(bundle, shape_id, _lm_small_cfg(cfg, 1))
    two = _cell_terms(bundle, shape_id, _lm_small_cfg(cfg, 2))
    return _split(direct, one, two, L_scan // bk, bk, f"remat_block={bk}")


def corrected_gnn_cell(arch: str, shape_id: str, bundle=None) -> dict:
    """``bundle``: count this bundle (a cut config) instead of the
    registry's ``arch``."""
    from repro_torch.configs import get_arch

    bundle = bundle or get_arch(arch)
    cfg = bundle.config
    # graphsage's sampled form stacks one layer per hop: it needs two
    d0 = 2 if (cfg.arch == "graphsage" and shape_id == "minibatch_lg") else 1
    direct = _cell_terms(bundle, shape_id, cfg)
    one = _cell_terms(bundle, shape_id, dataclasses.replace(cfg, n_layers=d0))
    two = _cell_terms(bundle, shape_id, dataclasses.replace(cfg, n_layers=d0 + 1))
    out = _split(direct, one, two, cfg.n_layers, 1, "")
    if d0 > 1:  # base holds d0 layers: move d0 - 1 of them back
        out["base"] = (out["base"] - (d0 - 1) * out["block"]).clamp()
        out["base_flops"] = out["base"].flops
    return out


def corrected_cell(arch: str, shape_id: str, bundle=None) -> dict:
    from repro_torch.configs import get_arch

    bundle = bundle or get_arch(arch)
    if bundle.family == "lm":
        return corrected_lm_cell(arch, shape_id, bundle)
    if bundle.family == "gnn":
        return corrected_gnn_cell(arch, shape_id, bundle)
    return None  # recsys: no layer stack; the direct count is the answer
