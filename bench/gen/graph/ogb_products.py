"""An ogbn-products-sized power-law graph built on the device.

The graph follows the rules of the program's ``graph/generators.ogb_like``
(out-degrees ``min(zipf(1.8), max(4 m, 8)) + m - 1``, targets ``zipf(1.4)
mod n``, self-loops dropped, symmetrised, parallel edges dropped) with the
draws made by torch on the device instead of numpy on the host: zipf
variates by inverse CDF over a table of the exact probabilities, and the
far tail of ``zipf(1.4)`` (past ``TAIL_K``, 0.2% of the mass) from the
continuous Pareto law it approaches.  The CSR then comes to the host for
the sampler (``bench/gen/traffic/graphsage.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from bench.gen.common import CSR, Graph

TAIL_K = 1 << 22  # table rows of zipf(1.4) ranks; the rest is the Pareto tail


def zeta(a: float, terms: int = 1 << 20) -> float:
    """Riemann zeta(a), a > 1: the first ``terms`` terms and the
    Euler-Maclaurin remainder."""
    k = np.arange(1, terms, dtype=np.float64)
    K = float(terms)
    return float(np.sum(k ** -a) + K ** (1 - a) / (a - 1) + 0.5 * K ** -a + a * K ** (-a - 1) / 12)


def _zipf_cdf(a: float, kmax: int) -> np.ndarray:
    """P(Z <= k) for k = 1 .. kmax, float64."""
    return np.cumsum(np.arange(1, kmax + 1, dtype=np.float64) ** -a) / zeta(a)


def zipf_capped(gen: torch.Generator, n: int, a: float, cap: int, device) -> torch.Tensor:
    """``min(zipf(a), cap)``, int64 [n]."""
    cdf = torch.from_numpy(_zipf_cdf(a, cap - 1)).to(device)
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
    return torch.searchsorted(cdf, u, right=True) + 1  # = cap past the table


def zipf_ranks(gen: torch.Generator, n: int, a: float, device) -> torch.Tensor:
    """``zipf(a)`` variates, int64 [n]: the table up to ``TAIL_K``, the
    Pareto tail beyond."""
    cdf = _zipf_cdf(a, TAIL_K)
    tail = 1.0 - cdf[-1]
    table = torch.from_numpy(cdf).to(device)
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
    k = torch.searchsorted(table, u, right=True) + 1
    far = u >= cdf[-1]
    # P(Z > x) ~ tail * (x / K)^(1 - a) past K
    w = ((1.0 - u[far]) / tail).clamp_min(1e-300)
    k[far] = (TAIL_K * w ** (1.0 / (1.0 - a))).clamp(max=2.0 ** 62).long() + 1
    return k


def products_graph(n_nodes: int, mean_deg: int, seed: int, device) -> CSR:
    """The symmetrised, de-duplicated power-law graph, built on ``device``
    and returned as a host CSR."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    deg = zipf_capped(gen, n_nodes, 1.8, max(4 * mean_deg, 8), device) + max(mean_deg - 1, 0)
    src = torch.repeat_interleave(torch.arange(n_nodes, device=device), deg)
    dst = zipf_ranks(gen, src.numel(), 1.4, device) % n_nodes
    del deg
    keep = src != dst
    src, dst = src[keep], dst[keep]
    del keep
    key = torch.cat([src * n_nodes + dst, dst * n_nodes + src])
    del src, dst
    key = torch.unique(key)  # sorted by (src, dst), duplicates dropped
    rows = key // n_nodes
    indices = (key - rows * n_nodes).int()
    del key
    indptr = torch.zeros(n_nodes + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n_nodes), 0)
    del rows
    out = CSR(indptr.cpu().numpy(), indices.cpu().numpy())
    del indptr, indices
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def build(spec: dict, seed: int, device) -> Graph:
    csr = products_graph(int(spec["n_nodes"]), int(spec["mean_deg"]), seed, device)
    facts = {"objects": csr.n_nodes, "csr_entries": csr.n_entries,
             "undirected_edges": csr.n_entries // 2}  # the graph is symmetric
    return Graph(csr.n_nodes, csr.degree(), csr, facts)
