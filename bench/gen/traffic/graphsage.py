"""GraphSAGE node-wise sampling as causal access paths: a frozen copy of
the program's ``workload/gnn.py`` sampler.  Each seed node's access tree
is seed -> up to ``fanouts[0]`` neighbours -> up to ``fanouts[1]``
neighbours of each, one path per leaf (Def 4.1); the seeds of a drive
are drawn uniformly without replacement.
"""
from __future__ import annotations

import numpy as np

from bench.gen.common import CSR, Graph, Paths, paths_from_lists


def draw(traffic: dict, graph: Graph, seed) -> Paths:
    rng = np.random.default_rng([seed, 2])
    seeds = rng.choice(graph.n_nodes, size=int(traffic["seeds_per_drive"]), replace=False)
    return sage_paths(graph.data, seeds, tuple(traffic["fanouts"]), [seed, 3])


def sage_paths(g: CSR, seeds: np.ndarray, fanouts: tuple, seed: int) -> Paths:
    """One path per leaf of each seed's sampled access tree; a vertex with
    more neighbours than the fan-out samples without replacement."""
    rng = np.random.default_rng(seed)
    paths, qids = [], []
    for q, s in enumerate(seeds):
        s = int(s)
        nbr1 = g.neighbors(s)
        if len(nbr1) > fanouts[0]:
            nbr1 = rng.choice(nbr1, size=fanouts[0], replace=False)
        got = []
        if len(nbr1) == 0:
            got.append([s])
        elif len(fanouts) == 1:
            got.extend([s, int(v)] for v in nbr1)
        else:
            for v1 in nbr1:
                nbr2 = g.neighbors(int(v1))
                if len(nbr2) > fanouts[1]:
                    nbr2 = rng.choice(nbr2, size=fanouts[1], replace=False)
                if len(nbr2) == 0:
                    got.append([s, int(v1)])
                else:
                    got.extend([s, int(v1), int(v2)] for v2 in nbr2)
        paths.extend(got)
        qids.extend([q] * len(got))
    return paths_from_lists(paths, qids)
