"""The benchmark's inputs: one general generator that reads a
configuration file (the deployment: graph, sharding, sizes, routing) and a
traffic file (the queries a drive provisions and its latency bound).

Every piece is found by its name in those files: the graph generator in
``bench/gen/graph/<generator>.py`` (``build(spec, seed, device)``), the
traffic kind in ``bench/gen/traffic/<kind>.py`` (``draw(traffic, graph,
seed)``), the sharding in ``bench/gen/sharding/<kind>.py`` (``home(n,
spec)``) and the storage function in ``bench/gen/sizes/<kind>.py``
(``sizes(degree, spec)``).  A new deployment or mix of an existing kind
is a new data file; a new kind is a new module beside these.

The deployment's data (the graph and the pool of queries a drive
provisions) comes from the configuration's ``data_seed``, so every run
provisions the same work.  The run's seed draws the order in which the
query sequences arrive, anew for each drive (``order``): the order
decides how the greedy's batches fall, and so the scheme it must choose.
"""
from __future__ import annotations

import dataclasses
import importlib
import re

import numpy as np

from bench.gen import common

_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


@dataclasses.dataclass(frozen=True)
class Inputs:
    """What a drive hands the program: the pool of paths (in the data's
    order), the sharding d (``home``), the storage function f (float64),
    the server count, the latency bound t and the routing policy; and the
    precision the configuration states for the candidate costs."""

    pool: common.Paths
    home: np.ndarray
    f: np.ndarray
    n_servers: int
    t: int
    policy: str
    cost_precision: str
    facts: dict


def module(family: str, name: str):
    """``bench/gen/<family>/<name>.py``."""
    if not _NAME.match(name):
        raise ValueError(f"bad {family} name {name!r}")
    return importlib.import_module(f"bench.gen.{family}.{name}")


def make_inputs(cfg: dict, traffic: dict, device) -> Inputs:
    data_seed = int(cfg["data_seed"])
    graph = module("graph", cfg["graph"]["generator"]).build(cfg["graph"], data_seed, device)
    sh, sz = cfg["sharding"], cfg["sizes"]
    home = module("sharding", sh["kind"]).home(graph.n_nodes, sh)
    f = module("sizes", sz["kind"]).sizes(graph.degree, sz)
    pool = module("traffic", traffic["kind"]).draw(traffic, graph, data_seed)
    facts = {**graph.facts, "paths": pool.n_paths, "max_len": int(pool.objects.shape[1])}
    return Inputs(pool, home, f, int(sh["n_servers"]), int(traffic["t"]), str(cfg["routing"]),
                  str(cfg["cost_precision"]), facts)


def order(inputs: Inputs, seed: int, drive: int) -> common.Paths:
    """The pool's paths in drive ``drive``'s order under the run's seed."""
    return common.shuffle_queries(inputs.pool, [seed & (2**64 - 1), 4, drive])
