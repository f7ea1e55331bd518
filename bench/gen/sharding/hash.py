"""Hash sharding d(v): a frozen copy of the program's ``hash_partition``
(a splittable-mix hash of the object id, modulo the server count)."""
from __future__ import annotations

import numpy as np


def home(n_nodes: int, spec: dict) -> np.ndarray:
    """int32 [n] home servers over ``spec["n_servers"]`` servers."""
    v = np.arange(n_nodes, dtype=np.uint64)
    z = v + np.uint64(int(spec["seed"])) * np.uint64(0x9E3779B97F4A7C15) + np.uint64(1)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(int(spec["n_servers"]))).astype(np.int32)
