"""The storage function f(v): an object's record plus its adjacency list,
``unit + per_edge * degree`` (float64), the degree being every edge the
graph stores with the object."""
from __future__ import annotations

import numpy as np


def sizes(degree: np.ndarray, spec: dict) -> np.ndarray:
    return (float(spec["unit"]) + float(spec["per_edge"]) * degree).astype(np.float64)
