"""Streaming metrics registry: counters, gauges, log-bucketed histograms.

One shared substrate for the quantities every subsystem used to count in
its own ad-hoc stats object (``TRANSFER``, ``GreedyStats``,
``StreamStats``, ``SimReport``, ``AdaptationReport``).  Those objects keep
their public APIs; when the plane is enabled (``repro_torch.obs.enabled()``)
they *additionally* register onto the global :data:`REGISTRY`, so one
``REGISTRY.snapshot()`` names every counter in the system.

Design constraints:

* **zero overhead when disabled** — instruments are plain attribute
  mutations; hot paths hold an instrument reference (or skip the call
  entirely behind ``obs.enabled()``), never a registry lookup;
* **streaming** — a :class:`Histogram` is log-bucketed: values land in
  geometric buckets ``lo * growth^i``, so percentile queries cost O(#
  buckets), memory is bounded by the dynamic range, and the worst-case
  percentile error is *one bucket width* (relative error ``growth - 1``);
* **exact-parity merges** — two histograms with the same bucket geometry
  merge by adding bucket counts, so ``merge(a, b).percentile(q)`` is
  *bit-identical* to the percentile of one histogram fed both streams —
  the property that makes per-shard / per-phase histograms aggregable
  without re-recording (and what the tests assert).
"""
from __future__ import annotations

import dataclasses
import math
import threading

import numpy as np

__all__ = [
    "COMPILE_COUNTER",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "install_compile_hook",
]


@dataclasses.dataclass
class Counter:
    """Monotone accumulator (occurrences, bytes, readbacks, ...)."""

    name: str
    value: float = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def snapshot(self):
        return self.value


@dataclasses.dataclass
class Gauge:
    """Last-write-wins instantaneous value (overlap won, utilization, ...)."""

    name: str
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def add(self, v: float) -> None:
        self.value += float(v)

    def snapshot(self):
        return self.value


class Histogram:
    """Log-bucketed streaming histogram with exact-parity merge.

    Bucket ``i >= 1`` covers ``(lo * growth^(i-1), lo * growth^i]``;
    bucket 0 covers ``(-inf, lo]`` (zeros and small values).  A recorded
    value only moves a bucket count, the running sum, and min/max, so
    recording a numpy batch is vectorized (:meth:`record_many`).

    Percentiles return the *upper edge* of the bucket holding the
    rank-``q`` sample, hence are within one log-bucket of the exact
    order statistic — ``growth`` bounds the relative error (default 1.1:
    p99 within 10% multiplicative, far tighter than the factor-level
    differences the tail benchmarks reason about).
    """

    def __init__(self, name: str, lo: float = 1.0, growth: float = 1.1):
        if lo <= 0 or growth <= 1.0:
            raise ValueError("need lo > 0 and growth > 1")
        self.name = name
        self.lo = float(lo)
        self.growth = float(growth)
        self._log_g = math.log(growth)
        self.counts: dict[int, int] = {}
        self.n = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- bucket geometry ---------------------------------------------------
    def bucket_index(self, v: float) -> int:
        """Index of the bucket covering ``v`` (0 for v <= lo)."""
        if v <= self.lo:
            return 0
        # 1e-9 slack keeps exact bucket edges lo * growth^k in bucket k
        # despite float log rounding (edge values are adversarial inputs)
        return max(0, math.ceil(math.log(v / self.lo) / self._log_g - 1e-9))

    def bucket_upper(self, i: int) -> float:
        return self.lo * self.growth**i

    # -- recording ---------------------------------------------------------
    def record(self, v: float) -> None:
        i = self.bucket_index(v)
        self.counts[i] = self.counts.get(i, 0) + 1
        self.n += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def record_many(self, values: np.ndarray) -> None:
        a = np.asarray(values, np.float64).ravel()
        if a.size == 0:
            return
        small = a <= self.lo
        idx = np.zeros(a.shape, np.int64)
        with np.errstate(divide="ignore"):
            idx[~small] = np.maximum(
                0,
                np.ceil(
                    np.log(a[~small] / self.lo) / self._log_g - 1e-9
                ).astype(np.int64),
            )
        for i, c in zip(*np.unique(idx, return_counts=True)):
            self.counts[int(i)] = self.counts.get(int(i), 0) + int(c)
        self.n += int(a.size)
        self.sum += float(a.sum())
        self.min = min(self.min, float(a.min()))
        self.max = max(self.max, float(a.max()))

    # -- queries -----------------------------------------------------------
    def percentile(self, q: float) -> float | None:
        """Upper edge of the bucket holding the rank-``q`` sample."""
        if self.n == 0:
            return None
        # rank of the order statistic (1-based ceil — the 'inverted CDF'
        # convention; merge parity holds because the rank only depends on
        # the merged counts)
        rank = max(1, math.ceil(self.n * q / 100.0))
        cum = 0
        for i in sorted(self.counts):
            cum += self.counts[i]
            if cum >= rank:
                return self.bucket_upper(i)
        return self.bucket_upper(max(self.counts))  # pragma: no cover

    @property
    def mean(self) -> float | None:
        return self.sum / self.n if self.n else None

    def merge(self, other: "Histogram") -> "Histogram":
        """Exact-parity merge: identical to having recorded both streams."""
        if (self.lo, self.growth) != (other.lo, other.growth):
            raise ValueError("histograms must share bucket geometry to merge")
        out = Histogram(self.name, self.lo, self.growth)
        out.counts = dict(self.counts)
        for i, c in other.counts.items():
            out.counts[i] = out.counts.get(i, 0) + c
        out.n = self.n + other.n
        out.sum = self.sum + other.sum
        out.min = min(self.min, other.min)
        out.max = max(self.max, other.max)
        return out

    def snapshot(self) -> dict:
        return {
            "count": self.n,
            "sum": self.sum,
            "min": self.min if self.n else None,
            "max": self.max if self.n else None,
            "mean": self.mean,
            "p50": self.percentile(50.0),
            "p99": self.percentile(99.0),
            "p999": self.percentile(99.9),
        }


class MetricsRegistry:
    """Named instrument store (get-or-create; names are dot-paths).

    The registry is only touched at instrument-acquisition time — hot
    loops keep the returned object and mutate it directly.  ``snapshot``
    returns a plain JSON-serializable dict (the nightly metrics
    artifact); ``reset`` drops all instruments (tests).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, object] = {}

    def _get(self, name: str, factory):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = factory()
                self._instruments[name] = inst
            return inst

    def counter(self, name: str) -> Counter:
        c = self._get(name, lambda: Counter(name))
        if not isinstance(c, Counter):
            raise TypeError(f"{name!r} is already a {type(c).__name__}")
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._get(name, lambda: Gauge(name))
        if not isinstance(g, Gauge):
            raise TypeError(f"{name!r} is already a {type(g).__name__}")
        return g

    def histogram(
        self, name: str, lo: float = 1.0, growth: float = 1.1
    ) -> Histogram:
        h = self._get(name, lambda: Histogram(name, lo, growth))
        if not isinstance(h, Histogram):
            raise TypeError(f"{name!r} is already a {type(h).__name__}")
        return h

    def names(self) -> list[str]:
        return sorted(self._instruments)

    def snapshot(self) -> dict:
        return {
            name: inst.snapshot()
            for name, inst in sorted(self._instruments.items())
        }

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()


# The port compiles nothing per call: its one compile step is the nvcc
# build of the CUDA kernels (``repro_torch.kernels.build``), run once per
# source hash.  The hook counts those builds, where the JAX package counts
# jit cache misses; a cached library fires nothing.
_compile_hook_installed = False


def install_compile_hook(registry: MetricsRegistry | None = None):
    """Count kernel-library builds into ``<registry>.repro.kernels.builds``.

    Idempotent; returns the counter.  A build fires only when
    ``kernels.build.build`` actually runs ``nvcc`` (no card, no build).
    The counter object stays live across ``registry.reset()`` — callers
    snapshot deltas around the region they care about.
    """
    global _compile_hook_installed
    from repro_torch import obs  # local: the package-level default registry
    from repro_torch.kernels import build as _build  # local: imports torch

    reg = registry or obs.REGISTRY
    counter = reg.counter(COMPILE_COUNTER)
    if _compile_hook_installed:
        return counter

    def _listener(seconds: float) -> None:
        # re-fetch through the *current* registry so a reset() between
        # install and the build doesn't strand increments on a dropped
        # counter object
        reg.counter(COMPILE_COUNTER).inc()

    _build.BUILD_LISTENERS.append(_listener)
    _compile_hook_installed = True
    return counter


COMPILE_COUNTER = "repro.kernels.builds"
