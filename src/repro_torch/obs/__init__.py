"""Unified telemetry plane: metrics registry, span tracing, burn-rate blame.

The paper's subject is the *tail*, yet before this package the repo could
only report tails as opaque p99 scalars — every subsystem grew its own
ad-hoc counters (``TRANSFER``, ``GreedyStats``, ``StreamStats``,
``SimReport``, ``AdaptationReport``) with no shared substrate, and nothing
could say **which server, hop, or tenant** put a query over its t_Q
budget.  Three layers, one gate:

  metrics   — :class:`MetricsRegistry` of counters / gauges /
              log-bucketed streaming :class:`Histogram`\\ s (exact-parity
              merges, percentile within one bucket of exact); the global
              :data:`REGISTRY` is what the ad-hoc stats objects
              additionally register onto
  trace     — hop-level :class:`Span` / :class:`Tracer`: the executor and
              the serving simulator emit one span per access (hop,
              server, object, local/remote, queue-wait vs service
              split), ring-buffer sampled head + tail-biased — a query
              that violated its t_Q is never dropped — exportable as
              Chrome ``trace_event`` JSON
  burnrate  — :func:`attribute_burn` folds spans into per-tenant SLO
              burn rates with a per-server/per-hop blame decomposition
              (which hop's queue wait ate the budget)

Gate: the plane is **off by default** and costs nothing when off — hot
paths check :func:`enabled` once (or a ``tracer is not None`` argument)
and skip all recording.  ``REPRO_OBS=1`` in the environment enables it at
import; ``enable()`` / ``disable()`` toggle it at runtime.  Span tracing
is pay-per-use regardless of the gate (pass a ``Tracer``).  The names
the port records match the JAX package's (``repro.engine.inc_*``,
``repro.greedy.*``, ``repro.stream.*``), so the two registries compare
name for name; the compile hook counts the CUDA kernel builds
(``repro.kernels.builds``).
"""
from __future__ import annotations

import os

from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    install_compile_hook,
)
from repro_torch.obs.trace import QueryTrace, Span, Tracer, chrome_trace
from repro_torch.obs.burnrate import BurnReport, HopBlame, TenantBurn, attribute_burn

__all__ = [
    "REGISTRY",
    "enabled",
    "enable",
    "disable",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "install_compile_hook",
    "Span",
    "QueryTrace",
    "Tracer",
    "chrome_trace",
    "HopBlame",
    "TenantBurn",
    "BurnReport",
    "attribute_burn",
]

#: The process-global registry every instrumented subsystem records into.
REGISTRY = MetricsRegistry()

_enabled = os.environ.get("REPRO_OBS", "") not in ("", "0", "false")


def enabled() -> bool:
    """Whether passive metrics recording is on (off = zero overhead)."""
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False
