"""Both packages behind one interface, for the serving-stack parity tests
(``tests/test_torch_{batching,simulator,controller}.py``).

A case is written once as a function of a :class:`Side` and runs on the
JAX package (``JAX``: the jnp walks, the JAX engine's default ``jnp``
backend) and on the port (``PORT``: ``device="cpu"``, the torch backend).
Inputs are numpy arrays made from a seed; each side builds its own
``PathSet`` / ``ReplicationScheme`` / ``Cluster`` from copies, because a
run mutates its cluster (queue depths, liveness under chaos) and its
hedge policy.  ``assert_sim_equal`` / ``assert_adapt_equal`` hold two
reports equal field by field, bit for bit (``AdaptationReport.runtime_s``,
a ``perf_counter`` reading, excepted).
"""
from __future__ import annotations

import dataclasses

import numpy as np

import repro.core as R
import repro.distsys as RD
import repro.engine as RE
import repro.obs as RO
import repro.serve as RS
import repro_torch.core as T
import repro_torch.distsys as TD
import repro_torch.engine as TE
import repro_torch.obs as TO
import repro_torch.serve as TS


@dataclasses.dataclass(frozen=True)
class Side:
    name: str
    core: object
    distsys: object
    engine: object
    obs: object
    serve: object
    kw: tuple  # extra keyword arguments of the serving entry points

    def paths(self, ps):
        return self.core.PathSet(np.array(ps.objects, np.int32), np.array(ps.lengths, np.int32),
                                 np.array(ps.query_ids, np.int32))

    def from_lists(self, paths, query_ids=None, **kw):
        return self.core.PathSet.from_lists(paths, query_ids, **kw)

    def scheme(self, mask, shard):
        return self.core.ReplicationScheme(np.array(mask, bool), np.array(shard, np.int32))

    def cluster(self, mask, shard, **kw):
        return self.distsys.Cluster(self.scheme(mask, shard), **kw)

    def simulate(self, cluster, ps, **kw):
        return self.serve.simulate(cluster, ps, **kw, **dict(self.kw))

    def harness(self, cluster, ps, **kw):
        return self.serve.harness_simulate(cluster, ps, **kw, **dict(self.kw))

    def latency_engine(self, scheme):
        if self is JAX:
            return self.engine.LatencyEngine(scheme, backend="jnp")
        return self.engine.LatencyEngine(scheme, **dict(self.kw))

    def controller(self, cluster, config, **kw):
        if self is PORT and kw.get("engine") is None:
            kw = dict(kw, **dict(self.kw))
        return self.serve.AdaptiveController(cluster, config, **kw)

    def slo(self, t_q, tenant_of, tenants):
        """``tenants``: (name, t_q, kwargs) triples."""
        table = tuple(self.core.TenantSpec(n, t, **k) for n, t, k in tenants)
        return self.core.SLOSpec(np.array(t_q, np.int32), np.array(tenant_of, np.int32), table)


JAX = Side("jax", R, RD, RE, RO, RS, ())
PORT = Side("port", T, TD, TE, TO, TS, (("device", "cpu"),))
SIDES = (JAX, PORT)


def both(case, *args, **kwargs):
    """``case(side, ...)`` on the JAX package, then on the port."""
    return case(JAX, *args, **kwargs), case(PORT, *args, **kwargs)


def _equal(x, y) -> bool:
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        x, y = np.asarray(x), np.asarray(y)
        return x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)
    if isinstance(x, (tuple, list)) and isinstance(y, (tuple, list)):
        return type(x) is type(y) and len(x) == len(y) and all(map(_equal, x, y))
    return x == y


def assert_sim_equal(a, b) -> None:
    """Every field of two ``SimReport``s (arrays dtype and bit for bit; the
    batch stats by their summary) and both ``summary()``s."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "batch_stats":
            assert (x is None) == (y is None), f.name
            if x is not None:
                assert x.summary() == y.summary(), f.name
            continue
        assert _equal(x, y), f.name
    assert a.summary() == b.summary()


def assert_adapt_equal(a, b) -> None:
    """Two ``AdaptationReport``s (or Nones) equal in every field but
    ``runtime_s``."""
    assert (a is None) == (b is None)
    if a is None:
        return
    for f in dataclasses.fields(a):
        if f.name == "runtime_s":
            continue
        assert _equal(getattr(a, f.name), getattr(b, f.name)), f.name


def spans_of(tracer) -> list:
    """The kept traces of a ``Tracer``, as plain tuples."""
    return [(qt.query, qt.failed, qt.violated, qt.shed, qt.latency_us,
             [dataclasses.astuple(s) for s in qt.spans]) for qt in tracer.traces]
