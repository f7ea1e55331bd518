"""What the span readers share: the program's span log
(``repro_torch.obs.SPANS``, recorded while the traced window's profiler
runs), summed by name over each drive's interval, ``[start, end]`` on the
``time.perf_counter`` clock (``SpanLog.summary``).  Every reader gives the
mean over the window's drives, and nothing where the program keeps no
such log or the log holds no span of the window (an untraced run)."""

#: a drive's top-level spans: its ``replicate_workload`` and its
#: feasibility check
TOP = ("greedy.replicate_workload", "feasible")


def _log():
    from repro_torch import obs

    return getattr(obs, "SPANS", None)


def _drives(run):
    """Each drive's summary by span name, or None without any span."""
    log = _log()
    if log is None:
        return None
    rows = [log.summary(d["start"], d["end"]) for d in run.drives]
    return rows if any(rows) else None


def seconds(run, name: str, field: str = "total_s"):
    """Seconds per drive of the spans ``name``: their whole time
    (``total_s``) or their self time (``self_s``: less their children's)."""
    rows = _drives(run)
    if rows is None:
        return None
    return sum(r[name][field] for r in rows if name in r) / len(rows)


def count(run, *counters: str, scale: float = 1.0):
    """The change of the program's ``counters``, summed, per drive and times
    ``scale``, over the drive's top-level spans."""
    rows = _drives(run)
    if rows is None:
        return None
    return sum(r[n][c] for r in rows for n in TOP if n in r for c in counters) / len(rows) * scale
