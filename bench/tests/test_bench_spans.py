"""The readers of the program's span log: each is the mean over the
window's drives of the spans that start inside the drive, nothing where
the log is empty (an untraced run) or the program keeps none (a parent
without the log), and a traced run of a cut cell gives every one."""
import json
import pathlib
from types import SimpleNamespace as NS

import pytest
import torch

from bench import harness
from bench import spans as bench_spans
from repro_torch import obs

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = ["snb_sf1.provision.t1", "gnnprod.provision.t1"]
SPAN_METRICS = ("greedy.self_s", "greedy.dedup_s", "greedy.init_s", "greedy.plan_s",
                "greedy.unpack_s", "prune.engine_s", "prune.precheck_s", "prune.index_s",
                "prune.candidates_s", "prune.sweep_s", "prune.repack_s", "feasible.engine_s",
                "feasible.walk_s")
COUNTER_METRICS = ("engine.d2h_mb", "engine.readbacks", "engine.mask_pack_mb")
NEW = SPAN_METRICS + COUNTER_METRICS


class FakeLog:
    """A span log holding the given spans, summed as the program's is."""

    summary = obs.SpanLog.summary

    def __init__(self, spans):
        self._spans = spans

    def spans(self, t0, t1):
        return [s for s in self._spans if t0 <= s.start < t1]


def _span(name, start, end, child_s=0.0, **counts):
    full = dict.fromkeys(obs.SPAN_COUNTERS, 0)
    full.update(counts)
    return NS(name=name, start=start, end=end, duration=end - start,
              self_s=end - start - child_s, counts=full)


def _run(drives):
    return harness.Run(inputs=None, drives=drives, trace=None, references=[])


@pytest.fixture
def two_drives(monkeypatch):
    """Two drives, [0, 10) and [10, 20), and spans outside both."""
    spans = [
        _span("greedy.replicate_workload", 0.5, 7.5, child_s=5.0, d2h_bytes=3_000_000,
              d2h_calls=4, mask_bytes_packed=2_000_000, mask_bytes_unpacked=1_000_000),
        _span("greedy.dedup", 0.6, 1.1),
        _span("prune.engine", 2.0, 3.0),
        _span("prune.sweep", 3.0, 3.25),
        _span("feasible", 7.5, 9.5, child_s=1.5, d2h_bytes=1_000_000, d2h_calls=1,
              mask_bytes_packed=1_000_000),
        _span("feasible.engine", 7.6, 8.6),
        _span("greedy.replicate_workload", 10.5, 16.5, child_s=4.0, d2h_bytes=5_000_000,
              d2h_calls=6, mask_bytes_packed=2_000_000, mask_bytes_unpacked=1_000_000),
        _span("greedy.dedup", 10.6, 11.6),
        _span("prune.engine", 12.0, 12.5),
        _span("feasible", 16.5, 19.5, child_s=2.0, d2h_bytes=1_000_000, d2h_calls=1,
              mask_bytes_packed=1_000_000),
        # before the window and after it: the warm-up drive, the reference
        _span("greedy.replicate_workload", -9.0, -1.0, d2h_bytes=7, d2h_calls=7),
        _span("prune.engine", 25.0, 40.0),
    ]
    monkeypatch.setattr(bench_spans, "_log", lambda: FakeLog(spans))
    return _run([{"start": 0.0, "end": 10.0}, {"start": 10.0, "end": 20.0}])


def test_the_span_readers_take_the_mean_over_the_drives(two_drives):
    read = {m: harness.reader(m) for m in NEW}
    assert read["greedy.self_s"](two_drives) == pytest.approx((2.0 + 2.0) / 2)
    assert read["greedy.dedup_s"](two_drives) == pytest.approx((0.5 + 1.0) / 2)
    assert read["feasible.engine_s"](two_drives) == pytest.approx(1.0 / 2)
    assert read["prune.sweep_s"](two_drives) == pytest.approx(0.25 / 2)
    assert read["prune.repack_s"](two_drives) == 0.0  # a span no drive made
    assert read["engine.d2h_mb"](two_drives) == pytest.approx((4.0 + 6.0) / 2)
    assert read["engine.readbacks"](two_drives) == pytest.approx((5 + 7) / 2)
    assert read["engine.mask_pack_mb"](two_drives) == pytest.approx((4.0 + 4.0) / 2)


def test_the_span_readers_keep_to_each_drive(two_drives):
    """A span counts in the drive it starts in, and not at all outside
    every drive (the 15-s ``prune.engine`` after the window)."""
    assert harness.reader("prune.engine_s")(two_drives) == pytest.approx((1.0 + 0.5) / 2)
    one = _run(two_drives.drives[1:])
    assert harness.reader("prune.engine_s")(one) == pytest.approx(0.5)
    assert harness.reader("engine.readbacks")(one) == pytest.approx(7)


def test_the_span_readers_read_nothing_without_spans(monkeypatch):
    run = _run([{"start": 0.0, "end": 10.0}])
    monkeypatch.setattr(bench_spans, "_log", lambda: FakeLog([_span("x", 11.0, 12.0)]))
    for m in NEW:
        assert harness.reader(m)(run) is None, m
    monkeypatch.undo()
    monkeypatch.delattr(obs, "SPANS")  # a program without the span log
    for m in NEW:
        assert harness.reader(m)(run) is None, m


def test_every_span_metric_is_declared_with_its_reader():
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    for name in SPAN_METRICS:
        assert entries[name]["source"] == "program_span" and entries[name]["unit"] == "s/drive"
    for name in COUNTER_METRICS:
        assert entries[name]["source"] == "program_counter"
    for name in NEW:
        m = entries[name]
        assert m["workloads"] == CELLS and m["moves"] == "provision_paths_per_s"
        assert callable(harness.reader(name))
        for cell in CELLS:
            assert m["moves"] in {e["name"] for e in harness.load_cell(cell).end_to_end}


def test_a_traced_cpu_run_of_a_cut_cell_gives_every_span_metric(snb_cell):
    out = harness.run_cell(snb_cell, 2**33 + 11, 0.0, True, torch.device("cpu"), 0.0,
                           log=lambda m: None)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for name in NEW:
        assert got[name]["value"] is not None and got[name]["value"] >= 0, name
    # the torch backend prunes by independent groups: no sweep call here
    assert got["prune.sweep_s"]["value"] == 0.0
    for name in ("greedy.self_s", "greedy.init_s", "prune.engine_s", "feasible.walk_s",
                 "engine.d2h_mb", "engine.readbacks", "engine.mask_pack_mb"):
        assert got[name]["value"] > 0, name
