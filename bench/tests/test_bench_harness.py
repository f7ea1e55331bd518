"""The benchmark's definition resolves by name, meets the contract's
shape, and a run of a cell (cut to the CPU's size) judges itself correct."""
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from bench import gen, harness
from bench.reference import greedy

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_has_the_contract_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert (ROOT / "bench" / "run.py").is_file()


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units_are_well_formed(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for e in SPEC[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_every_config_file_holds_its_configuration():
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and c["file"].startswith("bench/")
        assert set(c["reduced"]) <= set(cfg) | set(cfg["graph"])
        assert cfg["guarantees"] and cfg["routing"] in greedy.POLICIES
        assert cfg["cost_precision"] in greedy.PRECISIONS
        for family, name in (("graph", cfg["graph"]["generator"]),
                             ("sharding", cfg["sharding"]["kind"]),
                             ("sizes", cfg["sizes"]["kind"])):
            assert gen.module(family, name)


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves_by_name(cell):
    c = harness.load_cell(cell)
    assert c.chips in (1, 4)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer
    assert set(c.limits) == {"mask_cells_off", "paths_over_t", "homes_missing",
                             "overhead_gap", "feasible_off"}
    assert c.reference_drives >= 1
    assert callable(gen.module("traffic", c.traffic["kind"]).draw)
    drive = harness.drive_module(c.traffic)
    assert drive.FAILED in c.limits and callable(drive.run) and callable(drive.judge)
    for m in c.end_to_end:
        assert callable(harness.reader(m["name"]))
    for m in c.per_layer:
        assert m["moves"] in {e["name"] for e in c.end_to_end}
        assert callable(harness.reader(m["name"]))


def test_four_chip_cells_are_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def _fake_run(drives, trace=None, references=(), window_s=0.0, setup_s=0.0):
    return harness.Run(inputs=None, drives=drives, trace=trace, references=list(references),
                       window_s=window_s, setup_s=setup_s)


def test_drive_readers_take_means_over_the_drives():
    drives = [
        {"stage_s": {"gate": 0.1, "update": 0.2, "revalidate": 0.05, "prune": 0.4},
         "replicate_s": 1.0, "feasible_s": 0.2, "h2d_bytes": 2_000_000, "launches": 40},
        {"stage_s": {"gate": 0.1, "update": 0.0, "revalidate": 0.05, "prune": 0.6},
         "replicate_s": 1.2, "feasible_s": 0.4, "h2d_bytes": 4_000_000, "launches": 44},
    ]
    run = _fake_run(drives)
    assert harness.reader("greedy.update_s")(run) == pytest.approx(0.2)
    assert harness.reader("greedy.unstaged_s")(run) == pytest.approx((0.25 + 0.45) / 2)
    assert harness.reader("prune.s")(run) == pytest.approx(0.5)
    assert harness.reader("feasible.s")(run) == pytest.approx(0.3)
    assert harness.reader("engine.h2d_mb")(run) == pytest.approx(3.0)
    assert harness.reader("engine.launches")(run) == pytest.approx(42)


def test_end_to_end_readers_take_the_whole_window():
    drives = [{"paths": 100, "overhead": 0.1}, {"paths": 100, "overhead": 0.2},
              {"paths": 100, "overhead": 0.3}]
    run = _fake_run(drives, window_s=1.5, setup_s=12.5)
    assert harness.reader("provision_paths_per_s")(run) == pytest.approx(200.0)
    assert harness.reader("storage_overhead")(run) == pytest.approx(0.2)
    assert harness.reader("setup_s")(run) == 12.5


def test_the_counters_resolve_in_the_program():
    read = harness.counter_reader()
    got = read()
    assert set(got) == {"h2d_bytes", "launches"}
    assert all(isinstance(v, int) and v >= 0 for v in got.values())


def test_an_unknown_policy_or_precision_is_refused():
    o = np.array([[0, 1]], np.int32)
    ln = np.array([2], np.int32)
    home = np.array([0, 1], np.int32)
    f = np.ones(2)
    with pytest.raises(ValueError, match="routing policy"):
        greedy.provision(o, ln, home, 2, 1, f, torch.device("cpu"), policy="nearest_copy_dp")
    with pytest.raises(ValueError, match="cost precision"):
        greedy.provision(o, ln, home, 2, 1, f, torch.device("cpu"), precision="bfloat16")


def test_trace_readers_read_nothing_without_a_trace():
    run = _fake_run([{}])
    for name in ("prune_walk_roofline", "fused_update_roofline", "device.idle"):
        assert harness.reader(name)(run) is None


def test_device_idle_from_busy_and_window():
    run = _fake_run([{}], trace={"busy_s": 0.25, "window_s": 2.0, "ops": []})
    assert harness.reader("device.idle")(run) == pytest.approx(87.5)


def test_a_cpu_run_of_a_cut_cell_is_correct(snb_cell):
    out = harness.run_cell(snb_cell, 2**33 + 7, 0.0, False, torch.device("cpu"), 0.0,
                           log=lambda m: None)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"provision_paths_per_s", "storage_overhead", "setup_s"}
    assert 0 < out["metrics"]["storage_overhead"]["value"] < 1


def test_read_trace_takes_device_ops_and_names_gaps():
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def ev(name, a, b, dev=DeviceType.CPU):
        return NS(name=name, device_type=dev, time_range=NS(start=a, end=b))

    events = [ev("bench.replicate_workload", 0, 100), ev("bench.is_latency_feasible", 100, 150),
              ev("bench.replicate_workload", 0, 100, DeviceType.CUDA),
              ev("void (anonymous namespace)::k1<int>(int*)", 10, 30, DeviceType.CUDA),
              ev("Memcpy HtoD", 40, 50, DeviceType.CUDA), ev("aten::add", 5, 6)]
    tr = harness.read_trace(NS(events=lambda: events))
    assert tr["window_s"] == pytest.approx(150e-6) and tr["busy_s"] == pytest.approx(30e-6)
    assert tr["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    assert tr["idle_gaps"][0] == ["after Memcpy HtoD, replicate_workload -> between drives",
                                  pytest.approx(100e-6)]
    assert len(tr["idle_gaps"]) == 3
