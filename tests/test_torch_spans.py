"""The port's program spans (``repro_torch.obs.span``) on the provisioning path.

A ``replicate_workload(..., fused=True, policy="nearest_copy")`` on the
``kernel`` backend's route (its wrappers run their plain versions on the
CPU), then ``is_latency_feasible``, records the tree of spans the
benchmark's span readers read, each child inside its parent; self time
plus the children's time is each span's duration; the spans that book
``GreedyStats.stage_s`` leave its keys and values as the stages'; with
the gate off nothing is recorded and no clock is read; under
``torch.profiler`` every span is a range of the trace inside the caller's;
the readback and mask-packing counters advance by what each call does,
and every whole-mask pack and unpack of the drive runs on the words'
device, with the masks the host packer gives.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import repro_torch.core as T
from conftest import random_workload
from repro_torch import obs
from repro_torch.engine import PACK, TRANSFER, LatencyEngine, PackedScheme
from repro_torch.engine.packed import n_words, pack_bool_mask, unpack_words
from repro_torch.engine.streaming import to_host
from repro_torch.obs import trace as obs_trace

CPU = "cpu"
N_OBJ, N_SRV = 120, 5

# span -> the spans it may sit in (None: a top-level span)
GREEDY = "greedy.replicate_workload"
TREE = {
    GREEDY: None,
    "greedy.dedup": {GREEDY},
    "greedy.init": {GREEDY},
    "greedy.plan": {GREEDY, "greedy.revalidate"},
    "greedy.gate": {GREEDY, "greedy.revalidate"},
    "greedy.update": {GREEDY, "greedy.revalidate"},
    "greedy.revalidate": {GREEDY},
    "greedy.unpack": {GREEDY},
    "prune": {GREEDY},
    "prune.engine": {"prune"},
    "prune.precheck": {"prune"},
    "prune.index": {"prune"},
    "prune.candidates": {"prune"},
    "prune.sweep": {"prune"},
    "prune.apply": {"prune"},
    "prune.repack": {"prune"},
    "feasible": None,
    "feasible.engine": {"feasible"},
    "feasible.walk": {"feasible"},
    "feasible.reduce": {"feasible"},
}


@pytest.fixture
def kernel_route(monkeypatch):
    """Let the ``kernel`` backend resolve on the CPU (each kernel wrapper
    runs its plain version), so the drive takes the card's route: one
    ``fused_update_class`` per class and one ``prune_sweep``."""
    from repro_torch.engine import backends

    resolve = backends.resolve_backend
    monkeypatch.setattr(backends, "resolve_backend",
                        lambda b, d: "kernel" if b in (None, "kernel") else resolve(b, d))


@pytest.fixture
def gate_on():
    was = obs.enabled()
    obs.enable()
    obs.SPANS.clear()
    try:
        yield obs.SPANS
    finally:
        (obs.enable if was else obs.disable)()
        obs.SPANS.clear()


@pytest.fixture
def gate_off():
    was = obs.enabled()
    obs.disable()
    obs.SPANS.clear()
    try:
        yield obs.SPANS
    finally:
        (obs.enable if was else obs.disable)()
        obs.SPANS.clear()


def _workload(seed=3):
    rng = np.random.default_rng(seed)
    ps, shard = random_workload(rng, n_obj=N_OBJ, n_srv=N_SRV, n_paths=140, max_len=6)
    f = rng.uniform(0.5, 2.0, N_OBJ).astype(np.float32)
    return T.PathSet(ps.objects, ps.lengths, ps.query_ids), shard, f


def _drive(ps, shard, f):
    scheme, stats = T.replicate_workload(ps, shard, N_SRV, 1, f=f, policy="nearest_copy",
                                         fused=True, device=CPU)
    ok = T.is_latency_feasible(ps, scheme, 1, policy="nearest_copy", device=CPU)
    return scheme, stats, ok


@pytest.fixture
def drive(kernel_route, gate_on):
    ps, shard, f = _workload()
    scheme, stats, ok = _drive(ps, shard, f)
    assert ok and stats.pruned_replicas > 0  # else no re-pack to record
    return gate_on.spans(), stats


def test_a_drive_records_the_named_tree(drive):
    spans, _ = drive
    by_id = {s.id: s for s in spans}
    assert {s.name for s in spans} == set(TREE)
    roots = [s for s in spans if s.parent < 0]
    assert [s.name for s in roots] == [GREEDY, "feasible"]
    for s in spans:
        if TREE[s.name] is None:
            assert s.parent == -1 and s.call == s.id
            continue
        parent = by_id[s.parent]
        assert parent.name in TREE[s.name], (s.name, parent.name)
        assert parent.start <= s.start <= s.end <= parent.end
        assert s.call == parent.call
    # one id per top-level call, shared by every span of that call
    assert {s.call for s in spans} == {r.id for r in roots}


def test_self_time_plus_children_is_the_duration(drive, gate_on):
    spans, _ = drive
    for s in spans:
        kids = sum(c.duration for c in spans if c.parent == s.id)
        assert s.self_s + kids == pytest.approx(s.duration, rel=1e-12, abs=1e-12)
        assert 0 <= s.self_s <= s.duration
    summary = gate_on.summary()
    names = {s.id: s.name for s in spans}
    for name, row in summary.items():
        kids = sum(c.duration for c in spans if c.parent >= 0 and names[c.parent] == name)
        assert row["self_s"] + kids == pytest.approx(row["total_s"], rel=1e-12, abs=1e-12)
        assert row["count"] == sum(s.name == name for s in spans)


def test_stage_s_keeps_its_keys_and_values(kernel_route, drive, gate_off):
    spans, stats = drive
    assert set(stats.stage_s) == {"gate", "update", "revalidate", "prune", "prune_walk"}
    span_of = {"gate": "greedy.gate", "update": "greedy.update",
               "revalidate": "greedy.revalidate", "prune": "prune", "prune_walk": "prune.sweep"}
    for key, name in span_of.items():
        booked = [s.duration for s in spans if s.name == name]
        assert booked and stats.stage_s[key] == pytest.approx(sum(booked), rel=1e-12)
    # the gate decides what the log keeps, not what stage_s books
    _, untraced, ok = _drive(*_workload())
    assert ok and set(untraced.stage_s) == set(stats.stage_s)
    assert len(gate_off) == 0


def test_the_gate_off_reads_no_clock_and_records_nothing(monkeypatch, kernel_route, gate_off):
    calls = []
    real = obs_trace.time.perf_counter
    monkeypatch.setattr(obs_trace.time, "perf_counter", lambda: calls.append(1) or real())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append("sync"))
    assert obs.span("a") is obs.span("b")
    with obs.span("a"):
        with obs.span("b"):
            pass
    assert calls == [] and len(gate_off) == 0
    monkeypatch.undo()
    _drive(*_workload())
    assert len(gate_off) == 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    assert not {e.name for e in prof.events()} & set(TREE)


def test_spans_are_ranges_of_the_profiler_trace(kernel_route, gate_off):
    ps, shard, f = _workload()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            _drive(ps, shard, f)
    events = prof.events()
    caller = [e for e in events if e.name == "caller"]
    assert len(caller) == 1
    lo, hi = caller[0].time_range.start, caller[0].time_range.end
    seen = {e.name for e in events if e.name in TREE and lo <= e.time_range.start
            and e.time_range.end <= hi}
    assert seen == set(TREE)
    # the profiler opened the gate: the log holds the same spans
    assert {s.name for s in gate_off.spans()} == set(TREE)


def test_counters_advance_by_what_the_calls_do(gate_on):
    rng = np.random.default_rng(1)
    mask = rng.random((37, 9)) < 0.3
    shard = rng.integers(0, 9, 37).astype(np.int32)
    mask[np.arange(37), shard] = True
    calls, packed_b, unpacked_b = TRANSFER.d2h_calls, PACK.mask_bytes_packed, \
        PACK.mask_bytes_unpacked
    with obs.span("pack"):
        words = pack_bool_mask(mask)
    assert PACK.mask_bytes_packed == packed_b + 37 * 9
    assert np.array_equal(unpack_words(words, 9), mask)
    assert PACK.mask_bytes_unpacked == unpacked_b + 37 * 9
    with obs.span("engine"):
        eng = LatencyEngine.from_arrays(mask, shard, device=CPU)
    assert PACK.mask_bytes_packed == packed_b + 2 * 37 * 9
    with obs.span("readback"):
        to_host(torch.zeros(5, dtype=torch.int32))
        assert np.array_equal(eng.host_mask(), mask)
    assert TRANSFER.d2h_calls == calls + 2
    assert PACK.mask_bytes_unpacked == unpacked_b + 2 * 37 * 9
    got = {s.name: s.counts for s in gate_on.spans()}
    assert got["pack"]["mask_bytes_packed"] == 37 * 9 and got["pack"]["d2h_calls"] == 0
    assert got["engine"]["mask_bytes_packed"] == 37 * 9
    assert got["engine"]["h2d_bytes"] > 0
    assert got["readback"]["d2h_calls"] == 2
    assert got["readback"]["d2h_bytes"] == 5 * 4 + 37 * 9  # the bool mask, a byte a cell
    assert got["readback"]["mask_bytes_unpacked"] == 37 * 9
    with TRANSFER.scope():
        to_host(torch.zeros(1))
        assert TRANSFER.d2h_calls == 1
    assert TRANSFER.d2h_calls == calls + 3


def test_device_bytes_advance_by_each_pack_and_unpack(gate_on):
    rng = np.random.default_rng(2)
    mask = rng.random((37, 40)) < 0.3
    shard = rng.integers(0, 40, 37).astype(np.int32)
    before = PACK.mask_bytes_on_device
    with obs.span("from_mask"):
        packed = PackedScheme.from_mask(mask, shard, CPU)
    assert PACK.mask_bytes_on_device == before + 37 * 40
    with obs.span("unpack"):
        assert np.array_equal(packed.unpack(), mask)
    assert PACK.mask_bytes_on_device == before + 2 * 37 * 40
    with obs.span("host"):
        unpack_words(pack_bool_mask(mask), 40)
    assert PACK.mask_bytes_on_device == before + 2 * 37 * 40
    got = {s.name: s.counts for s in gate_on.spans()}
    assert set(obs.SPAN_COUNTERS) <= set(got["host"])
    assert got["from_mask"]["mask_bytes_on_device"] == got["from_mask"]["mask_bytes_packed"] \
        == 37 * 40
    assert got["unpack"]["mask_bytes_on_device"] == got["unpack"]["mask_bytes_unpacked"] \
        == 37 * 40
    assert got["host"]["mask_bytes_on_device"] == 0
    assert got["host"]["mask_bytes_packed"] == got["host"]["mask_bytes_unpacked"] == 37 * 40


def _host_packer(monkeypatch):
    """``PackedScheme.from_mask`` / ``.unpack`` as they were before the bit
    work moved to the words' device: :func:`pack_bool_mask` and an upload
    of the words, a readback of the words and :func:`unpack_words`."""

    def from_mask(cls, mask, shard, device=None):
        n, S = mask.shape
        host = np.zeros((n + 1, n_words(S)), dtype=np.uint32)
        host[:n] = pack_bool_mask(np.asarray(mask, dtype=bool))
        return cls.from_numpy(host, shard, device, n_servers=S)

    def unpack(self):
        return unpack_words(to_host(self.words[: self.n_objects]), self.n_servers)

    monkeypatch.setattr(PackedScheme, "from_mask", classmethod(from_mask))
    monkeypatch.setattr(PackedScheme, "unpack", unpack)


def test_a_drive_packs_and_unpacks_on_the_device_only(monkeypatch, kernel_route):
    """Every whole-mask pass of a fused nearest_copy drive and its check
    does its bit work on the device: the device bytes equal the packed
    plus the unpacked, and the scheme equals the host packer's."""
    ps, shard, f = _workload()
    counts = lambda: (PACK.mask_bytes_packed, PACK.mask_bytes_unpacked,  # noqa: E731
                      PACK.mask_bytes_on_device)
    before = counts()
    scheme, stats, ok = _drive(ps, shard, f)
    packed, unpacked, on_device = (b - a for a, b in zip(before, counts()))
    assert ok and stats.pruned_replicas > 0
    assert packed > 0 and unpacked > 0
    assert on_device == packed + unpacked
    with monkeypatch.context() as m:
        _host_packer(m)
        before = counts()
        want, want_stats, want_ok = _drive(ps, shard, f)
        host = [b - a for a, b in zip(before, counts())]
    assert host == [packed, unpacked, 0]
    assert want_ok and np.array_equal(scheme.mask, want.mask)
    assert stats.replicas == want_stats.replicas
    assert stats.pruned_replicas == want_stats.pruned_replicas


def test_the_log_is_bounded_filtered_and_exported(gate_on):
    log = obs.SpanLog(maxlen=4)
    opened = []
    for k in range(6):
        o = log.open(f"s{k}")
        opened.append(o.start)
        log.close(o, o.start + 1e-3)
    assert len(log) == 4 and [s.name for s in log.spans()] == ["s2", "s3", "s4", "s5"]
    assert [s.name for s in log.spans(opened[3], opened[5])] == ["s3", "s4"]
    row = log.summary(opened[3], opened[5])["s3"]
    assert row["count"] == 1 and row["total_s"] == pytest.approx(1e-3)
    ev = log.chrome_trace()["traceEvents"]
    assert [e["name"] for e in ev] == ["s2", "s3", "s4", "s5", "process_name"]
    assert all(e["pid"] == obs_trace.PROGRAM_PID for e in ev)
    assert ev[0]["dur"] == pytest.approx(1e3) and ev[0]["tid"] == ev[0]["args"]["id"]
