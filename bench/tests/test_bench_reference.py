"""The plain reference: a hand-worked case, the judge flagging a scheme
with one copy removed, agreement with the port's kernel path (its plain
versions, on the CPU), and the lower-precision control failing."""
import numpy as np
import torch

from bench import control, harness
from bench.reference import check, greedy
from bench.reference.walk import bits_of, hops, hops_one
from bench.tests.conftest import cut_snb

CPU = torch.device("cpu")
# 3 servers; objects 0..5 with homes 0, 1, 2, 0, 1, 2
HOME = np.array([0, 1, 2, 0, 1, 2], np.int32)
F = np.array([1, 2, 1, 1, 1, 1], np.float32)
# A = 0 1 2 (h 2), its duplicate 3 1 2 (same root server and tail),
# B = 3 4 (h 1), C = 5 0 1 (h 2)
OBJECTS = np.array([[0, 1, 2], [3, 1, 2], [3, 4, -1], [5, 0, 1]], np.int32)
LENGTHS = np.array([3, 3, 2, 3], np.int32)


def _hops(mask):
    return hops(torch.from_numpy(OBJECTS), torch.from_numpy(LENGTHS), torch.from_numpy(mask),
                torch.from_numpy(HOME.astype(np.int64))).tolist()


def _homes():
    m = np.zeros((6, 3), bool)
    m[np.arange(6), HOME] = True
    return m


def test_walk_counts_by_hand():
    m = _homes()
    assert _hops(m) == [2, 2, 1, 2]
    m[2, 1] = True  # 2 copied beside 1: A's walk stays on server 1
    assert _hops(m) == [1, 1, 1, 2]
    m[0, 2] = True  # 0 copied to C's root server
    assert _hops(m) == [1, 1, 1, 1]
    bits = bits_of(m)
    assert [hops_one(p[:k], bits, HOME.tolist(), 9) for p, k in
            zip(OBJECTS.tolist(), LENGTHS.tolist())] == [1, 1, 1, 1]


def test_dedup_keeps_the_first_of_each_class():
    assert greedy.dedup_paths(OBJECTS, LENGTHS, HOME, 1).tolist() == [0, 2, 3]


def test_provision_by_hand():
    # A: retaining subpath 1 copies 2 to server 1 (cost f2 = 1), retaining
    # subpath 2 copies 1 to server 0 (f1 = 2): the first wins.  C:
    # retaining subpath 1 copies 1 to server 0 (2), retaining subpath 2
    # copies 0 to server 2 (f0 = 1): the second wins.  Both are priced on
    # the bare sharding in one batch; the prune keeps both copies.
    ref = greedy.provision(OBJECTS, LENGTHS, HOME, 3, 1, F, CPU)
    want = _homes()
    want[2, 1] = want[0, 2] = True
    assert np.array_equal(ref["pre_prune"], want) and np.array_equal(ref["mask"], want)
    assert ref["violations"] == 0
    assert ref["prune"]["cand_v"].tolist() == [0, 2]
    assert not ref["prune"]["dropped"].any()
    assert ref["classes"][0]["additions"] == [2]


def test_the_judge_flags_a_scheme_with_one_copy_removed():
    ref = greedy.provision(OBJECTS, LENGTHS, HOME, 3, 1, F, CPU)
    f64 = F.astype(np.float64)
    good = check.judge(OBJECTS, LENGTHS, HOME, f64, 1, [ref["mask"]],
                       [check.overhead(ref["mask"], f64)], [True], {0: ref["mask"]}, CPU)
    assert good == {"mask_cells_off": 0, "paths_over_t": 0, "homes_missing": 0,
                    "overhead_gap": 0.0, "feasible_off": 0}
    bad = ref["mask"].copy()
    bad[2, 1] = False
    got = check.judge(OBJECTS, LENGTHS, HOME, f64, 1, [bad], [check.overhead(bad, f64)],
                      [True], {0: ref["mask"]}, CPU)
    assert got["mask_cells_off"] == 1 and got["paths_over_t"] == 2 and got["feasible_off"] == 1


def test_tf32_rounding():
    x = np.array([1.0, 1.1, 1.3, 1.2, 3.0e5, -2.5], np.float32)
    got = greedy.round_tf32(x)
    assert got[0] == 1.0 and got[5] == -2.5
    assert np.all(np.abs(got - x) <= np.abs(x) * 2.0 ** -11)
    assert np.all(got.view(np.uint32) & 0x1FFF == 0)


def test_reference_equals_the_port_kernel_path(monkeypatch):
    """The port's kernel backend, watched on the CPU (each kernel wrapper
    runs its plain version, which sums costs in the kernel's order), gives
    the reference's scheme bit for bit at sizes that are not exact."""
    import repro_torch.core as core
    from repro_torch.engine import backends

    from bench import gen
    from bench.drives import provision

    cell = cut_snb(harness.load_cell("snb_sf1.provision.t1"))
    cell.config["sizes"]["per_edge"] = 0.1
    inputs = gen.make_inputs(cell.config, cell.traffic, CPU)
    p = gen.order(inputs, 99, 0)
    ref = provision.reference(inputs, p, CPU)
    resolve = backends.resolve_backend
    monkeypatch.setattr(backends, "resolve_backend",
                        lambda b, d: "kernel" if b in (None, "kernel") else resolve(b, d))
    ps = core.PathSet(p.objects, p.lengths, p.query_ids)
    scheme, stats = core.replicate_workload(ps, inputs.home, 6, 1, f=inputs.f,
                                            policy="nearest_copy", fused=True, device=CPU)
    assert stats.routed_violations == ref["violations"] == 0
    assert np.array_equal(scheme.mask, ref["mask"])
    assert int(ref["prune"]["dropped"].sum()) == stats.pruned_replicas > 0


def test_the_control_is_not_correct():
    from bench import gen

    cell = cut_snb(harness.load_cell("snb_sf1.provision.t1"), 1500)
    cell.config["sizes"]["per_edge"] = 0.1
    inputs = gen.make_inputs(cell.config, cell.traffic, CPU)
    got = control.control_checks(cell, inputs, 3, CPU)
    assert got["mask_cells_off"] > cell.limits["mask_cells_off"]
    assert got["overhead_gap"] > cell.limits["overhead_gap"]
