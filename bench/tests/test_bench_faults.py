"""A run whose timed path is broken underneath comes out not correct: one
case per fault a provisioning cell can have (the look for a card is
skipped; the cell is cut to the CPU's size)."""
import numpy as np
import pytest
import torch

import repro_torch.core as core
from bench import harness


def _unchanged(real):
    def drive(ps, shard, n_servers, t, **kw):
        scheme, stats = real(ps, shard, n_servers, t, **kw)
        return core.ReplicationScheme.from_sharding(shard, n_servers), stats
    return drive


def _half_the_paths(real):
    def drive(ps, shard, n_servers, t, **kw):
        return real(ps.select(np.arange(ps.n_paths // 2)), shard, n_servers, t, **kw)
    return drive


def _copy_dropped(real):
    def drive(ps, shard, n_servers, t, **kw):
        scheme, stats = real(ps, shard, n_servers, t, **kw)
        extra = scheme.mask.copy()
        extra[np.arange(len(shard)), shard] = False
        v, s = np.argwhere(extra)[0]
        scheme.mask[v, s] = False
        return scheme, stats
    return drive


def _copy_added(real):
    def drive(ps, shard, n_servers, t, **kw):
        scheme, stats = real(ps, shard, n_servers, t, **kw)
        v, s = np.argwhere(~scheme.mask)[0]
        scheme.mask[v, s] = True
        return scheme, stats
    return drive


@pytest.mark.parametrize("fault, caught_by", [
    (_unchanged, "paths_over_t"),
    (_half_the_paths, "paths_over_t"),
    (_copy_dropped, "mask_cells_off"),
    (_copy_added, "mask_cells_off"),
])
def test_a_broken_drive_is_not_correct(monkeypatch, snb_cell, fault, caught_by):
    monkeypatch.setattr(core, "replicate_workload", fault(core.replicate_workload))
    out = harness.run_cell(snb_cell, 12345, 0.0, False, torch.device("cpu"), 0.0,
                           log=lambda m: None)
    assert not out["correct"]
    got = out["checks"][caught_by]
    assert got["value"] > got["limit"]


def test_a_misreported_overhead_is_not_correct(monkeypatch, snb_cell):
    real = core.ReplicationScheme.replication_overhead
    monkeypatch.setattr(core.ReplicationScheme, "replication_overhead",
                        lambda self, f=None: real(self, f) * (1 + 1e-6))
    out = harness.run_cell(snb_cell, 12345, 0.0, False, torch.device("cpu"), 0.0,
                           log=lambda m: None)
    got = out["checks"]["overhead_gap"]
    assert not out["correct"] and got["value"] > got["limit"]
