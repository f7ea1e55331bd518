"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests must see the real
host device count (the 512-device override belongs to dryrun.py only)."""
import numpy as np
import pytest

from repro.core.paths import PathSet


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (full-size / compile-heavy problems)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test (full-size / compile-heavy problem); "
        "skipped unless --runslow is given, keeping tier-1 fast",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the repro_torch CUDA kernels); skips "
        "with a reason where torch.cuda.is_available() is False",
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow test: pass --runslow to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(autouse=True)
def _transfer_scope():
    """Scope the engine's global transfer accounting to each test.

    ``repro.engine.TRANSFER`` is process-global; ``scope()`` zeroes the
    counters on entry — so a test asserting on h2d/d2h byte counts sees
    only its own traffic — and restores outer + inner totals on exit, so
    nothing outside the test loses its accounting.
    """
    from repro.engine import TRANSFER

    with TRANSFER.scope():
        yield


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_workload(rng, n_obj=120, n_srv=5, n_paths=150, max_len=7,
                    n_queries=None):
    paths = [
        rng.integers(0, n_obj, rng.integers(1, max_len + 1)).tolist()
        for _ in range(n_paths)
    ]
    qids = None
    if n_queries:
        qids = rng.integers(0, n_queries, n_paths).tolist()
        qids = sorted(qids)
    shard = rng.integers(0, n_srv, n_obj).astype(np.int32)
    return PathSet.from_lists(paths, qids), shard


@pytest.fixture
def workload(rng):
    return random_workload(rng)
