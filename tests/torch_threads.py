"""One intra-op torch thread in each test process.

The suite runs under ``pytest -n 6``: six worker processes share the
machine's cores, and torch's default of one intra-op thread per core
oversubscribes them about sixfold.  Its OpenMP threads spin while they
wait, so the port's greedy tests ran ~60x slower under six workers than
alone (a prune sweep of the SNB case: 404 s against 5.9 s on an 8-core
host).  Every ``tests/test_torch_*.py`` file imports this module; since
each xdist worker imports every test module when it collects, the
setting holds for the whole worker.  Results do not depend on it: the
port's CPU ops are deterministic for any thread count the tests compare
at.
"""
import torch

torch.set_num_threads(1)
