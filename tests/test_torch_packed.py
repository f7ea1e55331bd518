"""The port's packed int32 words equal the JAX package's uint32 words.

After the same add/remove sequence — bits 31 and 63, duplicate pairs and
negative pairs included — the port's words viewed as uint32 equal
``repro.engine.PackedScheme.words`` exactly, sacrificial row included.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import numpy as np
import pytest

from repro.engine import PackedScheme as JPacked
from repro_torch.engine import PackedScheme as TPacked
from repro_torch.engine.packed import test_bits as t_test_bits
from repro_torch.engine.streaming import to_device

CPU = "cpu"


def _ops(rng, n_obj, n_srv):
    """A seeded add/remove sequence with the awkward pairs in it."""
    top = [s for s in (31, 63) if s < n_srv] + [n_srv - 1]
    ops = []
    for step in range(6):
        k = 40
        obj = rng.integers(0, n_obj, k)
        srv = rng.integers(0, n_srv, k)
        srv[:len(top)] = top                      # the sign bit and the word edge
        obj[-6:] = obj[0]                         # duplicate pairs
        srv[-6:] = srv[0]
        obj[5], srv[6] = -1, -3                   # negative pairs are ignored
        ops.append(("add" if step % 3 != 2 else "remove", obj, srv))
    return ops


@pytest.mark.parametrize("n_srv", [5, 40, 70])
def test_add_remove_sequence_matches_jax(n_srv):
    rng = np.random.default_rng(n_srv)
    n_obj = 200
    shard = rng.integers(0, n_srv, n_obj).astype(np.int32)
    j = JPacked.from_sharding(shard, n_srv)
    t = TPacked.from_sharding(shard, n_srv, device=CPU)
    assert t.words.dtype.is_signed and t.words.element_size() == 4
    assert np.array_equal(t.numpy_words(), np.asarray(j.words))
    for op, obj, srv in _ops(rng, n_obj, n_srv):
        getattr(j, op)(obj, srv)
        getattr(t, op)(obj, srv)
        assert np.array_equal(t.numpy_words(), np.asarray(j.words)), op
    assert t.replica_count() == j.replica_count()
    # dyadic sizes: every float32 partial sum is exact, so the sum order
    # of the two frameworks' products cannot show
    f = (rng.integers(1, 64, n_obj) / 8).astype(np.float32)
    assert np.array_equal(t.storage_per_server(f), j.storage_per_server(f))
    assert np.array_equal(t.storage_per_server(), j.storage_per_server())
    assert np.array_equal(t.unpack(), j.unpack())


@pytest.mark.parametrize("n_srv", [5, 40, 70])
def test_from_numpy_round_trip(n_srv):
    rng = np.random.default_rng(1)
    n_obj = 64
    mask = rng.random((n_obj, n_srv)) < 0.3
    shard = rng.integers(0, n_srv, n_obj).astype(np.int32)
    mask[np.arange(n_obj), shard] = True
    j = JPacked.from_mask(mask, shard)
    t = TPacked.from_numpy(np.asarray(j.words), shard, device=CPU, n_servers=n_srv)
    assert np.array_equal(t.numpy_words(), np.asarray(j.words))
    assert np.array_equal(t.unpack(), mask)
    assert np.array_equal(
        TPacked.from_mask(mask, shard, device=CPU).numpy_words(), np.asarray(j.words)
    )
    assert t.replica_count() == int(mask.sum()) - n_obj


def test_bits_including_sign_bit():
    mask = np.zeros((3, 64), bool)
    mask[0, 31] = mask[1, 63] = mask[2, 0] = mask[2, 32] = True
    t = TPacked.from_mask(mask, np.zeros(3, np.int32), device=CPU)
    obj = to_device(np.repeat(np.arange(3), 64).astype(np.int32), t.device)
    srv = to_device(np.tile(np.arange(64), 3).astype(np.int32), t.device)
    got = t_test_bits(t.words, obj, srv).numpy().reshape(3, 64)
    assert np.array_equal(got, mask)


def test_set_bit_toggles_one_cell():
    shard = np.array([0, 1, 2], np.int32)
    t = TPacked.from_sharding(shard, 64, device=CPU)
    before = t.numpy_words().copy()
    t.set_bit(1, 63, True)
    t.set_bit(2, 31, True)
    m = t.unpack()
    assert m[1, 63] and m[2, 31] and m.sum() == 5
    t.set_bit(1, 63, False)
    t.set_bit(2, 31, False)
    assert np.array_equal(t.numpy_words(), before)
