"""Sharded training on a 2 x 2 gloo mesh against the JAX package on 4
forced host devices (``repro_torch.launch.train`` on DTensor against
``repro.launch.train`` under GSPMD).

The JAX side runs once for the module in a subprocess
(``tests/torch_sharded_jax.py``, ``XLA_FLAGS`` set there only, an
Auto-typed mesh in place of ``make_host_mesh``); the port's side runs
once in four spawned gloo ranks (``tests/torch_sharded_ranks.py``).  The
tests then hold, for the five LM SMOKE configs at batch 8 x 32:

  * three steps of ``train_lm`` from the JAX init: each step's loss and
    gradient norm at atol = rtol = 1e-5 (the f32 training tolerance);
  * every rank's local shard of every parameter at init equal, bit for
    bit, to the JAX device's shard at the same mesh coordinate, and its
    AdamW moments zero of that shape; after one step the parameters at
    1e-5 and the moments at 1e-5 of each leaf's largest entry (as
    ``tests/test_torch_train.py`` holds them);
  * ``train_lm`` with a checkpoint every 2 steps and a failure after step
    5: the restart from step 4 equal to the uninterrupted run's losses;
  * ``shard_tensor`` keeping the slice ``distribute_tensor`` keeps;
  * the tensor-parallel layouts the SMOKE configs do not reach (query
    heads split with KV heads whole; heads whole over a model axis of 4,
    GQA and MLA) against one device at 1e-5.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_sharded_ranks as R

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, os.path.join(HERE, "torch_sharded_jax.py"), str(out),
                          "train"], capture_output=True, text=True, env=env, timeout=400)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    with open(out / "jax.json") as fh:
        return json.load(fh), str(out / "jax.npz")


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    return R.spawn("train_against_jax", 4, tmp, jax_side[1], str(tmp / "ckpt"), timeout=400)


@pytest.mark.parametrize("arch", R.ARCHS)
def test_train_lm_on_2x2_matches_jax(jax_side, ranks, arch):
    want = jax_side[0]["train"][arch]
    for r in ranks:  # every rank reports the global batch's loss and norm
        losses, norms = r["train"][arch]
        np.testing.assert_allclose(losses, want["losses"], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(norms, want["grad_norms"], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", R.ARCHS)
def test_local_shards_are_the_jax_shards(ranks, arch):
    for r in ranks:
        rows = r["shards"][arch]
        names = {n for kind, n in rows if kind == "init"}
        assert len(names) == len(rows) // 6
        for (kind, name), (got, want) in rows.items():
            assert got.shape == want.shape, (kind, name, got.shape, want.shape)
            if kind.startswith("init"):
                np.testing.assert_array_equal(got, want, err_msg=f"{kind} {name}")
            elif kind == "step1_params":
                np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=name)
            else:  # a moment: 1e-5 of the leaf's largest entry
                err = float(np.abs(got - want).max())
                assert err <= TOL * max(float(np.abs(want).max()), 1e-30), (kind, name, err)


def test_checkpoint_restart_on_2x2_is_exact(ranks):
    for r in ranks:
        ck = r["ckpt"]
        assert ck["failed"] == "injected failure"
        assert ck["restored_from"] == 4
        assert ck["again"] == ck["full"][4:] and len(ck["full"]) == 8


def test_shard_tensor_keeps_distribute_tensors_slice(ranks):
    for r in ranks:
        assert r["shard_tensor"] == [True] * 5


LAYOUTS = [
    # query heads split over a model axis of 2, the one KV head whole
    ("q_split_kv_whole", "qwen2-7b", {"n_heads": 4, "n_kv_heads": 1}, 2),
    # 6 heads over a model axis of 4: heads whole, MLP split
    ("heads_whole", "qwen2-7b", {"n_heads": 6, "n_kv_heads": 2}, 4),
    # MLA with 6 heads over 4: w_uq / w_uk / w_uv / wo gathered whole
    ("mla_heads_whole", "deepseek-v2-236b", {"n_heads": 6, "n_kv_heads": 6}, 4),
]


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    return R.spawn("tp_layouts", 4, tmp_path_factory.mktemp("layouts"), LAYOUTS, timeout=300)


@pytest.mark.parametrize("case", [c[0] for c in LAYOUTS])
def test_tensor_parallel_layouts_match_one_device(layouts, case):
    for r in layouts:
        one, mesh = r[case]["one"], r[case]["mesh"]
        np.testing.assert_allclose(mesh[0], one[0], atol=TOL, rtol=TOL)
        assert set(mesh[1]) == set(one[1])
        for k in one[1]:
            np.testing.assert_allclose(mesh[1][k], one[1][k], atol=TOL, rtol=TOL, err_msg=k)
