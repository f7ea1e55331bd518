"""The elastic drill over four gloo ranks and the GNN's split aggregation
against the JAX package on 4 forced host devices.

The JAX side runs once for the module in a subprocess
(``tests/torch_sharded_jax.py ... elastic_agg``); the port's side once in
four spawned gloo ranks (``tests/torch_sharded_ranks.py``):

  * ``elastic_drill`` on qwen2-7b's SMOKE config from the JAX init: a
    2 x 2 mesh, then the first two ranks' 1 x 2 mesh (every rank takes
    part in making it), ``bit_exact`` on every rank, and its losses equal
    to the JAX drill's at 1e-5;
  * ``SplitGraph.agg`` (each rank's edges summed into its node rows over
    ("data", "model"), gathered whole) sum and mean on 256 f32 messages
    into 64 nodes equal to JAX's sharded ``make_agg`` and to
    ``_agg_dense`` at 1e-5; in f64, the split aggregation and its
    gradient (each rank's share, summed) equal the port's dense one at
    1e-12 (trap m: sums in f32 may differ by order), also on a node
    count the ranks do not divide (uneven chunks of node rows);
  * each GNN's loss and gradients (f64) on 2 x 2, the parameters placed
    by ``param_specs`` (``place_params``; ``min_tp_dim`` 2, so the even
    output dims split over "model") and the batch placed whole on every
    rank, run split (each rank's loss its share, summed), equal the
    dense ones at 1e-10.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_sharded_ranks as R
from repro_torch.configs import GNN_CONFIGS

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, os.path.join(HERE, "torch_sharded_jax.py"), str(out),
                          "elastic_agg"], capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    with open(out / "jax.json") as fh:
        return json.load(fh), str(out / "jax.npz")


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    return R.spawn("elastic_and_agg", 4, tmp_path_factory.mktemp("ranks"), jax_side[1],
                   timeout=300)


def test_elastic_drill_over_four_ranks_is_bit_exact(ranks):
    for r in ranks:
        d = r["drill"]
        assert d["bit_exact"], d
        assert len(d["losses_before"]) == 3 and len(d["losses_after"]) == 3
        assert d == ranks[0]["drill"]  # every rank returns the survivors' losses


def test_elastic_drill_matches_jax(jax_side, ranks):
    want, got = jax_side[0]["elastic"], ranks[0]["drill"]
    assert want["bit_exact"]
    for key in ("losses_before", "losses_after", "reference"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-5, rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("kind", ["sum", "mean"])
def test_sharded_aggregation_matches_jax_and_dense(jax_side, ranks, kind):
    npz = np.load(jax_side[1])
    assert sorted(r["coord"] for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        got = r[f"agg/{kind}"]
        np.testing.assert_allclose(got, npz[f"agg/{kind}"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got, npz[f"agg_dense/{kind}"], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["sum", "mean"])
def test_sharded_aggregation_f64_equals_dense(ranks, kind):
    for r in ranks:
        got, want, g_got, g_want = r[f"f64/{kind}"]
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=1e-12)
        np.testing.assert_allclose(g_got, g_want, atol=1e-12, rtol=1e-12)
        odd, dense = r[f"odd/{kind}"]
        np.testing.assert_allclose(odd, dense, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("arch", sorted(GNN_CONFIGS))
def test_gnn_loss_and_gradients_on_2x2_match_dense(ranks, arch):
    for r in ranks:
        got = r["gnn"][arch]
        loss_m, grads_m = got["mesh"]
        loss_d, grads_d = got["dense"]
        np.testing.assert_allclose(loss_m, loss_d, atol=1e-10, rtol=1e-10)
        assert len(grads_m) == len(grads_d) > 0
        for a, b in zip(grads_m, grads_d):
            np.testing.assert_allclose(a, b, atol=1e-10, rtol=1e-10)
