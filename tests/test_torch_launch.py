"""The port's launchers against the JAX package's, on the CPU.

``serve`` (graph, workload, sharding, greedy, feasibility, executor, and
the server-failure drill) equals ``repro.launch.serve.serve`` field by
field at SNB scale 1 under hash and mincut sharding, with and without
``fail_server`` and ``hedge`` (the drill's scheme re-checked by the
pure-python oracle);
``elastic_drill`` is bit-exact (host round trip onto the survivors) for a
dense and a MoE SMOKE config; ``build_for_devices``' step, on the JAX init
carried across through ``reshard_state``, gives the JAX step's losses and
grad norms within 1e-5 relative over three steps.  The refusals are in
``tests/test_torch_hygiene.py``.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import qwen2_7b as j_qwen2
from repro.launch import elastic as j_elastic
from repro.launch import serve as j_serve
from repro.models import transformer as JT
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as j_cosine
from repro_torch.configs import qwen2_7b, qwen3_moe_235b_a22b
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.elastic import build_for_devices, elastic_drill, reshard_state, to_host
from repro_torch.launch.serve import ServeReport
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, cosine_schedule

N_QUERIES = 300
SERVE_CASES = [("hash", None, False), ("hash", 0, True), ("mincut", 2, False),
               ("mincut", None, True)]


@pytest.fixture(scope="module")
def jax_reports():
    return {case: j_serve.serve(1, 6, 1, N_QUERIES, case[0], case[1], case[2])
            for case in SERVE_CASES}


@pytest.mark.parametrize("case", SERVE_CASES, ids=lambda c: f"{c[0]}-fail{c[1]}-hedge{c[2]}")
def test_serve_equals_jax(jax_reports, case):
    sharding, fail, hedge = case
    got = serve_mod.serve(1, 6, 1, N_QUERIES, sharding, fail, hedge, device="cpu")
    want = jax_reports[case]
    assert isinstance(got, ServeReport)
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.feasible and (fail is None) == (got.post_fault_feasible is None)


def test_serve_returns_a_feasible_scheme(jax_reports):
    """``return_scheme`` gives the scheme after the drill: the pure-python
    oracle finds it feasible exactly when the report says so."""
    from repro_torch.core import is_latency_feasible
    from repro_torch.graph import snb_like
    from repro_torch.workload import snb_workload_materialized

    rep, scheme = serve_mod.serve(1, 6, 1, N_QUERIES, "hash", 0, True, device="cpu",
                                  backend="torch", return_scheme=True)
    assert dataclasses.astuple(rep) == dataclasses.astuple(jax_reports[("hash", 0, True)])
    ps = snb_workload_materialized(snb_like(1, seed=0), n_queries=N_QUERIES, seed=0)
    assert is_latency_feasible(ps, scheme, 1, device="cpu",
                               backend="reference") == rep.post_fault_feasible


@pytest.mark.parametrize("cfg", [qwen2_7b.SMOKE, qwen3_moe_235b_a22b.SMOKE],
                         ids=["dense", "moe"])
def test_elastic_drill_bit_exact(cfg):
    out = elastic_drill(cfg, device="cpu")
    assert out["bit_exact"] and out["max_abs_gap"] == 0.0
    assert out["losses_before"] + out["losses_after"] == out["reference"]
    assert len(out["reference"]) == 6 and np.isfinite(out["reference"]).all()


def test_host_round_trip_keeps_bf16_bits():
    cfg = dataclasses.replace(qwen2_7b.SMOKE, dtype=torch.bfloat16)
    params = dict(T.Transformer(cfg, device="cpu").named_parameters())
    _, ps, _, _, _ = build_for_devices(cfg, ["cpu"], AdamW())
    back = reshard_state(to_host(params), ps)
    assert set(back) == set(params)
    for k, p in params.items():
        assert back[k].dtype == p.dtype and isinstance(back[k], torch.nn.Parameter)
        assert torch.equal(back[k].view(torch.int16) if p.dtype == torch.bfloat16 else back[k],
                           p.detach().view(torch.int16) if p.dtype == torch.bfloat16
                           else p.detach())


def test_build_for_devices_step_matches_jax():
    jcfg = j_qwen2.SMOKE
    jopt = JAdamW(lr=j_cosine(1e-3, 2, 100))
    opt = AdamW(lr=cosine_schedule(1e-3, 2, 100))
    jparams = JT.init(jcfg, jax.random.key(0))
    jstate = (jparams, jopt.init(jparams))
    _, jps, jos, jbs, jstep = j_elastic.build_for_devices(jcfg, jax.devices()[:1], jopt)
    jp, jo = j_elastic.reshard_state(jstate[0], jps), j_elastic.reshard_state(jstate[1], jos)

    model = T.Transformer(qwen2_7b.SMOKE, device="cpu")
    T.load_jax_params(model, jax.tree.map(np.asarray, jparams))
    params = dict(model.named_parameters())
    _, ps, os_, bs, step = build_for_devices(qwen2_7b.SMOKE, ["cpu"], opt)
    p, o = reshard_state(to_host(params), ps), reshard_state(to_host(opt.init(params)), os_)
    for i in range(3):
        rng = np.random.default_rng(1000 + i)
        toks = rng.integers(0, jcfg.vocab, (4, 17), dtype=np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        jp, jo, jm = jstep(jp, jo, jax.device_put(batch, jbs))
        p, o, m = step(p, o, reshard_state(batch, bs))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, err_msg=key)
