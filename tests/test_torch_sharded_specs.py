"""Partition specs, placements and the 1 x 1 mesh of the port's sharded
training.

  * ``transformer.param_specs`` equals the JAX ``param_specs`` leaf for
    leaf (the stacked layer axis dropped, each layer of a stack given the
    stack's spec) for the five LM configs, SMOKE and FULL, and
    ``gnn.param_specs`` the JAX one for the four GNN configs, at (tp, dp)
    of (2, 2), (1, 4) and (16, 16), with no device;
  * a spec's DTensor placements, and ``AdamW.state_specs``;
  * ``make_host_mesh`` brings up a world of one over gloo when no process
    group is up, and is a (1, 1) ``("data", "model")`` mesh;
  * on that mesh every parameter enters a loss's graph once, the head of
    a chunked loss too (a second take adds DTensor gradients out of
    place: a transient copy of the weight);
  * ``train_lm`` on a world-1 gloo mesh (one spawned rank) equals the
    one-device ``train_lm`` bit for bit: each step's loss and norm, and the
    final parameters and AdamW state (both runs checkpoint their last
    step, whole tensors in one file format).
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

import torch_sharded_ranks as R
from repro.configs import get_arch as j_get_arch
from repro.models import gnn as JG
from repro.models import transformer as JT
from repro_torch.configs import GNN_CONFIGS, LM_CONFIGS
from repro_torch.launch import mesh as M
from repro_torch.launch.train import train_lm
from repro_torch.models import gnn as G
from repro_torch.models import transformer as T
from repro_torch.models.parallel import P, placements
from repro_torch.optim import AdamW

MESHES = [(2, 2), (1, 4), (16, 16)]   # (tp, dp)


def _jax_by_port_name(jspecs: dict, cfg) -> dict:
    """The JAX specs keyed as the port's parameters, the layer axis dropped."""
    out = {k: tuple(jspecs[k]) for k in ("embed", "ln_f", "lm_head")}
    nd = cfg.n_dense_layers if cfg.is_moe else 0
    for i in range(cfg.n_layers):
        stack = "dense_layers" if i < nd else "layers"
        for name, spec in jspecs[stack].items():
            assert spec[0] is None, (stack, name, spec)
            out[f"layers.{i}.{name}"] = tuple(spec)[1:]
    return out


@pytest.mark.parametrize("size", ["SMOKE", "FULL"])
@pytest.mark.parametrize("arch", sorted(LM_CONFIGS))
@pytest.mark.parametrize("tp,dp", MESHES)
def test_lm_param_specs_equal_jax(arch, size, tp, dp):
    cfg = getattr(LM_CONFIGS[arch], size)
    jb = j_get_arch(arch)
    jcfg = jb.smoke_config if size == "SMOKE" else jb.config
    got = T.param_specs(cfg, ("data",), "model", tp, dp)
    want = _jax_by_port_name(JT.param_specs(jcfg, ("data",), "model", tp, dp), cfg)
    assert set(got) == set(want) == set(T.init_abstract(cfg))
    for name in got:
        assert isinstance(got[name], P)
        assert tuple(got[name]) == want[name], (name, got[name], want[name])


@pytest.mark.parametrize("size", ["SMOKE", "FULL"])
@pytest.mark.parametrize("arch", sorted(GNN_CONFIGS))
@pytest.mark.parametrize("tp,dp", MESHES)
def test_gnn_param_specs_equal_jax(arch, size, tp, dp):
    cfg = getattr(GNN_CONFIGS[arch], size)
    jb = j_get_arch(arch)
    jcfg = jb.smoke_config if size == "SMOKE" else jb.config
    got = G.param_specs(cfg, ("data",), "model", tp)
    want = JG.param_specs(jcfg, ("data",), "model", tp)
    assert set(got) == set(want)
    for group in got:
        if isinstance(got[group], dict):
            assert set(got[group]) == set(want[group])
            for k in got[group]:
                assert tuple(got[group][k]) == tuple(want[group][k]), (group, k)
        else:
            assert tuple(got[group]) == tuple(want[group]), group


class _Mesh:
    """Just what ``placements`` reads of a mesh."""
    mesh_dim_names = ("data", "model")


def test_spec_placements():
    m = _Mesh()
    assert placements(P(("data",), "model"), m) == [Shard(0), Shard(1)]
    assert placements(P("model", "data"), m) == [Shard(1), Shard(0)]
    assert placements(P(None, None), m) == [Replicate(), Replicate()]
    assert placements(P(None, ("data", "model")), m) == [Shard(1), Shard(1)]
    assert P(("data",), None) == P("data", None) == ("data", None)
    with pytest.raises(ValueError, match="order"):
        placements(P(("model", "data")), m)
    specs = T.param_specs(LM_CONFIGS["qwen2-7b"].SMOKE, ("data",), "model", 2, 2)
    st = AdamW().state_specs(specs)
    assert st.step == P() and st.m is specs and st.v is specs


def test_host_mesh_brings_up_a_world_of_one():
    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    mesh = M.make_host_mesh(device="cpu")
    try:
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cpu"
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", R.ARCHS)
def test_each_parameter_is_taken_once_per_step(arch):
    """On a mesh every DTensor parameter enters the loss's graph once (one
    ``redistribute``), the chunked head too: each take's gradient is a
    DTensor, and two are added out of place, a transient copy of the
    whole weight that the one-device step does not make."""
    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    from torch import nn

    from repro_torch.data import lm_batch_fn
    from repro_torch.models.parallel import MeshParallel, shard_tensor

    mesh = M.make_host_mesh(device="cpu")
    try:
        cfg = dataclasses.replace(LM_CONFIGS[arch].SMOKE, loss_chunk=64, remat=True)
        specs = T.param_specs(cfg, ("data",), "model", 1, 1)
        model = T.Transformer(cfg, device="cpu")
        params = {n: nn.Parameter(shard_tensor(p.detach(), mesh, specs[n]))
                  for n, p in model.named_parameters()}
        b = lm_batch_fn(cfg.vocab, 4, 32)(0)   # 128 tokens: two head chunks
        loss = T.loss_fn(T.Transformer(cfg, params=params, par=MeshParallel(mesh)),
                         torch.as_tensor(b["tokens"]), torch.as_tensor(b["labels"]))
        seen, stack, takes = set(), [loss.grad_fn], 0
        while stack:
            fn = stack.pop()
            if fn is None or fn in seen:
                continue
            seen.add(fn)
            takes += type(fn).__name__ == "RedistributeBackward"
            stack.extend(f for f, _ in fn.next_functions)
        assert takes == len(params)
    finally:
        dist.destroy_process_group()


def test_one_by_one_mesh_equals_one_device_bit_for_bit(tmp_path):
    mesh = R.spawn("one_by_one", 1, tmp_path, str(tmp_path), timeout=240)[0]
    from repro_torch.distsys import CheckpointManager

    for arch in R.ARCHS:
        one = train_lm(arch, steps=R.STEPS, batch=R.BATCH, seq=R.SEQ, device="cpu",
                       log_every=100, ckpt_dir=str(tmp_path / f"one_{arch}"),
                       ckpt_every=R.STEPS)
        assert mesh[arch] == (one["losses"], one["grad_norms"]), arch
        a = np.load(tmp_path / f"one_{arch}" / f"step_{R.STEPS - 1}" / "arrays.npz")
        b = np.load(tmp_path / f"mesh_{arch}" / f"step_{R.STEPS - 1}" / "arrays.npz")
        assert a.files == b.files and len(a.files) > 10
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{arch} {k}")
        assert CheckpointManager(str(tmp_path / f"mesh_{arch}")).all_steps() == [R.STEPS - 1]
