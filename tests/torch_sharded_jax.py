"""The JAX package's multi-device training on 4 forced host devices, run as
a script (``python tests/torch_sharded_jax.py OUT_DIR PART``) in a subprocess of
the sharded-training tests: ``XLA_FLAGS`` must be set before JAX starts,
and never in the pytest process.

JAX 0.9's ``jax.make_mesh`` types its axes Explicit, under which
``repro.launch.train.train_lm`` and the sharded GNN aggregation do not
run (``DuplicateSpecError`` at ``src/repro/models/transformer.py:732``;
``src/repro/models/gnn.py:261``).  With Auto axes they do, so the script
substitutes an Auto-typed ``make_host_mesh`` for the one
``repro.launch.train`` imported; ``repro.launch.elastic`` builds a
``jax.sharding.Mesh``, which is Auto already.

Writes ``OUT_DIR/jax.json`` (losses and gradient norms) and
``OUT_DIR/jax.npz`` (initial parameters, and per-device shards).  Part
``train`` (``python tests/torch_sharded_jax.py OUT_DIR train``):
  * for each LM arch, ``repro.launch.train.train_lm(arch, steps=3)``
    (SMOKE, batch 8 x 32) on the (2, 2) mesh: each step's loss and norm,
    caught at full precision where the loop converts them to floats;
  * the same arch's init (``T.init(cfg, key(0))``, the loop's) placed by
    ``param_specs``, and its parameters and AdamW moments after one step
    of the loop's step on step 0's batch: every device's shard;
Part ``elastic_agg``:
  * ``repro.launch.elastic.elastic_drill`` on qwen2-7b's SMOKE config
    (4 devices, then 2), and that config's init;
  * ``make_agg`` (``agg_axes`` ("data", "model"), ``node_axes`` ("data",))
    sum and mean on the (2, 2) mesh, 256 messages of 16 into 64 nodes.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"

import builtins  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P  # noqa: E402

import repro.launch.train as JTRAIN  # noqa: E402
from repro.configs import get_arch  # noqa: E402
from repro.data import lm_batch_fn  # noqa: E402
from repro.launch.elastic import elastic_drill  # noqa: E402
from repro.models import gnn as G  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.optim import AdamW, cosine_schedule  # noqa: E402

ARCHS = ["qwen2-7b", "chatglm3-6b", "h2o-danube-3-4b", "qwen3-moe-235b-a22b",
         "deepseek-v2-236b"]
STEPS, BATCH, SEQ = 3, 8, 32
AGG_N, AGG_E, AGG_D = 64, 256, 16


def auto_mesh(model=None):
    n = len(jax.devices())
    m = model or (2 if n % 2 == 0 and n > 1 else 1)
    return jax.make_mesh((n // m, m), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def caught_train_lm(arch):
    """train_lm's per-step loss and norm, each as the loop converts it."""
    got = []

    def catch(x):
        got.append(np.asarray(x).item())
        return builtins.float(x)

    JTRAIN.float = catch
    try:
        JTRAIN.train_lm(arch, steps=STEPS, smoke=True, batch=BATCH, seq=SEQ, log_every=1)
    finally:
        del JTRAIN.float
    return got[0::2], got[1::2]


def shards(tree, prefix, out):
    """Every device's shard of each leaf, keyed prefix/path/row.col of the
    device on the mesh (the mesh is devices [[0, 1], [2, 3]])."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for sh in leaf.addressable_shards:
            r = sh.device.id
            out[f"{prefix}/{name}/{r // 2}.{r % 2}"] = np.asarray(sh.data)


def one_step_shards(arch, out):
    cfg = get_arch(arch).smoke_config
    mesh = auto_mesh()
    opt = AdamW(lr=cosine_schedule(3e-4, 10, max(STEPS, 100)))
    pspecs = T.param_specs(cfg, ("data",), "model", mesh.shape["model"], mesh.shape["data"])
    ospecs = opt.state_specs(pspecs)
    bspecs = {"tokens": P(("data",), None), "labels": P(("data",), None)}
    named = lambda s: jax.tree.map(lambda x: NamedSharding(mesh, x), s,
                                   is_leaf=lambda x: isinstance(x, P))

    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: T.loss_fn(p, batch["tokens"], batch["labels"], cfg))(params)
        params, opt_state, _ = opt.update(grads, opt_state, params)
        return params, opt_state

    init = T.init(cfg, jax.random.key(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(init)[0]:
        out["init/" + arch + "/" + "/".join(k.key for k in path)] = np.asarray(leaf)
    params = jax.device_put(init, named(pspecs))
    opt_state = jax.device_put(opt.init(params), named(ospecs))
    shards(params, f"shard0/{arch}/params", out)
    batch = jax.device_put(lm_batch_fn(cfg.vocab, BATCH, SEQ)(0), named(bspecs))
    params, opt_state = jax.jit(step, in_shardings=(named(pspecs), named(ospecs), named(bspecs)),
                                out_shardings=(named(pspecs), named(ospecs)))(
        params, opt_state, batch)
    shards(params, f"shard1/{arch}/params", out)
    shards(opt_state.m, f"shard1/{arch}/m", out)
    shards(opt_state.v, f"shard1/{arch}/v", out)


def sharded_agg(out):
    rng = np.random.default_rng(0)
    msgs = rng.normal(size=(AGG_E, AGG_D)).astype(np.float32)
    recv = rng.integers(0, AGG_N, AGG_E).astype(np.int32)
    mesh = auto_mesh()
    agg = G.make_agg(G.GNNConfig(agg_axes=("data", "model"), node_axes=("data",)))
    edges = (NamedSharding(mesh, P(("data", "model"), None)),
             NamedSharding(mesh, P(("data", "model"))))
    for kind in ("sum", "mean"):
        with jax.set_mesh(mesh):
            f = jax.jit(lambda m, r: agg(m, r, AGG_N, kind), in_shardings=edges)
            out[f"agg/{kind}"] = np.asarray(f(jnp.asarray(msgs), jnp.asarray(recv)))
        out[f"agg_dense/{kind}"] = np.asarray(G._agg_dense(jnp.asarray(msgs),
                                                          jnp.asarray(recv), AGG_N, kind))


def main(out_dir, part):
    JTRAIN.make_host_mesh = auto_mesh
    assert len(jax.devices()) == 4
    res, arrays = {}, {}
    if part == "train":
        res["train"] = {}
        for arch in ARCHS:
            losses, norms = caught_train_lm(arch)
            res["train"][arch] = {"losses": losses, "grad_norms": norms}
            one_step_shards(arch, arrays)
    else:
        res["elastic"] = elastic_drill(get_arch("qwen2-7b").smoke_config)
        init = T.init(get_arch("qwen2-7b").smoke_config, jax.random.key(0))
        for path, leaf in jax.tree_util.tree_flatten_with_path(init)[0]:
            arrays["init/qwen2-7b/" + "/".join(k.key for k in path)] = np.asarray(leaf)
        sharded_agg(arrays)
    np.savez(os.path.join(out_dir, "jax.npz"), **arrays)
    with open(os.path.join(out_dir, "jax.json"), "w") as fh:
        json.dump(res, fh)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
