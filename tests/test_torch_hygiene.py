"""Import and device hygiene of the PyTorch port (``repro_torch``).

The port imports torch, numpy and the standard library only — never
``jax`` and nothing of the JAX package ``repro`` — and its entry points
run on CUDA unless the caller asks for the CPU: without a card they raise
instead of silently falling back.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.core as T
import repro_torch.distsys as TD
import repro_torch.serve as TS
import repro_torch.workload as TW
from repro_torch.configs import qwen2_7b
from repro_torch.engine import LatencyEngine, PackedScheme, resolve_backend
from repro_torch.kernels import decode_attention, embedding_bag, flash_prefill, ops
from repro_torch.models import transformer as TM

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "benchmarks").glob("torch_*.py"))
              + sorted((ROOT / "examples").glob("torch_*.py")))


def _imported_modules(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_port_import_leaves_jax_unloaded():
    code = (
        "import sys, repro_torch, repro_torch.core.greedy, repro_torch.workload,"
        " repro_torch.models, repro_torch.configs, repro_torch.kernels.ops,"
        " repro_torch.distsys, repro_torch.graph, repro_torch.obs, repro_torch.serve,"
        " repro_torch.engine.incremental, repro_torch.engine.resilience;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _small_case():
    shard = np.array([0, 1, 2, 0, 1], np.int32)
    ps = T.PathSet.from_lists([[0, 1, 2], [3, 4]])
    return ps, shard, T.ReplicationScheme.from_sharding(shard, 3)


ENTRY_POINTS = {
    "LatencyEngine": lambda ps, shard, sc: LatencyEngine(sc),
    "PackedScheme.from_sharding": lambda ps, shard, sc: PackedScheme.from_sharding(shard, 3),
    "PackedScheme.from_mask": lambda ps, shard, sc: PackedScheme.from_mask(sc.mask, shard),
    "replicate_workload": lambda ps, shard, sc: T.replicate_workload(ps, shard, 3, 1),
    "is_latency_feasible": lambda ps, shard, sc: T.is_latency_feasible(ps, sc, 1),
    "query_slacks": lambda ps, shard, sc: T.query_slacks(ps, sc, 1),
    "path_latencies": lambda ps, shard, sc: T.path_latencies(ps, sc),
    "prune_scheme_replicas": lambda ps, shard, sc: T.prune_scheme_replicas(sc, ps, 1),
    "ops.path_latency": lambda ps, shard, sc: ops.path_latency(ps, sc),
    "Transformer": lambda ps, shard, sc: TM.Transformer(qwen2_7b.SMOKE),
    "cache_init": lambda ps, shard, sc: TM.cache_init(qwen2_7b.SMOKE, 1, 8),
    "execute_workload": lambda ps, shard, sc: TD.execute_workload(TD.Cluster(sc), ps),
    "trace_paths": lambda ps, shard, sc: TD.trace_paths(ps, sc, np.ones(3, bool)),
    "evaluate_baseline": lambda ps, shard, sc: T.evaluate_baseline(ps, sc),
    "repair_paths": lambda ps, shard, sc: T.repair_paths(
        sc, T.ReshardingMap.from_entries([], shard), ps, 1),
    "replicate_stream": lambda ps, shard, sc: T.replicate_stream([ps], shard, 3, 1),
    "stream_latencies": lambda ps, shard, sc: list(TW.stream_latencies([ps], sc)),
    "is_feasible_ls": lambda ps, shard, sc: T.is_feasible_ls(
        T.build_ls_instance([[1], [0]], 1), T.ReplicationScheme.from_sharding(
            np.array([0, 1, 1, 0], np.int32), 4)),
    "simulate": lambda ps, shard, sc: TS.simulate(TD.Cluster(sc), ps),
    "harness_simulate": lambda ps, shard, sc: TS.harness_simulate(TD.Cluster(sc), ps),
    "AdaptiveController": lambda ps, shard, sc: TS.AdaptiveController(
        TD.Cluster(sc), TS.ControllerConfig(t=1)),
}


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_raises_without_card(no_card, name):
    ps, shard, sc = _small_case()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](ps, shard, sc)


def test_backend_resolves_from_device():
    cpu = torch.device("cpu")
    assert resolve_backend(None, cpu) == "torch"
    assert resolve_backend(None, torch.device("cuda")) == "kernel"
    assert resolve_backend("reference", cpu) == "reference"
    with pytest.raises(ValueError, match="CUDA"):
        resolve_backend("kernel", cpu)
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("jnp", cpu)
    _, _, sc = _small_case()
    assert LatencyEngine(sc, device="cpu").backend == "torch"
    with pytest.raises(ValueError):
        LatencyEngine(sc, device="cpu", backend="kernel")


def test_unported_options_raise():
    """``mesh=`` stays refused with its reason (one card, no mesh type)."""
    ps, shard, sc = _small_case()
    for kw in ({"mesh": object()}, {"fused": True, "mesh": object()}):
        with pytest.raises(NotImplementedError, match="one card"):
            T.replicate_workload(ps, shard, 3, 1, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="one card"):
        T.replicate_delta(ps, LatencyEngine(sc, device="cpu"), 1, mesh=object())
    with pytest.raises(NotImplementedError, match="one card"):
        T.replicate_stream([ps], shard, 3, 1, device="cpu", mesh=object())


def test_obs_and_serve_are_importable_without_jax():
    import repro_torch.obs as TO
    import repro_torch.serve as TS

    assert set(TS.__all__) == {
        "AdmissionConfig", "BatchLadder", "BatchStats", "BatchingConfig", "HedgePolicy",
        "derive_deadlines", "SimReport", "simulate", "harness_simulate", "DriftPhase",
        "PhaseDelta", "path_delta", "drift_stream", "hotspot_phases", "snb_drift",
        "gnn_drift", "recsys_drift", "AdaptationReport", "AdaptiveController",
        "ControllerConfig", "evict_cold_replicas"}
    assert len(TS.__all__) == 21 and all(hasattr(TS, n) for n in TS.__all__)
    assert isinstance(TO.REGISTRY, TO.MetricsRegistry)


def _kernel_calls(device):
    q = torch.zeros(1, 128, 1, 2, 32, device=device)
    k = torch.zeros(1, 128, 1, 32, device=device)
    q1 = torch.zeros(1, 1, 2, 32, device=device)
    lengths = torch.ones(1, dtype=torch.int32, device=device)
    table = torch.zeros(4, 8, device=device)
    ids = torch.zeros(2, 3, dtype=torch.int32, device=device)
    return {
        "flash_prefill": lambda: ops.flash_prefill(q, k, k),
        "decode_attention": lambda: ops.decode_attention(q1, k, k, lengths),
        "embedding_bag": lambda: ops.embedding_bag(table, ids),
    }


@pytest.mark.parametrize("name", ["flash_prefill", "decode_attention", "embedding_bag"])
def test_kernel_ops_dispatch_by_tensor_device(name):
    """A CPU tensor runs the plain version (no launch counted); any device
    but the CPU and CUDA raises.  A CUDA tensor launches the kernel
    (tests/test_torch_lm_kernels.py, on a card)."""
    mod = {"flash_prefill": flash_prefill, "decode_attention": decode_attention,
           "embedding_bag": embedding_bag}[name]
    before = mod.LAUNCHES
    out = _kernel_calls("cpu")[name]()
    assert out.device.type == "cpu" and torch.isfinite(out).all()
    assert mod.LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported device"):
        _kernel_calls("meta")[name]()


def test_model_runs_on_the_cpu_when_asked():
    m = TM.Transformer(qwen2_7b.SMOKE, device="cpu")
    assert m.embed.device.type == "cpu" and m.layers[0].wq.device.type == "cpu"
    assert TM.cache_init(qwen2_7b.SMOKE, 1, 8, device="cpu")["k"].device.type == "cpu"
