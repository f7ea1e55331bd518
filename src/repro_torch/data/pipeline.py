"""Synthetic data pipeline with host prefetch (torch port of
``repro.data.pipeline``).

A deterministic generator produces global batches seeded by step (any
process can regenerate any step, which makes restart from a checkpoint
exact), a background thread prefetches ``prefetch`` batches ahead, and
``shard_batch`` places a host batch: on one device through pinned host
memory and a non-blocking copy, so the train step does not wait on the
upload, or on a mesh by partition specs (the JAX package's
``NamedSharding`` placement), each rank uploading only its own slice.
The generators are numpy, copied as they are: a step's batch is bit for
bit the JAX package's.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.engine.streaming import resolve_device
from repro_torch.graph.sampler import minibatch_sampler
from repro_torch.models.parallel import PartitionSpec, local_slice, mesh_device, placements


def lm_batch_fn(vocab: int, batch: int, seq: int) -> Callable[[int], dict]:
    """Deterministic synthetic LM batches (seeded by step)."""

    def make(step: int) -> dict:
        rng = np.random.default_rng(step)
        toks = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return make


def gnn_batch_fn(graph, fanouts, batch_nodes: int, d_feat: int,
                 n_classes: int) -> Callable[[int], dict]:
    """Sampled-minibatch batches via the port's neighbor sampler."""

    def make(step: int) -> dict:
        rng = np.random.default_rng(step)
        seeds = rng.integers(0, graph.n_nodes, (batch_nodes,))
        mb = minibatch_sampler(graph, seeds, fanouts, seed=step)
        feat = lambda ids: rng.standard_normal(
            (*ids.shape, d_feat)).astype(np.float32)
        return {
            "seed_x": feat(mb.seeds),
            "layer_x": [feat(l) for l in mb.layer_nodes],
            "layer_mask": [(l >= 0) for l in mb.layer_nodes],
            "labels": rng.integers(0, n_classes, mb.seeds.shape).astype(np.int32),
        }

    return make


class Prefetcher:
    """Background-thread prefetch of ``make_batch(step)`` results."""

    def __init__(self, make_batch: Callable[[int], dict], start_step: int = 0,
                 prefetch: int = 2):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._make(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        while True:
            yield self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)


def _upload(x, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dev.type == "cpu":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def shard_batch(batch, device=None, specs=None):
    """Place a host batch (a dict or list tree of numpy arrays).

    ``shard_batch(batch, device)``: on ``device`` (default CUDA; raises
    without a card unless ``"cpu"``); on a card each array goes through
    pinned memory with a non-blocking copy; on the CPU it becomes a tensor
    sharing the array's memory.

    ``shard_batch(batch, mesh, specs)`` (the JAX signature): each array as
    a DTensor on the ``DeviceMesh`` placed by its partition spec in
    ``specs`` (a tree of the batch's structure), each rank uploading only
    the slice it holds."""
    if isinstance(device, DeviceMesh):
        mesh = device
        dev = mesh_device(mesh)

        def place(x, spec):
            if isinstance(x, dict):
                return {k: place(v, spec[k]) for k, v in x.items()}
            if isinstance(x, (list, tuple)) and not isinstance(spec, PartitionSpec):
                return type(x)(place(v, s) for v, s in zip(x, spec))
            a = np.asarray(x)
            mine = _upload(local_slice(a, spec, mesh), dev)
            stride = tuple(int(s // a.itemsize) for s in np.ascontiguousarray(a).strides)
            return DTensor.from_local(mine, mesh, placements(spec, mesh), run_check=False,
                                      shape=torch.Size(a.shape), stride=stride)

        return place(batch, specs)
    dev = resolve_device(device)

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        return _upload(x, dev)

    return put(batch)
