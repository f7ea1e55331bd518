"""Multi-device layout of the path-sharded fused greedy, and the row quantum.

The fused UPDATE is embarrassingly parallel over paths: every path of a
batch prices its candidates against the same packed-words snapshot, and
the scatter-OR union of the chosen additions is order-free (Thm 5.3
monotonicity, the argument behind the lock-free batch).  The layout is the
JAX package's (``repro.engine.sharding``):

  * the packed scheme words and the gate's holder-rank vector are
    **replicated**, one copy per shard (:func:`replicate`); the shard map,
    ``f`` and the C(h, t) tables are read-only and copied once per device;
  * a batch's rows (objects, lengths, budgets) are **split on the path
    axis** into contiguous blocks, one per shard (:func:`batch_put`);
  * each shard gates and scores its block against its replica, then every
    shard's chosen (object, server) pairs are OR-ed into every other
    replica and the stat partials summed (``repro_torch.core.greedy``).
    Where JAX's GSPMD all-gathers the chosen additions, the port copies the
    pairs shard to shard: the additions move, never the dense words.

A :class:`ProvisioningMesh` is a tuple of devices on one axis,
:data:`PATH_AXIS`.  A device may repeat: N shards on one device run one
after another on its stream, the port's counterpart of XLA's
``--xla_force_host_platform_device_count`` (the CPU tests, and N shards on
one card).

Training and serving on a mesh of ranks is ``repro_torch.models.parallel``
(DTensor, ``launch.mesh.make_host_mesh`` / ``make_production_mesh``).  The
row quantum the incremental dirty-set evaluator pads its blocks with rounds by
the device count as the JAX package rounds it, so the padded shapes of the
two packages agree.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.engine.streaming import book_upload, resolve_device, staged

PATH_AXIS = "paths"


def device_count(device=None) -> int:
    """Devices a path block is split across: the visible cards on CUDA
    (``device`` None means CUDA, the port's default), 1 on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return max(1, torch.cuda.device_count())
    return 1


def round_up_rows(n: int, align: int = 128, device=None) -> int:
    """Round a row count up to ``align`` x the device count of ``device``.

    The incremental dirty-set evaluator (``repro_torch.engine.incremental``)
    pads its pinned path block and its compacted dirty blocks with this
    quantum, as the JAX package does.  The walks treat every row as an
    independent lane, so pad rows (empty paths) change no result.
    Always returns at least one full quantum.
    """
    q = max(1, int(align)) * device_count(device)
    return max(q, -(-int(n) // q) * q)


def _normalize(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class ProvisioningMesh:
    """A 1-D mesh over the path axis: one shard per entry of ``devices``.

    ``devices`` may repeat a device (several shards on it).  All entries are
    CPU or all are CUDA: a mixed list raises, and a CUDA mesh raises on a
    machine without a card.  CUDA entries without an index take the
    current card's.
    """

    devices: tuple
    axis: str = PATH_AXIS

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in devs}
        if len(kinds) > 1:
            raise ValueError(f"a mesh's devices must be all CPU or all CUDA, got {sorted(kinds)}")
        if kinds - {"cpu", "cuda"}:
            raise ValueError(f"unsupported mesh device type {sorted(kinds)}; use 'cuda' or 'cpu'")
        resolve_device(devs[0])  # a CUDA mesh without a card raises
        devs = tuple(_normalize(d) for d in devs)
        for d in devs:
            if d.type == "cuda" and d.index >= torch.cuda.device_count():
                raise ValueError(f"{d} is not visible ({torch.cuda.device_count()} cards)")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """The device of shard 0: the replica every host-side reader reads."""
        return self.devices[0]

    def round_batch(self, batch_size: int) -> int:
        """``batch_size`` rounded up to a multiple of the shard count."""
        return -(-int(batch_size) // self.size) * self.size


def provisioning_mesh(n_devices: int | None = None, device=None) -> ProvisioningMesh:
    """1-D mesh over the path axis.

    On CUDA (``device`` None means CUDA) the first ``n_devices`` visible
    cards (all by default), as ``jax.devices()[:n]``; it raises without a
    card or when fewer cards are visible.  On the CPU, ``n_devices`` shards
    (default 1) on the host.
    """
    dev = resolve_device(device)
    if dev.type == "cpu":
        return ProvisioningMesh((dev,) * (1 if n_devices is None else int(n_devices)))
    n_visible = torch.cuda.device_count()
    n = n_visible if n_devices is None else int(n_devices)
    if not 1 <= n <= n_visible:
        raise ValueError(f"asked for {n} cards, {n_visible} visible")
    return ProvisioningMesh(tuple(torch.device("cuda", i) for i in range(n)))


@dataclasses.dataclass
class ExchangeStats:
    """Device-to-device traffic of the sharded drive (none of it is host
    traffic, so none of it is in ``TRANSFER``)."""

    # int32 (object, server) pairs OR-ed from one shard into another
    # shard's replica, 8 bytes a pair and target
    pair_bytes: int = 0
    pairs: int = 0
    # dense copies made by replicate() (the words and the rank vector, once
    # per driver call)
    replica_bytes: int = 0

    def reset(self) -> None:
        self.pair_bytes = self.pairs = self.replica_bytes = 0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


EXCHANGE = ExchangeStats()


def replicate(x: torch.Tensor, mesh: ProvisioningMesh) -> tuple:
    """One replica of ``x`` per shard (device-to-device copies: nothing
    goes into ``TRANSFER``).  ``x`` itself is shard 0's replica when it
    lies on the mesh's first device; every other shard gets its own copy,
    also on a device it shares, since each shard writes its replica."""
    out = []
    for s, dev in enumerate(mesh.devices):
        if s == 0 and x.device == dev:
            out.append(x)
            continue
        out.append(x.to(dev, copy=True))
        EXCHANGE.replica_bytes += x.numel() * x.element_size()
    return tuple(out)


def shard_bounds(rows: int, mesh: ProvisioningMesh) -> list[tuple[int, int]]:
    """Row range of each shard: contiguous blocks of ``ceil(rows / size)``
    rows (``PartitionSpec("paths")``); trailing shards of a short batch
    may be empty."""
    block = -(-rows // mesh.size)
    return [(min(s * block, rows), min((s + 1) * block, rows)) for s in range(mesh.size)]


def batch_put(mesh: ProvisioningMesh):
    """Counted host->device upload landing path-sharded on the mesh.

    ``put(x, payload_bytes=None)`` splits ``x``'s rows into the blocks of
    :func:`shard_bounds` and returns one tensor per shard.  It books
    ``TRANSFER`` through ``streaming.book_upload``, as ``to_device`` does:
    each row crosses the bus once (to exactly one device), and one put is
    one call.
    """

    def put(x, payload_bytes: int | None = None) -> tuple:
        a = book_upload(x, payload_bytes)
        host = staged(a, mesh.first)
        return tuple(host[lo:hi].to(dev, non_blocking=True)
                     for (lo, hi), dev in zip(shard_bounds(a.shape[0], mesh), mesh.devices))

    return put

