"""Host->device transfer accounting, device resolution and chunk streaming.

Every host->device transfer the engine performs goes through
``to_device`` so the byte counter (``TRANSFER``) reflects real traffic.
``h2d_bytes`` counts *payload* bytes only — alignment padding a caller
appends is tracked separately in ``padded_bytes``.  On a CUDA device the
copy is staged through pinned host memory and issued with
``non_blocking=True``, so it overlaps work already queued on the stream.

``stream_chunks`` is the engine's evaluation pipeline: while chunk ``i``
computes on the device (kernel launches are asynchronous), chunk
``i + 1``'s host->device copy is already enqueued.

``resolve_device`` is the port's one device rule: ``None`` means
``"cuda"``, and asking for CUDA on a machine without a card raises
instead of silently running on the CPU.

``PathStream`` is the provisioning-scale ingestion contract: a host
generator of :class:`~repro_torch.core.paths.PathSet` chunks, consumed
once, with peak-residency accounting; ``double_buffer`` is the two-deep
pipeline :func:`repro_torch.core.greedy.replicate_stream` drives it with.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class TransferStats:
    h2d_bytes: int = 0
    h2d_calls: int = 0
    d2h_bytes: int = 0
    # readbacks: each one waits for the device
    d2h_calls: int = 0
    # alignment-pad bytes appended by callers; they cross the bus but
    # carry no workload data
    padded_bytes: int = 0
    # bytes uploaded for incremental dirty-set evaluation (the compacted
    # dirty-row index vectors of ``repro_torch.engine.incremental``): a
    # subset of h2d_bytes, broken out so the incremental path's transfer
    # savings are visible next to what a full re-upload would have cost
    gathered_bytes: int = 0

    def reset(self) -> None:
        self.h2d_bytes = 0
        self.h2d_calls = 0
        self.d2h_bytes = 0
        self.d2h_calls = 0
        self.padded_bytes = 0
        self.gathered_bytes = 0

    def snapshot(self) -> dict:
        return {
            "h2d_bytes": self.h2d_bytes,
            "h2d_calls": self.h2d_calls,
            "d2h_bytes": self.d2h_bytes,
            "d2h_calls": self.d2h_calls,
            "padded_bytes": self.padded_bytes,
            "gathered_bytes": self.gathered_bytes,
        }

    @contextlib.contextmanager
    def scope(self):
        """Isolate a region's transfer accounting, preserving outer totals.

        On entry the counters reset to zero, so assertions inside the
        block see only the block's own traffic; on exit the pre-entry
        values are added back, so the process-level totals equal outer +
        inner as if the scope had never existed.  Nests cleanly.
        """
        saved = self.snapshot()
        self.reset()
        try:
            yield self
        finally:
            for key, value in saved.items():
                setattr(self, key, getattr(self, key) + value)


TRANSFER = TransferStats()


def resolve_device(device=None) -> torch.device:
    """``None`` -> CUDA.  A CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch version on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def book_upload(x, payload_bytes: int | None = None) -> np.ndarray:
    """``x`` as a C-contiguous array, its host->device upload booked in
    ``TRANSFER`` as one call: ``payload_bytes`` (default all) of real data
    under ``h2d_bytes``, the remainder (alignment padding) under
    ``padded_bytes``."""
    a = np.ascontiguousarray(x)
    payload = a.nbytes if payload_bytes is None else int(payload_bytes)
    TRANSFER.h2d_bytes += payload
    TRANSFER.padded_bytes += a.nbytes - payload
    TRANSFER.h2d_calls += 1
    return a


def staged(a: np.ndarray, device) -> torch.Tensor:
    """Host tensor holding a copy of ``a`` to upload to ``device`` from:
    pinned for a card (the copy can then be non-blocking); never aliases
    ``a``."""
    if device.type == "cuda":
        return torch.from_numpy(a if a.flags.writeable else a.copy()).pin_memory()
    return torch.from_numpy(a.copy())


def to_device(x, device, payload_bytes: int | None = None) -> torch.Tensor:
    """Counted host->device copy to one device (booked by
    :func:`book_upload`; ``sharding.batch_put`` is the path-sharded
    counterpart).  The result never aliases ``x``: callers may update it
    in place.
    """
    return staged(book_upload(x, payload_bytes), device).to(device, non_blocking=True)


def to_host(t: torch.Tensor) -> np.ndarray:
    """Counted device->host readback (blocks until the value is ready)."""
    a = t.detach().cpu().numpy()
    TRANSFER.d2h_bytes += a.nbytes
    TRANSFER.d2h_calls += 1
    return a


def stream_chunks(
    arrays: Sequence[np.ndarray],
    n: int,
    chunk: int,
    compute: Callable,
    pad_values: Sequence[int],
    device,
    align: int = 128,
) -> list:
    """Double-buffered map of ``compute`` over row-chunks of ``arrays``.

    ``arrays`` are host arrays sharing leading dimension ``n``.  Full
    chunks have exactly ``chunk`` rows; the final partial chunk is padded
    up to a multiple of ``align`` with ``pad_values`` (one per array).
    Returns the list of *device* outputs (callers concatenate and read
    back once at the end, keeping the launches asynchronous).
    """
    if n == 0:
        return []

    def put(start: int):
        stop = min(start + chunk, n)
        rows = stop - start
        target = chunk if rows == chunk else -(-rows // align) * align
        out = []
        for a, pv in zip(arrays, pad_values):
            piece = a[start:stop]
            payload = piece.nbytes
            if rows < target:
                pad = np.full((target - rows,) + a.shape[1:], pv, a.dtype)
                piece = np.concatenate([piece, pad], axis=0)
            out.append(to_device(piece, device, payload_bytes=payload))
        return tuple(out)

    starts = list(range(0, n, chunk))
    outs = []
    nxt = put(starts[0])
    for i in range(len(starts)):
        cur = nxt
        outs.append(compute(*cur))  # asynchronous launch
        if i + 1 < len(starts):
            nxt = put(starts[i + 1])  # upload overlaps the in-flight compute
    return outs


def double_buffer(items: Iterable, dispatch: Callable) -> float:
    """Two-deep pipeline over a lazy producer: overlap ingest with compute.

    ``dispatch(item)`` must *enqueue* device work and return without
    blocking on it (CUDA launches are asynchronous, and ``to_device``
    copies from pinned memory with ``non_blocking=True``, as long as
    nothing reads a device value back).  While that work is in flight the
    next item is pulled from ``items``, so a generator producer builds
    chunk ``i + 1`` on the host during chunk ``i``'s device compute.  On
    the CPU the same loop runs eagerly, in order.  No thread is used: an
    exception in the producer or the dispatch propagates at once.

    Returns the host seconds of producer work that ran while earlier work
    was in flight; the first item has nothing to hide behind and is not
    counted.
    """
    it = iter(items)
    try:
        cur = next(it)
    except StopIteration:
        return 0.0
    overlap_s = 0.0
    while True:
        dispatch(cur)
        t0 = time.perf_counter()
        try:
            cur = next(it)  # producer runs while the device computes
        except StopIteration:
            return overlap_s
        overlap_s += time.perf_counter() - t0


@dataclasses.dataclass
class StreamStats:
    """Residency accounting of one :class:`PathStream` consumption."""

    total_paths: int = 0
    chunks: int = 0
    peak_resident_paths: int = 0
    # host seconds of chunk materialization hidden behind device compute
    # (filled by pipelined consumers; 0.0 for a strict pull-then-compute)
    ingest_overlap_s: float = 0.0
    # candidate-table residency (filled by replicate_stream): the largest
    # host block of C(h, t) selection rows ever materialized at once vs.
    # the total rows shipped
    peak_resident_table_rows: int = 0
    total_table_rows: int = 0


class PathStream:
    """Streamed PathSet ingestion from a host generator (consumed once).

    Wraps an iterable of :class:`~repro_torch.core.paths.PathSet` chunks —
    or ``(PathSet, per_query_budgets)`` tuples when the latency constraint
    varies within the stream — and records how many paths were ever
    host-resident at once (``stats.peak_resident_paths``).  Iteration
    yields normalized ``(PathSet, budgets_or_None)`` pairs; generators are
    consumed lazily, so the producer can build each chunk on demand and
    drop it after the yield.  Empty chunks are skipped.
    """

    def __init__(self, chunks: Iterable):
        self._chunks = chunks
        self._consumed = False
        self.stats = StreamStats()

    def __iter__(self) -> Iterator[tuple]:
        if self._consumed:
            raise RuntimeError("PathStream is single-use; build a new one")
        self._consumed = True
        for item in self._chunks:
            ps, t = item if isinstance(item, tuple) else (item, None)
            if ps.n_paths == 0:
                continue
            self.stats.total_paths += ps.n_paths
            self.stats.chunks += 1
            self.stats.peak_resident_paths = max(
                self.stats.peak_resident_paths, ps.n_paths
            )
            yield ps, t
