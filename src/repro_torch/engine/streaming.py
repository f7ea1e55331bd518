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
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class TransferStats:
    h2d_bytes: int = 0
    h2d_calls: int = 0
    d2h_bytes: int = 0
    # alignment-pad bytes appended by callers; they cross the bus but
    # carry no workload data
    padded_bytes: int = 0

    def reset(self) -> None:
        self.h2d_bytes = 0
        self.h2d_calls = 0
        self.d2h_bytes = 0
        self.padded_bytes = 0

    def snapshot(self) -> dict:
        return {
            "h2d_bytes": self.h2d_bytes,
            "h2d_calls": self.h2d_calls,
            "d2h_bytes": self.d2h_bytes,
            "padded_bytes": self.padded_bytes,
        }


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


def to_device(x, device, payload_bytes: int | None = None) -> torch.Tensor:
    """Counted host->device copy (the only upload path in the engine).

    ``payload_bytes`` marks how many of the array's bytes are real data;
    the remainder (alignment padding) is booked under
    ``TRANSFER.padded_bytes`` instead of ``h2d_bytes``.  The result never
    aliases ``x``: callers may update it in place.
    """
    a = np.ascontiguousarray(x)
    payload = a.nbytes if payload_bytes is None else int(payload_bytes)
    TRANSFER.h2d_bytes += payload
    TRANSFER.padded_bytes += a.nbytes - payload
    TRANSFER.h2d_calls += 1
    if device.type == "cuda":
        host = torch.from_numpy(a if a.flags.writeable else a.copy())
        return host.pin_memory().to(device, non_blocking=True)
    return torch.from_numpy(a.copy())


def to_host(t: torch.Tensor) -> np.ndarray:
    """Counted device->host readback (blocks until the value is ready)."""
    a = t.detach().cpu().numpy()
    TRANSFER.d2h_bytes += a.nbytes
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
