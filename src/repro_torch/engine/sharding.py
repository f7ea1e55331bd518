"""Row quantum of the engine's padded device blocks.

The JAX package lays the fused greedy out on a ``jax.sharding`` mesh
(scheme words replicated, batch rows split on a path axis).  The port
targets one card and has no mesh type: every multi-card request (``mesh=``,
the bundles' shardings, ``launch.mesh``, a dry-run over TPU pods, an
elastic step over more than one device) is refused through
:func:`refuse_multi_card`.  What carries over is the row quantum the
incremental dirty-set evaluator pads its blocks with, rounded by the
device count as the JAX package rounds it, so the padded shapes of the
two packages agree.
"""
from __future__ import annotations

import torch


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


def refuse_multi_card(what: str):
    """Raise ``NotImplementedError`` for a multi-card request ``what``: the
    one refusal of the port, with its one reason."""
    raise NotImplementedError(
        f"{what} is refused: the port targets one card and has no mesh type; "
        "multi-card sharding is still to do (the batch row quantum still "
        "rounds by the device count, repro_torch.engine.sharding.round_up_rows)"
    )
