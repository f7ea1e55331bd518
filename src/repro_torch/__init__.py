"""PyTorch/CUDA port of the latency-bound replication system.

Mirrors the subpackage and module names of the JAX package ``repro``
(``graph``, ``core``, ``workload``, ``engine``, ``distsys``, ``kernels``,
``models``, ``configs``) so each module's counterpart is easy to find.
The port imports ``torch``, numpy and the standard library only.

Every entry point takes ``device`` (default ``"cuda"``; pass ``"cpu"``
to run the plain torch versions on the host) and a backend that
defaults from the device: ``"kernel"`` (the hand-written CUDA kernels
in ``csrc/``) on a card, ``"torch"`` (plain torch ops) on the CPU, and
``"reference"`` (the pure-python oracle) on request.
"""
