"""Build the CUDA kernels with ``nvcc`` at first use and load them.

Every ``csrc/*.cu`` source is compiled for ``sm_90a`` by its own ``nvcc``
process (all started together), and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``build/repro_torch_kernels/<hash>/`` at the repository
root, keyed by a hash of the sources, the shared ``csrc/*.cuh`` headers
and the flags, so a changed source or header is rebuilt and an unchanged
tree is reused.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argtypes (pointers and the stream as c_void_p)
SIGNATURES = {
    "path_latency_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "routed_walk_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "scored_walk_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "prune_walk_launch": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "prune_walk_scored_launch": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                                 _P],
    "fused_update_class_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # the last int before the stream is a DTYPE_CODES value
    "flash_prefill_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "flash_prefill_wgmma_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "decode_attention_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _I, _P],
    "embedding_bag_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}

# floating-point element types the attention and embedding kernels take
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# devices on which the model kernels' wrappers (flash_prefill,
# decode_attention, embedding_bag) compute the plain torch version: the
# host, and ``meta`` (shapes only: the one-card dry-run counts a step's
# operations there, and no kernel can run on it).  A CUDA tensor launches
# the kernel or raises; any other device raises.  The walks' plain
# versions read their data on the host as they go, so they have no
# ``meta`` form and their wrappers take the CPU only.
PLAIN_DEVICES = ("cpu", "meta")

_LIB: ctypes.CDLL | None = None
BUILD_SECONDS: float | None = None
# called with the build's seconds after every build that ran nvcc (a
# cached library calls none); ``repro_torch.obs.install_compile_hook``
# counts builds through it
BUILD_LISTENERS: list = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "librepro_torch_kernels.so"


def build() -> pathlib.Path:
    """Compile and link the kernels if the hashed library is missing."""
    global BUILD_SECONDS
    so = library_path()
    if so.exists():
        return so
    t0 = time.perf_counter()
    out_dir = so.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *CFLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    errors = []
    for cmd, obj, proc in procs:
        log, _ = proc.communicate()
        obj.with_suffix(".log").write_text(log)  # ptxas registers, shared memory, spills
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{log}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = out_dir / f"{so.name}.{os.getpid()}.tmp"
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs),
            "-ldl"]
    res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{' '.join(link)}\n{res.stdout}")
    os.replace(tmp, so)
    BUILD_SECONDS = time.perf_counter() - t0
    for listener in BUILD_LISTENERS:
        listener(BUILD_SECONDS)
    return so


def load_library() -> ctypes.CDLL:
    """The kernels' shared library (built on first call, then cached)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def refuse_grad(name: str, *inputs: torch.Tensor) -> None:
    """The kernels have no backward (nor do the Pallas kernels they
    replace: JAX refuses to differentiate them).  Under grad mode an input
    that requires grad would get no gradient through the kernel's output,
    so raise, on every device, instead of training silently wrong."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() or on inputs "
            "that do not require grad (training takes the torch-op path)")
