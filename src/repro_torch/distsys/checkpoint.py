"""Checkpoint / restore for long-running jobs (fault tolerance substrate).

Design (production-style, no orbax in this environment):
  * a checkpoint is a directory ``step_<N>/`` holding the leaves of one
    tree in ``arrays.npz`` plus a JSON ``manifest.json`` with the tree
    structure, shapes, dtypes, step, and a content checksum;
  * writes go to ``step_<N>.tmp/`` then ``os.rename`` — atomic publish, a
    crashed writer never corrupts the latest checkpoint;
  * ``save_async`` snapshots to host memory synchronously (cheap) and
    writes on a background thread — training continues;
  * ``restore_latest`` scans the directory, verifies the manifest, and
    rebuilds the tree in the structure of a ``like`` tree: a leaf whose
    ``like`` is a tensor comes back as a tensor on that tensor's device,
    any other leaf as a numpy array;
  * retention keeps the newest K checkpoints.

A tree is nested dicts, lists and tuples (named tuples too) of numpy
arrays, tensors and scalars; ``None`` holds no leaf.  Leaves are taken in
the JAX package's ``jax.tree`` order (dict keys sorted, sequences in
order), so a checkpoint of the same tree has the same leaf names,
manifest checksum and ``arrays.npz`` in both packages.  A tensor of a
type numpy lacks (``bfloat16``) is stored as its raw bits in a signed
integer of the same width and viewed back on restore.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch

_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree, out: list) -> list:
    """The tree's leaves in ``jax.tree.flatten`` order."""
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _leaves(x, out)
    else:
        out.append(tree)
    return out


def _structure(tree) -> str:
    """A readable structure string, ``*`` for each leaf."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(x) for x in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_structure(x) for x in tree)
        name = type(tree).__name__ if _is_namedtuple(tree) else ""
        return f"{name}({inner}{',' if len(tree) == 1 and not name else ''})"
    return "*"


def _host(leaf) -> np.ndarray:
    """A host copy of one leaf (the snapshot)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        try:
            return t.numpy().copy()
        except TypeError:  # a dtype numpy lacks: keep the raw bits
            return t.view(_BITS[t.element_size()]).numpy().copy()
    return np.array(leaf)


def _flatten(tree) -> tuple[list[np.ndarray], list[str], str]:
    arrs = [_host(l) for l in _leaves(tree, [])]
    names = [f"leaf_{i}" for i in range(len(arrs))]
    return arrs, names, _structure(tree)


def _rebuild(like, it):
    """``like``'s structure with its leaves taken from ``it`` in leaf order."""
    if like is None:
        return None
    if isinstance(like, dict):
        got = {k: _rebuild(like[k], it) for k in sorted(like)}
        return {k: got[k] for k in like}
    if isinstance(like, (list, tuple)):
        items = [_rebuild(x, it) for x in like]
        if _is_namedtuple(like):
            return type(like)(*items)
        return type(like)(items)
    arr = next(it)
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(arr)
        if t.dtype != like.dtype and t.dtype == _BITS.get(like.element_size()):
            t = t.view(like.dtype)
        return t.to(like.device)
    return arr


def _checksum(arrs: list[np.ndarray]) -> str:
    h = hashlib.sha256()
    for a in arrs:
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes()[:65536])  # prefix checksum: fast, catches trunc
    return h.hexdigest()[:16]


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def _write(self, step: int, arrs, names, treedef_repr: str) -> None:
        tmp = os.path.join(self.directory, f"step_{step}.tmp")
        final = os.path.join(self.directory, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **dict(zip(names, arrs)))
        manifest = {
            "step": step,
            "names": names,
            "shapes": [list(a.shape) for a in arrs],
            "dtypes": [str(a.dtype) for a in arrs],
            "treedef": treedef_repr,
            "checksum": _checksum(arrs),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as fh:
            json.dump(manifest, fh)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"))

    # ------------------------------------------------------------------
    def save(self, step: int, tree) -> None:
        arrs, names, treedef = _flatten(tree)
        self._write(step, arrs, names, treedef)

    def save_async(self, step: int, tree) -> None:
        """Snapshot now (host copies), write in the background."""
        self.wait()
        arrs, names, treedef = _flatten(tree)  # host copy = snapshot
        self._thread = threading.Thread(
            target=self._write, args=(step, arrs, names, treedef), daemon=True
        )
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def restore(self, step: int, like):
        """Restore into the structure of ``like`` (shape/dtype verified)."""
        self.wait()
        path = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as fh:
            manifest = json.load(fh)
        data = np.load(os.path.join(path, "arrays.npz"))
        arrs = [data[n] for n in manifest["names"]]
        if _checksum(arrs) != manifest["checksum"]:
            raise IOError(f"checksum mismatch in checkpoint step_{step}")
        leaves = _leaves(like, [])
        assert len(leaves) == len(arrs), "checkpoint/tree structure mismatch"
        for got, want in zip(arrs, leaves):
            shape = tuple(want.shape) if isinstance(want, torch.Tensor) else np.shape(want)
            assert got.shape == shape, (got.shape, shape)
        return _rebuild(like, iter(arrs))

    def restore_latest(self, like):
        steps = self.all_steps()
        if not steps:
            return None, -1
        return self.restore(steps[-1], like), steps[-1]
