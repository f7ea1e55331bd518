"""The ``nearest_copy`` access walk, plainly (Eqn 1 under hop routing).

A path starts on its root's home server.  An access is local when the
current server holds a copy of the object.  A remote access costs one
distributed traversal and lands on a holder of the object: a holder that
also holds the path's next object if there is one, else any holder; among
those the object's home if it is one, else the lowest server id.  The
traversal count h of a path is its number of remote accesses.
"""
from __future__ import annotations

import numpy as np
import torch


def hops(objects: torch.Tensor, lengths: torch.Tensor, mask: torch.Tensor,
         home: torch.Tensor) -> torch.Tensor:
    """int32 [P] traversal counts of the paths ``objects`` (int32 [P, L],
    -1 pad) with ``lengths`` (int32 [P]) under the replica ``mask`` (bool
    [n, S]) and the home servers ``home`` (int64 [n]), all on one device."""
    P, L = objects.shape
    dev = objects.device
    if P == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    valid = torch.arange(L, device=dev)[None, :] < lengths[:, None]
    safe = objects.clamp_min(0).long()
    cur = home[safe[:, 0]]
    h = torch.zeros(P, dtype=torch.int32, device=dev)
    for x in range(1, L):
        v = safe[:, x]
        held = mask[v]  # [P, S]
        local = held.gather(1, cur[:, None])[:, 0]
        remote = valid[:, x] & ~local
        h += remote.int()
        cand = held
        if x + 1 < L:
            both = held & mask[safe[:, x + 1]] & valid[:, x + 1, None]
            cand = torch.where(both.any(1, keepdim=True), both, held)
        hv = home[v]
        pick = torch.where(cand.gather(1, hv[:, None])[:, 0], hv, cand.int().argmax(1))
        cur = torch.where(remote, pick, cur)
    return h


def hops_one(path: list, bits: list, home, limit: int) -> int:
    """The same count for one path, with each object's holders as the bits
    of a Python int (``bits[v] >> s & 1``): the serial prune's walk, which
    stops once the count passes ``limit``."""
    cur = home[path[0]]
    h = 0
    n = len(path)
    for x in range(1, n):
        held = bits[path[x]]
        if held >> cur & 1:
            continue
        h += 1
        if h > limit:
            return h
        cand = held
        if x + 1 < n:
            both = held & bits[path[x + 1]]
            if both:
                cand = both
        hv = home[path[x]]
        cur = hv if cand >> hv & 1 else (cand & -cand).bit_length() - 1
    return h


def bits_of(mask: np.ndarray) -> list:
    """Each row of a bool [n, S] mask as a Python int, bit s = server s."""
    S = mask.shape[1]
    if S <= 62:
        return (mask.astype(np.int64) @ (np.int64(1) << np.arange(S, dtype=np.int64))).tolist()
    return [int("".join("1" if b else "0" for b in row[::-1]), 2) for row in mask]
