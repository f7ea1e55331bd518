"""k-resilient feasibility: latency bounds that survive server loss.

The paper's sufficient conditions guarantee ``h(p, r, rho) <= t_q`` only
while every replica is reachable — a path served through exactly one copy
is one crash away from violating its budget.  This module defines the
*loss cases* a k-resilient scheme must survive and the deterministic
failover sharding the resilient walk is evaluated under:

* a **loss case** is the union of ``k`` fault domains (default: one
  domain per server, so k=1 enumerates every single-server loss);
* the resilient latency of a path under a case is the ordinary policy
  walk with the lost servers' holder bits cleared from the packed words
  and every lost home remapped by **rotation failover**: the next alive
  server in fixed cyclic order ``home+1, home+2, ... (mod S)``.

Rotation failover is *scheme-independent* on purpose: the failover home
of an object depends only on the sharding function and the loss case,
never on which replicas currently exist.  That keeps the masked
``home_first`` walk monotone under replica additions (Thm 5.3 applies
per case), so the greedy repair rounds converge; a holder-derived
failover map (the executor's serving-time behavior) would move homes as
repairs add copies and re-open bounds the previous round closed.  The
serving plane routes around failures at least as well as the rotation
walk wherever the rotation target holds a copy — which the repair
guarantees for every access the masked walk needed.

This module sits in the engine layer (numpy only, no ``repro_torch.core``
imports) so both the backends and the greedy drivers can share it.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np


@dataclasses.dataclass(frozen=True)
class KResilient:
    """Resilience constraint: feasible under any loss of ``k`` domains.

    ``domains`` partitions (or just covers) the servers into fault
    domains — racks, zones — each a tuple of server ids; ``None`` means
    one singleton domain per server (classic k-server resilience).
    Frozen and hashable, like the routing policies.
    """

    k: int = 1
    domains: tuple[tuple[int, ...], ...] | None = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"KResilient.k must be >= 1, got {self.k}")
        if self.domains is not None:
            norm = tuple(
                tuple(int(s) for s in dom) for dom in self.domains
            )
            if not norm or any(len(d) == 0 for d in norm):
                raise ValueError("domains must be non-empty server groups")
            object.__setattr__(self, "domains", norm)

    def loss_cases(self, n_servers: int) -> list[np.ndarray]:
        """Every set of servers a k-combination of domains can take down.

        Returns a list of sorted int64 arrays, one per case, in
        deterministic (lexicographic) order.  A case that would take down
        *every* server is rejected — no scheme can survive it.
        """
        doms = self.domains
        if doms is None:
            doms = tuple((s,) for s in range(n_servers))
        for dom in doms:
            for s in dom:
                if not (0 <= s < n_servers):
                    raise ValueError(
                        f"fault domain server {s} out of range [0, {n_servers})"
                    )
        cases = []
        for combo in itertools.combinations(doms, self.k):
            lost = np.unique(np.concatenate([np.asarray(d, np.int64) for d in combo]))
            if len(lost) >= n_servers:
                raise ValueError(
                    "a loss case covers every server; no scheme is resilient"
                )
            cases.append(lost)
        return cases


def resolve_resilience(resilience) -> KResilient | None:
    """None | int k | KResilient -> KResilient | None."""
    if resilience is None:
        return None
    if isinstance(resilience, KResilient):
        return resilience
    if isinstance(resilience, (int, np.integer)):
        return KResilient(k=int(resilience))
    raise ValueError(
        f"resilience must be None, an int k, or KResilient, got {resilience!r}"
    )


def failover_shard(
    shard: np.ndarray, lost: np.ndarray, n_servers: int
) -> np.ndarray:
    """Rotation-failover sharding under a loss case (scheme-independent).

    Objects homed on a surviving server keep their home; objects homed on
    a lost server move to the next surviving server in fixed cyclic order
    ``home+1, home+2, ... (mod S)``.  Deterministic and independent of
    the replica mask — see the module docstring for why that matters.
    """
    shard = np.asarray(shard, np.int64)
    dead = np.zeros(n_servers, bool)
    dead[np.asarray(lost, np.int64)] = True
    out = shard.copy()
    need = dead[out]
    for off in range(1, n_servers):
        if not need.any():
            break
        cand = (shard + off) % n_servers
        take = need & ~dead[cand]
        out[take] = cand[take]
        need &= ~take
    return out.astype(np.int32)


def case_word_mask(lost: np.ndarray, n_words: int) -> np.ndarray:
    """int32 [W] bit-mask of a loss case's servers (for ``words & ~mask``).

    The bits are the JAX package's uint32 mask; the port keeps packed
    words as int32 (torch has no ``~`` for uint32), so the mask is
    returned in the same dtype (``.view(np.uint32)`` recovers the other).
    """
    out = np.zeros(n_words, np.uint32)
    for s in np.asarray(lost, np.int64):
        out[s // 32] |= np.uint32(1) << np.uint32(s % 32)
    return out.view(np.int32)
