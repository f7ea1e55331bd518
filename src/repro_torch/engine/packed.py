"""Device-resident packed replication state (the engine's source of truth).

The replication scheme is stored on the device as 32-bit words
``words[v, w]``: bit ``s % 32`` of word ``s // 32`` is set iff object
``v`` has a copy at server ``s``.  Packing is little-endian within a word
(server ``32w`` is bit 0 of word ``w``), the layout the CUDA kernels read.

The words are kept as **int32**: torch lacks ``>>``, ``~``,
``index_put_`` and ``scatter_reduce`` for uint32, while every int32 op the
engine needs is sign-safe (``(w >> b) & 1`` is bit ``b`` for any
``0 <= b < 32``; bit 31 is the constant ``-2**31``).  The words are viewed
as uint32 only at the numpy boundary (``from_numpy`` / ``numpy_words``),
where they equal the JAX package's ``PackedScheme.words`` bit for bit.

``words`` carries one *sacrificial* extra row (index ``n_objects``):
vectorized callers route masked-out updates there instead of compacting.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.engine.streaming import resolve_device, to_device, to_host


def n_words(n_servers: int) -> int:
    """Number of 32-bit words needed for ``n_servers`` membership bits."""
    return (n_servers + 31) // 32


@dataclasses.dataclass
class PackStats:
    """Host bool-mask bytes (one per (object, server) cell) packed into
    words and unpacked from them: each full pass over a scheme's host mask
    shows as its n_objects x n_servers bytes, whichever side does the bit
    work (:func:`pack_bool_mask` / :func:`unpack_words` on the host,
    :meth:`PackedScheme.from_mask` / :meth:`PackedScheme.unpack` on the
    words' device).  ``mask_bytes_on_device`` counts the bytes of those
    passes done on the words' device."""

    mask_bytes_packed: int = 0
    mask_bytes_unpacked: int = 0
    mask_bytes_on_device: int = 0


PACK = PackStats()


def pack_bool_mask(mask: np.ndarray) -> np.ndarray:
    """Host-side pack: bool [R, S] -> uint32 [R, ceil(S/32)]."""
    R, S = mask.shape
    PACK.mask_bytes_packed += R * S
    W = n_words(S)
    padded = np.zeros((R, W * 32), dtype=bool)
    padded[:, :S] = mask
    bits = padded.reshape(R, W, 32).astype(np.uint32)
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32))[None, None, :]
    return (bits * weights).sum(axis=2).astype(np.uint32)


def unpack_words(words: np.ndarray, n_servers: int) -> np.ndarray:
    """Host-side unpack: uint32 (or int32) [R, W] -> bool [R, n_servers]."""
    words = np.asarray(words).view(np.uint32)
    R, W = words.shape
    PACK.mask_bytes_unpacked += R * n_servers
    shifts = np.arange(32, dtype=np.uint32)
    bits = (words[:, :, None] >> shifts[None, None, :]) & np.uint32(1)
    return bits.reshape(R, W * 32)[:, :n_servers].astype(bool)


def bit_value(b: int) -> int:
    """The int32 value with only bit ``b`` set (bit 31 is ``-2**31``)."""
    return -(2**31) if b == 31 else 1 << b


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """[..., W] int32 -> [..., W*32] bool holder bits (little-endian)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32).bool()


def pack_mask_bits(mask: torch.Tensor, words: torch.Tensor) -> None:
    """OR bool ``mask [R, S]`` into int32 ``words [R, ceil(S/32)]`` in place,
    on their device: one round per bit position ``b < 32``, over the
    columns ``b, b + 32, ...`` at once, so no temporary is larger than the
    words (the host packer widens every cell to 32 lanes)."""
    S = mask.shape[1]
    for b in range(min(S, 32)):
        cols = mask[:, b::32]
        words[:, : cols.shape[1]].bitwise_or_(cols.to(torch.int32).mul_(bit_value(b)))


def unpack_mask_bits(words: torch.Tensor, n_servers: int) -> torch.Tensor:
    """int32 ``words [R, W]`` -> bool ``[R, n_servers]`` on their device, one
    round per bit position (the inverse of :func:`pack_mask_bits`)."""
    mask = torch.empty((words.shape[0], n_servers), dtype=torch.bool, device=words.device)
    for b in range(min(n_servers, 32)):
        cols = mask[:, b::32]
        cols.copy_((words[:, : cols.shape[1]] & bit_value(b)) != 0)
    return mask


def test_bits(words: torch.Tensor, objects: torch.Tensor, servers: torch.Tensor):
    """Membership bit-test against the packed words.

    ``objects`` and ``servers`` broadcast against each other; both must be
    pre-clamped to valid ranges.  Returns bool of the broadcast shape.
    """
    objects, servers = torch.broadcast_tensors(objects.long(), servers.long())
    word = words[objects, servers // 32]
    return ((word >> (servers % 32)) & 1).bool()


def _scatter_pairs(words, objects, servers, clear: bool):
    pad_row = words.shape[0] - 1
    objects = objects.reshape(-1).long()
    servers = servers.reshape(-1).long()
    ok = (objects >= 0) & (servers >= 0) & (objects < pad_row)
    obj = torch.where(ok, objects, pad_row)
    srv = torch.where(ok, servers, 0)
    w_idx = srv // 32
    b_idx = srv % 32
    for b in range(32):
        sel = b_idx == b
        o = torch.where(sel, obj, pad_row)
        w = torch.where(sel, w_idx, 0)
        old = words[o, w]
        bit = bit_value(b)
        words.index_put_((o, w), (old & ~bit) if clear else (old | bit))
    return words


def scatter_or_pairs(
    words: torch.Tensor, objects: torch.Tensor, servers: torch.Tensor
) -> torch.Tensor:
    """Monotone scatter-OR of (object, server) pairs into the words, in place.

    Deterministic under duplicate pairs (OR is idempotent): the update is
    bit-sliced into 32 rounds; within a round every duplicate write to a
    cell carries the identical value, so ``index_put_`` without
    ``accumulate`` is deterministic on the CPU and on CUDA.  Pairs with a
    negative object or server — and the sacrificial row itself — are
    routed to the sacrificial last row.  Returns ``words``.
    """
    return _scatter_pairs(words, objects, servers, clear=False)


def scatter_clear_pairs(
    words: torch.Tensor, objects: torch.Tensor, servers: torch.Tensor
) -> torch.Tensor:
    """Clear (object, server) membership bits in place (same discipline as
    :func:`scatter_or_pairs`).  Removals are NOT monotone."""
    return _scatter_pairs(words, objects, servers, clear=True)


def storage_per_server(words: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """f_r(s) per server from packed words, on the device: float32 [W*32].

    A float32 ``f @ mask`` product (left to the library, as the JAX
    package left it to XLA); the caller slices ``[:n_servers]``.
    """
    n = f.shape[0]
    mask = unpack_bits(words[:n]).to(torch.float32)
    return f @ mask


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of every row but the sacrificial one (int64 scalar)."""
    v = words[:-1].to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).sum()


@dataclasses.dataclass
class PackedScheme:
    """Incrementally maintained device-resident replication scheme.

    Attributes:
      words: int32 [n_objects + 1, W] on the device (sacrificial last row).
      shard: int32 [n_objects] on the device (the sharding function d).
      n_servers: membership bits in use per row.
    """

    words: torch.Tensor
    shard: torch.Tensor
    n_servers: int

    @property
    def n_objects(self) -> int:
        return self.words.shape[0] - 1

    @property
    def n_words(self) -> int:
        return self.words.shape[1]

    @property
    def device(self) -> torch.device:
        return self.words.device

    @classmethod
    def from_numpy(cls, words_u32: np.ndarray, shard: np.ndarray, device=None,
                   n_servers: int | None = None) -> "PackedScheme":
        """Adopt packed words (uint32, sacrificial row included) as they
        are held by the JAX package's ``PackedScheme``."""
        device = resolve_device(device)
        w = np.ascontiguousarray(words_u32, dtype=np.uint32)
        if n_servers is None:
            n_servers = w.shape[1] * 32
        return cls(
            words=to_device(w.view(np.int32), device),
            shard=to_device(np.asarray(shard, dtype=np.int32), device),
            n_servers=int(n_servers),
        )

    @classmethod
    def from_mask(cls, mask: np.ndarray, shard: np.ndarray, device=None) -> "PackedScheme":
        """One upload of the bool mask, packed into words on the device."""
        device = resolve_device(device)
        mask = np.asarray(mask, dtype=bool)
        n, S = mask.shape
        PACK.mask_bytes_packed += n * S
        PACK.mask_bytes_on_device += n * S
        words = torch.zeros((n + 1, n_words(S)), dtype=torch.int32, device=device)
        pack_mask_bits(to_device(mask, device), words[:n])
        return cls(
            words=words,
            shard=to_device(np.asarray(shard, dtype=np.int32), device),
            n_servers=S,
        )

    @classmethod
    def from_sharding(cls, shard: np.ndarray, n_servers: int, device=None) -> "PackedScheme":
        n = shard.shape[0]
        host = np.zeros((n + 1, n_words(n_servers)), dtype=np.uint32)
        s = np.asarray(shard, dtype=np.int64)
        host[np.arange(n), s // 32] = np.uint32(1) << (s % 32).astype(np.uint32)
        return cls.from_numpy(host, shard, device, n_servers=n_servers)

    def numpy_words(self) -> np.ndarray:
        """uint32 [n_objects + 1, W] host copy (the JAX package's layout)."""
        return to_host(self.words).view(np.uint32)

    def add(self, objects, servers) -> None:
        """On-device monotone scatter-OR of host (object, server) pairs."""
        scatter_or_pairs(
            self.words,
            to_device(np.asarray(objects, dtype=np.int32), self.device),
            to_device(np.asarray(servers, dtype=np.int32), self.device),
        )

    def remove(self, objects, servers) -> None:
        """On-device membership-bit clear (NOT monotone)."""
        scatter_clear_pairs(
            self.words,
            to_device(np.asarray(objects, dtype=np.int32), self.device),
            to_device(np.asarray(servers, dtype=np.int32), self.device),
        )

    def set_bit(self, v: int, s: int, value: bool) -> None:
        """Set or clear one membership bit with a single in-place op.

        The serial prune toggles one replica per candidate; the 32-round
        scatter would cost 32 rounds of launches for one cell.  Leaves the
        sacrificial row untouched.
        """
        cell = self.words[v, s // 32]
        if value:
            cell |= bit_value(s % 32)
        else:
            cell &= ~bit_value(s % 32)

    def unpack(self) -> np.ndarray:
        """Host copy of the full bool mask: unpacked on the device, then one
        readback.  The array is the caller's to write."""
        n, S = self.n_objects, self.n_servers
        PACK.mask_bytes_unpacked += n * S
        PACK.mask_bytes_on_device += n * S
        return to_host(unpack_mask_bits(self.words[:n], S))

    def storage_per_server(self, f: np.ndarray | None = None) -> np.ndarray:
        n = self.n_objects
        fv = np.ones((n,), np.float32) if f is None else np.asarray(f, np.float32)
        load = storage_per_server(self.words, to_device(fv, self.device))
        return to_host(load)[: self.n_servers].astype(np.float64)

    def replica_count(self) -> int:
        return int(popcount(self.words)) - self.n_objects


__all__ = [
    "PACK",
    "PackStats",
    "PackedScheme",
    "bit_value",
    "n_words",
    "pack_bool_mask",
    "pack_mask_bits",
    "popcount",
    "scatter_clear_pairs",
    "scatter_or_pairs",
    "storage_per_server",
    "test_bits",
    "unpack_bits",
    "unpack_mask_bits",
    "unpack_words",
]
