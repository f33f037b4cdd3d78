"""The zigzag (striped) layout of load-balanced causal context parallelism.

Contiguous shards are causally imbalanced: rank i's queries attend only
i + 1 of the W k/v shards, so the last rank computes a full block every
ring step. The zigzag layout splits the sequence into 2W chunks and gives
rank i the PAIR (i, 2W-1-i), one early and one late chunk, so every rank
does about the same causal work a step (``dcn_zigzag_attention``).

The port of the mesh-free helpers of ``tpunet/parallel/zigzag_attention.py``
on torch tensors: ``zigzag_chunk_order``, ``to_zigzag``, ``from_zigzag``
and ``zigzag_positions`` (the rotary positions of a rank's pair). The
in-pod ``zigzag_ring_attention`` and ``zigzag_self_attention`` wait for the
port's mesh (ROADMAP A.6b).
"""

from __future__ import annotations

import torch


def zigzag_chunk_order(world: int) -> list[int]:
    """Global chunk order of the zigzag layout: device i holds chunks
    (i, 2W-1-i), laid out as [0, 2W-1, 1, 2W-2, ...]."""
    order: list[int] = []
    for i in range(world):
        order.extend((i, 2 * world - 1 - i))
    return order


def _chunks(x: torch.Tensor, world: int, axis: int):
    seq = x.shape[axis]
    if seq % (2 * world):
        raise ValueError(
            f"seq {seq} must divide into 2*world={2 * world} chunks")
    return x.split(seq // (2 * world), dim=axis)


def to_zigzag(x: torch.Tensor, world: int, axis: int = 1) -> torch.Tensor:
    """Permute a (…, seq, …) tensor from natural to zigzag chunk order, so
    that contiguous sharding hands each rank its zigzag pair."""
    chunks = _chunks(x, world, axis)
    return torch.cat([chunks[c] for c in zigzag_chunk_order(world)],
                     dim=axis)


def from_zigzag(x: torch.Tensor, world: int, axis: int = 1) -> torch.Tensor:
    """Inverse of to_zigzag."""
    order = zigzag_chunk_order(world)
    inverse = [0] * len(order)
    for pos, c in enumerate(order):
        inverse[c] = pos
    chunks = _chunks(x, world, axis)
    return torch.cat([chunks[p] for p in inverse], dim=axis)


def zigzag_positions(world: int, seq: int, device_index) -> torch.Tensor:
    """Global token positions (int32, on the CPU) of rank `device_index`'s
    local shard (length seq // world) under the zigzag layout, for
    position-dependent layers (rotary)."""
    c = seq // (2 * world)
    ar = torch.arange(c, dtype=torch.int32)
    return torch.cat([device_index * c + ar,
                      (2 * world - 1 - device_index) * c + ar])
