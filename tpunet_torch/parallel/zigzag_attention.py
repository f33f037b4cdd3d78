"""The zigzag (striped) layout of load-balanced causal context parallelism.

Contiguous shards are causally imbalanced: rank i's queries attend only
i + 1 of the W k/v shards, so the last rank computes a full block every
ring step. The zigzag layout splits the sequence into 2W chunks and gives
rank i the PAIR (i, 2W-1-i), one early and one late chunk, so every rank
does about the same causal work a step (``dcn_zigzag_attention``).

The port of ``tpunet/parallel/zigzag_attention.py`` on torch tensors: the
helpers ``zigzag_chunk_order``, ``to_zigzag``, ``from_zigzag`` and
``zigzag_positions`` (the rotary positions of a rank's pair), and the
in-pod ``zigzag_ring_attention`` and ``zigzag_self_attention`` over a mesh
axis (on ``ring_attention.ring_blocks``).
"""

from __future__ import annotations

import functools
import math

import torch

from tpunet_torch.parallel.ring_attention import (_block_update, _init_state,
                                                  causal_block_mode,
                                                  ring_blocks,
                                                  switched_block_update)


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


def zigzag_ring_attention(q, k, v, axis_name: str):
    """Per-shard zigzag causal ring attention; call inside ``shard_map``.

    q/k/v: this rank's zigzag shard, (batch, 2c, heads, head_dim), chunks
    i and 2W-1-i of a to_zigzag()-permuted sequence. Returns the local
    shard of the output (same layout). Causal only."""
    from tpunet_torch.parallel.smap import axis_index, axis_size

    w, my = axis_size(axis_name), axis_index(axis_name)
    if q.shape[1] % 2:
        raise ValueError("zigzag shard length must be even (a chunk pair)")
    c = q.shape[1] // 2
    scale = 1.0 / math.sqrt(q.shape[-1])
    q_lo, q_hi = q[:, :c], q[:, c:]
    st_lo, st_hi = _init_state(q_lo, v), _init_state(q_hi, v)
    for t, (kc, vc) in enumerate(ring_blocks(k, v, axis_name)):
        src = (my - t) % w  # holder of chunks (src, 2w-1-src)
        k_lo, v_lo = kc[:, :c], vc[:, :c]
        k_hi, v_hi = kc[:, c:], vc[:, c:]
        # a_hi x b_lo: always a full unmasked block.
        st_hi = _block_update(q_hi, k_lo, v_lo, *st_hi, 0, 0, causal=False,
                              scale=scale)
        # a_lo x b_lo: full iff src < my, diagonal iff equal, else skip.
        st_lo = switched_block_update(q_lo, k_lo, v_lo, st_lo,
                                      causal_block_mode(src, my), scale)
        # a_hi x b_hi: the chunk order reverses, full iff src > my.
        st_hi = switched_block_update(q_hi, k_hi, v_hi, st_hi,
                                      causal_block_mode(my, src), scale)
        # (a_lo x b_hi never computes: b_hi >= W > a_lo.)
    out = torch.cat([st_lo[0] / st_lo[2], st_hi[0] / st_hi[2]], dim=1)
    return out.to(q.dtype)


def zigzag_self_attention(q, k, v, mesh, dp_axis: str | None = "dp",
                          sp_axis: str = "sp", tp_axis: str | None = None):
    """The entry point over a mesh, JAX's signature: q/k/v are THIS RANK'S
    blocks of (batch, seq, heads, head_dim) tensors ALREADY in zigzag
    order (to_zigzag), batch over `dp_axis`, sequence over `sp_axis`,
    optional heads over `tp_axis`: a rank's sequence block is its zigzag
    chunk pair. Returns this rank's block of the output."""
    from tpunet_torch.parallel.mesh import P
    from tpunet_torch.parallel.smap import shard_map

    spec = P(dp_axis, sp_axis, tp_axis, None)
    fn = shard_map(functools.partial(zigzag_ring_attention,
                                     axis_name=sp_axis),
                   mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
    return fn(q, k, v)
