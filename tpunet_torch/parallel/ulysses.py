"""Ulysses sequence parallelism across processes: all-to-all head/sequence
re-sharding.

The port of ``tpunet/parallel/ulysses.py``. Instead of rotating k/v blocks around a ring, two all-to-alls re-shard the
tensors so that each process sees the FULL sequence for a SUBSET of heads:

    (b, S/P, H, d) --all_to_all--> (b, S, H/P, d)   attention   --back-->

Attention itself then needs no communication. Two tiers:

  * in-pod: ``ulysses_attention`` and ``ulysses_self_attention`` over a
    mesh axis, on ``smap.all_to_all`` (differentiable, as XLA's);
  * across processes: ``dcn_ulysses_attention`` on
    ``interop.dcn_all_to_all``, an inference path: the all-to-all has no
    gradient, in JAX as here.

Both stage CUDA tensors through pinned host memory, and q, k and v travel
stacked in ONE all-to-all (JAX's in-pod tier runs three).
"""

from __future__ import annotations

import functools

import torch

from tpunet_torch import distributed, interop
from tpunet_torch.ops.flash_attention import attention_reference


def ulysses_attention(q, k, v, axis_name: str, causal: bool = False):
    """Per-shard Ulysses attention; call inside ``shard_map``.

    q/k/v: this rank's sequence shard (batch, s_local, heads, head_dim),
    the sequence sharded over `axis_name` in ring order, heads divisible
    by the axis size. Returns the local shard of the output, q-shaped."""
    from tpunet_torch.parallel.smap import all_to_all, axis_size

    w = axis_size(axis_name)
    h = q.shape[2]
    if h % w != 0:
        raise ValueError(f"heads {h} not divisible by '{axis_name}' size {w}")
    # seq-sharded -> head-sharded: split the heads across the axis and
    # concatenate the received sequence chunks in axis order (global
    # sequence order, so the causal mask stays plain).
    qkv = all_to_all(torch.stack([q, k, v]), axis_name, split_axis=3,
                     concat_axis=2)
    o = attention_reference(qkv[0], qkv[1], qkv[2], causal)
    # head-sharded -> seq-sharded: the inverse re-shard.
    return all_to_all(o, axis_name, split_axis=1, concat_axis=2)


def ulysses_self_attention(q, k, v, mesh, causal: bool = False,
                           dp_axis: str | None = "dp", sp_axis: str = "sp",
                           tp_axis: str | None = None):
    """The entry point over a mesh (mirror of ``ring_self_attention``):
    q/k/v are THIS RANK'S blocks of (batch, seq, heads, head_dim) tensors,
    batch over `dp_axis`, sequence over `sp_axis`, optionally heads over
    `tp_axis`; returns this rank's block of the output."""
    from tpunet_torch.parallel.mesh import P
    from tpunet_torch.parallel.smap import shard_map

    spec = P(dp_axis, sp_axis, tp_axis, None)
    fn = shard_map(functools.partial(ulysses_attention, axis_name=sp_axis,
                                     causal=causal),
                   mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
    return fn(q, k, v)


def dcn_ulysses_attention(q, k, v, causal: bool = False):
    """Ulysses attention across PROCESSES over the tpunet transport.

    q/k/v: this process's sequence shard (batch, s_local, heads, head_dim)
    in rank order, heads divisible by the world size (k and v with q's
    head count). Rotary positions must already be global. Reads the rank
    and world from ``tpunet_torch.distributed``."""
    w = distributed.world_size()
    if w == 1:
        return attention_reference(q, k, v, causal)
    b, s_local, h, d = q.shape
    if h % w != 0:
        raise ValueError(f"heads {h} not divisible by world size {w}")
    hl = h // w

    # One relay re-shards q, k and v together: blocks (w, 3, b, sl, h/w, d),
    # head group j to rank j.
    qkv = torch.stack([q, k, v], dim=0)
    blocks = qkv.reshape(3, b, s_local, w, hl, d).permute(3, 0, 1, 2, 4, 5)
    blocks = interop.dcn_all_to_all(blocks)
    # Received block j is rank j's sequence chunk of MY head group; ranks
    # hold contiguous chunks in rank order, so they concatenate along seq.
    full = blocks.permute(1, 2, 0, 3, 4, 5).reshape(3, b, w * s_local, hl, d)
    del blocks
    o = attention_reference(full[0], full[1], full[2], causal)
    del full

    # Inverse: split the full sequence into per-rank chunks, all-to-all,
    # and reassemble the heads (block j is my chunk of head group j).
    blocks = interop.dcn_all_to_all(
        o.reshape(b, w, s_local, hl, d).permute(1, 0, 2, 3, 4))
    return blocks.permute(1, 2, 0, 3, 4).reshape(b, s_local, h, d)
