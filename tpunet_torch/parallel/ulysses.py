"""Ulysses sequence parallelism across processes: all-to-all head/sequence
re-sharding.

The port of ``dcn_ulysses_attention`` from ``tpunet/parallel/ulysses.py``.
Instead of rotating k/v blocks around a ring, two all-to-alls re-shard the
tensors so that each process sees the FULL sequence for a SUBSET of heads:

    (b, S/P, H, d) --all_to_all--> (b, S, H/P, d)   attention   --back-->

Attention itself then needs no communication. The all-to-alls are
``interop.dcn_all_to_all`` (CUDA tensors staged through pinned host
memory); q, k and v travel stacked in ONE of them. An inference path: the
all-to-all has no gradient, in JAX as here. The in-pod
``ulysses_attention`` and ``ulysses_self_attention`` over a mesh axis wait
for the port's mesh (ROADMAP A.6b).
"""

from __future__ import annotations

import torch

from tpunet_torch import distributed, interop
from tpunet_torch.ops.flash_attention import attention_reference


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
