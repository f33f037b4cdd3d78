"""Cross-process ring attention: the sequence ring spans PROCESSES over the
tpunet transport.

The port of ``tpunet/parallel/dcn_ring_attention.py``. The sequence is
sharded across processes; each keeps its q shard and the k/v blocks rotate
through the process ring by ``interop.dcn_neighbor_exchange`` (CUDA tensors
staged through pinned host memory), while the online-softmax recurrence of
``ring_attention._block_update`` folds in one block per step. The schedule
is the JAX package's: a causal future block is skipped (the exchange still
happens: the ring is collective) and only the diagonal block is masked;
the zigzag schedule computes three chunk pairs a step and never
a_lo x b_hi. Eager PyTorch orders the exchanges by program order on every
rank; each rotation is ONE exchange of k and v packed together, as in JAX.

These are inference paths: the exchange has no gradient, in JAX as here
(``interop``). Both read the process's rank and world from
``tpunet_torch.distributed``, which must be initialized.
"""

from __future__ import annotations

import math

import torch

from tpunet_torch import distributed, interop
from tpunet_torch.parallel.ring_attention import NEG_INF, _block_update


def _exchange_packed(kc, vc):
    """Ring-shift k and v in ONE neighbor exchange, concatenated on the
    last axis in their promoted dtype (lossless): one collective per
    rotation keeps the ranks' call sequences aligned."""
    dk = kc.shape[-1]
    wide = torch.promote_types(kc.dtype, vc.dtype)
    packed = interop.dcn_neighbor_exchange(
        torch.cat([kc.to(wide), vc.to(wide)], dim=-1))
    return packed[..., :dk].to(kc.dtype), packed[..., dk:].to(vc.dtype)


def _init_state(q, v):
    return (q.new_zeros(q.shape[:3] + (v.shape[-1],), dtype=torch.float32),
            q.new_full(q.shape[:3] + (1,), NEG_INF, dtype=torch.float32),
            q.new_zeros(q.shape[:3] + (1,), dtype=torch.float32))


def dcn_ring_attention(q, k, v, causal: bool = False):
    """Ring attention across processes. q/k/v: this process's sequence
    shard (batch, s_local, heads, head_dim); every process holds an
    equal-length shard, in rank order. Returns this shard's output, in
    q's dtype."""
    w = distributed.world_size()
    my = distributed.rank()
    s_local = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    acc, m, l = _init_state(q, v)
    kc, vc = k, v
    # Step t folds in the block that started at rank (my - t) mod w;
    # blocks travel rank -> rank + 1.
    for t in range(w):
        src = (my - t) % w
        if not (causal and src > my):  # a future block is fully masked
            # Strictly past blocks are unmasked; only the diagonal masks.
            acc, m, l = _block_update(
                q, kc, vc, acc, m, l, q_start=my * s_local,
                k_start=src * s_local, causal=causal and src == my,
                scale=scale)
        if t + 1 < w:
            kc, vc = _exchange_packed(kc, vc)
    return (acc / l).to(q.dtype)


def dcn_zigzag_attention(q, k, v):
    """Causal ZIGZAG attention across processes, the balanced sibling of
    `dcn_ring_attention`. Each process holds chunks (rank, 2W-1-rank) of a
    `to_zigzag`-permuted global sequence, so every process does about the
    same causal work a ring step. Causal only.

    q/k/v: (batch, 2c, heads, head_dim), this process's zigzag chunk pair.
    Rotary positions: `zigzag_positions(world, world*2c, rank)`."""
    w = distributed.world_size()
    my = distributed.rank()
    if q.shape[1] % 2:
        raise ValueError("zigzag shard length must be even (a chunk pair)")
    c = q.shape[1] // 2
    scale = 1.0 / math.sqrt(q.shape[-1])
    q_lo, q_hi = q[:, :c], q[:, c:]
    st_lo, st_hi = _init_state(q_lo, v), _init_state(q_hi, v)
    kc, vc = k, v
    for t in range(w):
        src = (my - t) % w  # holder of chunks (src, 2w-1-src) this step
        k_lo, v_lo = kc[:, :c], vc[:, :c]
        k_hi, v_hi = kc[:, c:], vc[:, c:]
        # a_hi x b_lo: always a full unmasked block (b_lo < W <= a_hi).
        st_hi = _block_update(q_hi, k_lo, v_lo, *st_hi, 0, 0, causal=False,
                              scale=scale)
        # a_lo x b_lo: full iff src < my, diagonal iff equal, else nothing.
        if src <= my:
            st_lo = _block_update(q_lo, k_lo, v_lo, *st_lo, 0, 0,
                                  causal=src == my, scale=scale)
        # a_hi x b_hi: the chunk order reverses, full iff src > my.
        if src >= my:
            st_hi = _block_update(q_hi, k_hi, v_hi, *st_hi, 0, 0,
                                  causal=src == my, scale=scale)
        # (a_lo x b_hi never computes: b_hi >= W > a_lo.)
        if t + 1 < w:
            kc, vc = _exchange_packed(kc, vc)
    out = torch.cat([st_lo[0] / st_lo[2], st_hi[0] / st_hi[2]], dim=1)
    return out.to(q.dtype)
