"""The block math of ring attention: one k/v block folded into an
online-softmax state (the flash recurrence, f32).

The port of the pieces of ``tpunet/parallel/ring_attention.py`` that the
cross-process ring (``dcn_ring_attention.py``) shares with the in-pod one:
``NEG_INF``, ``_block_update`` and ``causal_block_mode``, with the same
math on ``torch.einsum`` (the JAX package computes these products outside
any Pallas kernel too). The in-pod ``ring_attention`` and
``ring_self_attention`` over a mesh axis, and ``switched_block_update``,
wait for the port's mesh (ROADMAP A.6b).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _block_update(q, k, v, acc, m, l, q_start, k_start, causal: bool,
                  scale: float):
    """Fold one K/V block into the online-softmax state.

    q: (b, sq, h, d); k/v: (b, sk, h, d); acc: (b, sq, h, d) f32;
    m/l: (b, sq, h, 1) f32. q_start/k_start are the *global* sequence
    offsets of the blocks: under `causal`, query i attends key j iff
    q_start + i >= k_start + j. Returns the new (acc, m, l)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qpos = q_start + torch.arange(sq, device=s.device)[:, None]
        kpos = k_start + torch.arange(sk, device=s.device)[None, :]
        s = s.masked_fill(qpos < kpos, NEG_INF)
    # (b, h, q, k) -> row stats over k; keep (b, q, h, 1) layout for acc.
    m_blk = s.amax(-1).transpose(1, 2)[..., None]
    m_new = torch.maximum(m, m_blk)
    p = torch.exp(s - m_new.squeeze(-1).transpose(1, 2)[..., None])
    del s
    alpha = torch.exp(m - m_new)
    l_new = alpha * l + p.sum(-1).transpose(1, 2)[..., None]
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return acc * alpha + pv, m_new, l_new


def causal_block_mode(k_chunk, q_chunk):
    """0 = full (strictly past), 1 = diagonal (same chunk), 2 = skip
    (future), comparing chunk or block indices (ints or tensors)."""
    k, q = torch.as_tensor(k_chunk), torch.as_tensor(q_chunk)
    return torch.where(k < q, 0, torch.where(k == q, 1, 2))
