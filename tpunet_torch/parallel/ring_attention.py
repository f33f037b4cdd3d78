"""The block math of ring attention: one k/v block folded into an
online-softmax state (the flash recurrence, f32).

The port of ``tpunet/parallel/ring_attention.py``: ``NEG_INF``,
``_block_update``, ``causal_block_mode`` and ``switched_block_update``,
with the same math on ``torch.einsum`` (the JAX package computes these
products outside any Pallas kernel too), shared with the cross-process
ring (``dcn_ring_attention.py``); and the in-pod ``ring_attention`` and
``ring_self_attention`` over a mesh axis (``mesh.py``, ``smap.py``).

The in-pod ring gathers the ring's k/v blocks by w - 1 neighbor exchanges
in one differentiable step (``ring_blocks``) before folding them in:
JAX's scan overlaps each exchange with a block's products, but its
autodiff keeps every block as well, and a host-staged exchange overlaps
nothing. Its backward returns each block's gradient to its home in w - 1
exchanges.
"""

from __future__ import annotations

import functools
import math

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


def switched_block_update(q, k, v, state, mode, scale: float):
    """Fold one K/V block into the online-softmax `state` under a causal
    block schedule: `mode` (``causal_block_mode``) selects a full unmasked
    update (0), a same-chunk diagonal update (1: the offsets cancel) or a
    skip (2) whose products never run. Shared by the contiguous and zigzag
    ring schedules."""
    mode = int(mode)
    if mode == 2:
        return state
    return _block_update(q, k, v, *state, 0, 0, causal=mode == 1,
                         scale=scale)


def _pack(k, v):
    wide = torch.promote_types(k.dtype, v.dtype)
    return torch.cat([k.to(wide), v.to(wide)], dim=-1).contiguous()


class _RingBlocks(torch.autograd.Function):
    """Every k/v block of the ring's ranks on each rank, block t from axis
    index (my - t) mod w: w - 1 neighbor exchanges of k and v packed (the
    blocks JAX's ring scan carries, all kept as its autodiff keeps them).
    Backward: w - 1 exchanges in the same direction, the gradient of each
    rank's block summed as it travels home (each rank adds the block
    gradients whose home is the sum's next stop)."""

    @staticmethod
    def forward(ctx, k, v, mesh, axes):
        from tpunet_torch.parallel.smap import _permute

        w = mesh.axis_size(axes)
        ring = [(i + 1) % w for i in range(w)]
        ctx.args = (mesh, axes, ring, k.shape[-1], k.dtype, v.dtype)
        out = [k.view_as(k), v.view_as(v)]
        cur = _pack(k, v) if w > 1 else None
        for _ in range(1, w):
            cur = _permute(cur, mesh, axes, ring)
            out += [cur[..., :k.shape[-1]].to(k.dtype).contiguous(),
                    cur[..., k.shape[-1]:].to(v.dtype).contiguous()]
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        from tpunet_torch.parallel.smap import _permute

        mesh, axes, ring, dk, kdt, vdt = ctx.args
        w = len(ring)
        g = [_pack(grads[2 * t], grads[2 * t + 1]) for t in range(w)]
        total = g[0]
        if w > 1:
            buf = g[1]
            for j in range(1, w):
                buf = _permute(buf, mesh, axes, ring)
                if j + 1 < w:
                    buf = buf + g[j + 1]
            total = total + buf
        return total[..., :dk].to(kdt), total[..., dk:].to(vdt), None, None


def ring_blocks(k, v, axis_name, mesh=None) -> list:
    """[(k_t, v_t)] for t in range(w): the k/v block of axis index
    (my - t) mod w of `axis_name`, differentiable (``_RingBlocks``)."""
    from tpunet_torch.parallel.smap import _recorded, _resolve, _taped

    mesh, axes = _resolve(axis_name, mesh)
    out = _RingBlocks.apply(_recorded(k), _recorded(v), mesh, axes)
    out = [_taped(t) for t in out]
    return [(out[2 * t], out[2 * t + 1]) for t in range(len(out) // 2)]


def _init_state(q, v):
    return (q.new_zeros(q.shape[:3] + (v.shape[-1],), dtype=torch.float32),
            q.new_full(q.shape[:3] + (1,), NEG_INF, dtype=torch.float32),
            q.new_zeros(q.shape[:3] + (1,), dtype=torch.float32))


def ring_attention(q, k, v, axis_name: str, causal: bool = False):
    """Per-shard ring attention; call inside ``shard_map`` (or a ``with
    mesh:`` block).

    q/k/v: this rank's sequence shard, (batch, s_local, heads, head_dim),
    the sequence sharded over `axis_name` in ring order. Returns the local
    shard of the attention output, q-shaped. A causal block entirely in
    this rank's future is skipped (its products never run); only the
    diagonal block is masked."""
    from tpunet_torch.parallel.smap import axis_index, axis_size

    w, my = axis_size(axis_name), axis_index(axis_name)
    scale = 1.0 / math.sqrt(q.shape[-1])
    state = _init_state(q, v)
    for t, (kc, vc) in enumerate(ring_blocks(k, v, axis_name)):
        src = (my - t) % w  # whose block this is
        if causal:
            state = switched_block_update(q, kc, vc, state,
                                          causal_block_mode(src, my), scale)
        else:
            state = _block_update(q, kc, vc, *state, 0, 0, causal=False,
                                  scale=scale)
    acc, _, l = state
    return (acc / l).to(q.dtype)


def ring_self_attention(q, k, v, mesh, causal: bool = False,
                        dp_axis: str | None = "dp", sp_axis: str = "sp",
                        tp_axis: str | None = None):
    """The entry point over a mesh, JAX's signature: q/k/v are THIS RANK'S
    blocks of (batch, seq, heads, head_dim) global tensors, batch over
    `dp_axis`, sequence over `sp_axis` and (optionally) heads over
    `tp_axis` (``smap.shard(x, mesh, P(dp_axis, sp_axis, tp_axis))``);
    returns this rank's block of the output."""
    from tpunet_torch.parallel.mesh import P
    from tpunet_torch.parallel.smap import shard_map

    spec = P(dp_axis, sp_axis, tp_axis, None)
    fn = shard_map(functools.partial(ring_attention, axis_name=sp_axis,
                                     causal=causal),
                   mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
    return fn(q, k, v)
