"""Transformer (GPT-style decoder) in PyTorch, the port of the flax model.

Same architecture, parameter names and numerics as
``tpunet/models/transformer.py``: pre-norm blocks, RMSNorm computed in f32
with an f32 scale, rotary position embeddings computed in f32, no biases,
GQA (n_kv_heads < n_heads), tanh-approximated gelu or swiglu MLP, f32
logits. Module names mirror the flax tree (``block{i}.attn.q``,
``block{i}.norm1``, ``norm_f``, ``lm_head``, ``embed``) so the converter in
``convert.py`` is a rename plus a transpose.

Parameters are stored as the caller gives them; every dense layer casts its
weight and input to ``compute_dtype`` at use, so weights pre-cast once to
``compute_dtype`` give bitwise the same result without the per-call cast.
The norm scales must stay f32 (the flax RMSNorm multiplies in f32).

Training: ``forward(tokens, train=False, features_only=False)`` keeps the
flax signature (the family has no dropout, so ``train`` changes nothing).
``remat=True`` runs each block under ``torch.utils.checkpoint``
(non-reentrant): its activations are dropped in the forward and recomputed
in the backward, flax ``nn.remat(Block)`` with ``remat_policy=None``.
``bind(params, trainable=True)`` gives a module whose parameters ARE the
given ``nn.Parameter`` tensors (f32 master weights; dense layers cast them
to ``compute_dtype`` at use, so their gradients land in f32).

Decoding: ``forward(tokens, cache=...)`` runs the cached step against a
decode cache (see ``generate.init_cache``): a dict keyed
``block{i}/attn/cached_key``, ``.../cached_value`` and ``.../cache_index``.
The step UPDATES THE CACHE DICT IN PLACE (the JAX model returns a new
cache; donation makes that in-place on the device too). A (b,) index is
the per-row cache of continuous batching, a () index the lockstep cache of
``generate``. ``prefill=True`` is the first fill of an empty cache, routed
through the configured attention kernel (flash on the card).

Options of the flax model that belong to later slices of the port (MoE,
int8 weights, LoRA, the sequence-parallel attention impls, the "dots"
remat policies, the ring decode cache) raise NotImplementedError.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpunet_torch import _device
from tpunet_torch.ops.flash_attention import (_repeat_kv, attention_reference,
                                              flash_attention)


def rotary_embed(x, base: float = 10000.0, pos_offset: int = 0,
                 positions=None):
    """Rotary position embedding on x (b, s, h, d). `positions` overrides
    with explicit positions: (s,) shared across the batch, or (b, s) per
    row (the per-row decode cache). Computed in f32, cast back."""
    _, s, _, d = x.shape
    half = d // 2
    freqs = torch.exp(-math.log(base) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    if positions is None:
        positions = pos_offset + torch.arange(s, dtype=torch.float32,
                                              device=x.device)
    angles = positions.float()[..., :, None] * freqs
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        x32 = x.float()
        norm = x32 * torch.rsqrt(
            torch.mean(x32 * x32, dim=-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(x.dtype)


class Dense(nn.Module):
    """Bias-free dense layer, flax ``nn.Dense(use_bias=False, dtype=dt)``:
    weight stored (out, in) like ``nn.Linear``; input and weight cast to
    the compute dtype at use."""

    def __init__(self, in_features: int, features: int, dtype, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_features, device=device))

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt))


def _dense(in_features, features, dtype, device=None):
    """The dense factory every matmul goes through: the fp layer in this
    slice (QuantDense and LoraDense come with the model options slice)."""
    return Dense(in_features, features, dtype, device=device)


def _causal_kernel_attention(q, k, v, attn_impl, window):
    """The flash/reference causal-attention pair on rotary'd (b, s, heads,
    dh) tensors, shared by the ordinary forward and the kernel-routed
    prefill: flash reads the kv-head tensors natively, the reference gets
    a group repeat (a no-op when k/v already carry full heads)."""
    if attn_impl == "flash":
        return flash_attention(q, k, v, True, window=window)
    group = q.shape[2] // k.shape[2]
    return attention_reference(q, _repeat_kv(k, group), _repeat_kv(v, group),
                               True, window=window)


class SelfAttention(nn.Module):
    def __init__(self, d_model, n_heads, head_dim, compute_dtype, attn_impl,
                 n_kv_heads, attn_window, device=None):
        super().__init__()
        kv = n_kv_heads or n_heads
        if n_heads % kv:
            raise ValueError(
                f"n_heads {n_heads} not divisible by n_kv_heads {kv}")
        self.n_heads, self.n_kv_heads, self.head_dim = n_heads, kv, head_dim
        self.compute_dtype = compute_dtype
        self.attn_impl = attn_impl
        self.attn_window = attn_window
        dt = compute_dtype
        self.q = _dense(d_model, n_heads * head_dim, dt, device=device)
        self.k = _dense(d_model, kv * head_dim, dt, device=device)
        self.v = _dense(d_model, kv * head_dim, dt, device=device)
        self.out = _dense(n_heads * head_dim, d_model, dt, device=device)

    def forward(self, x, cache=None, prefill=False, prefix=""):
        b, s, _ = x.shape
        h, kv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        q = self.q(x).reshape(b, s, h, dh)
        k = self.k(x).reshape(b, s, kv, dh)
        v = self.v(x).reshape(b, s, kv, dh)
        if cache is not None:
            o = self._cached(q, k, v, cache, prefill, prefix)
        else:
            q, k = rotary_embed(q), rotary_embed(k)
            o = _causal_kernel_attention(q, k, v, self.attn_impl,
                                         self.attn_window)
        return self.out(o.reshape(b, s, h * dh))

    def _cached(self, q, k, v, cache, prefill, prefix):
        """The decode-cache step (flax SelfAttention's decode branch,
        full-capacity cache). Writes this step's K/V into the cache dict in
        place and advances its index."""
        b, s, h, dh = q.shape
        kv = self.n_kv_heads
        dt = self.compute_dtype
        ckey = cache[prefix + "cached_key"]
        cval = cache[prefix + "cached_value"]
        idx = cache[prefix + "cache_index"]
        cap = ckey.shape[1]
        per_row = idx.dim() == 1
        dev = q.device
        steps = torch.arange(s, device=dev)
        pos = idx[..., None] + steps                 # (b, s) or (s,)
        q = rotary_embed(q, positions=pos.float())
        k = rotary_embed(k, positions=pos.float())
        overflow = idx + s > cap                     # poisons the row to NaN
        rows = torch.arange(b, device=dev)
        if per_row:
            # Per-row scatter at idx + arange(s), positions >= cap DROPPED
            # (the JAX scatter's out-of-bounds mode) without a host sync:
            # out-of-range writes are clamped onto slot cap-1 and carry the
            # value that slot ends up with anyway, so no two writes to one
            # slot disagree.
            valid = pos < cap
            wpos = pos.clamp(max=cap - 1)
            last = (cap - 1 - idx).clamp(0, s - 1)
            has_last = (idx <= cap - 1)[:, None, None]
            for buf, new in ((ckey, k), (cval, v)):
                fill = torch.where(has_last, new[rows, last],
                                   buf[rows, cap - 1])
                buf[rows[:, None], wpos] = torch.where(
                    valid[..., None, None], new, fill[:, None])
        else:
            # Lockstep cache: dynamic_update_slice, whose start clamps so the
            # block fits.
            wpos = (idx.clamp(0, cap - s) + steps).expand(b, s)
            ckey[rows[:, None], wpos] = k
            cval[rows[:, None], wpos] = v
        cache[prefix + "cache_index"] = idx + s
        if prefill:
            # First fill of an empty cache: plain causal self-attention over
            # the block, through the configured kernel. Valid only at
            # idx == 0; any other row is poisoned, like an overflow.
            o = _causal_kernel_attention(q, k, v, self.attn_impl,
                                         self.attn_window)
            bad = overflow | (idx != 0)
            if per_row:
                bad = bad[:, None, None, None]
            return o.masked_fill(bad, float("nan")).to(dt)
        # Grouped einsum: q as (b, s, kv, group, dh) against the (b, cap, kv,
        # dh) cache; the group-repeated K/V never exists.
        qg = q.reshape(b, s, kv, h // kv, dh).float()
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                              ckey.float()) / math.sqrt(dh)
        kp = torch.arange(cap, device=dev)[None, None, None, None, :]
        if per_row:
            q_pos = pos[:, None, None, :, None]
            row_overflow = overflow[:, None, None, None]
        else:
            q_pos = pos[None, None, None, :, None]
            row_overflow = overflow
        keep = kp <= q_pos
        if self.attn_window is not None:
            keep &= (q_pos - kp) < self.attn_window
        scores = scores.masked_fill(~keep, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", probs,
                         cval.float()).reshape(b, s, h, dh)
        return o.masked_fill(row_overflow, float("nan")).to(dt)


class Mlp(nn.Module):
    """"gelu" (up -> tanh-approximated gelu -> down, flax ``nn.gelu``) or
    "swiglu" (silu(gate) * up -> down)."""

    def __init__(self, d_model, d_ff, compute_dtype, mlp_impl, device=None):
        super().__init__()
        if mlp_impl not in ("gelu", "swiglu"):
            raise ValueError(f"unknown mlp_impl {mlp_impl!r}")
        self.mlp_impl = mlp_impl
        dt = compute_dtype
        if mlp_impl == "swiglu":
            self.gate = _dense(d_model, d_ff, dt, device=device)
        self.up = _dense(d_model, d_ff, dt, device=device)
        self.down = _dense(d_ff, d_model, dt, device=device)

    def forward(self, x):
        if self.mlp_impl == "swiglu":
            h = F.silu(self.gate(x)) * self.up(x)
        else:
            h = F.gelu(self.up(x), approximate="tanh")
        return self.down(h)


class Block(nn.Module):
    def __init__(self, d_model, n_heads, head_dim, d_ff, compute_dtype,
                 attn_impl, n_kv_heads, mlp_impl, attn_window, device=None):
        super().__init__()
        self.norm1 = RMSNorm(d_model, device=device)
        self.attn = SelfAttention(d_model, n_heads, head_dim, compute_dtype,
                                  attn_impl, n_kv_heads, attn_window,
                                  device=device)
        self.norm2 = RMSNorm(d_model, device=device)
        self.mlp = Mlp(d_model, d_ff, compute_dtype, mlp_impl, device=device)

    def forward(self, x, cache=None, prefill=False, prefix=""):
        x = x + self.attn(self.norm1(x), cache, prefill, prefix + "attn/")
        return x + self.mlp(self.norm2(x))


# Options of the flax model queued for later slices (ROADMAP.md queue A):
# name -> (the only value this slice takes, the slice that brings it).
_LATER = {
    "n_experts": (0, "MoE (model options slice)"),
    "weight_quant": (None, "int8 weight quantization (model options slice)"),
    "lora_rank": (0, "LoRA (model options slice)"),
    "remat_policy": (None, "the remat_policy option (training leftovers, "
                           "ROADMAP A.1)"),
    "mesh": (None, "mesh-sharded attention (sequence-parallel slice)"),
}


class Transformer(nn.Module):
    """Causal decoder-only LM. Tokens (b, s) int -> logits (b, s, vocab) f32.

    `device=None` builds the parameters on the GPU (raising without one);
    pass "cpu" or "meta" explicitly. A "meta" model holds no weights; the
    entry points take the weights as a parameter dict and run a `bind`
    copy of the architecture that holds them."""

    def __init__(self, vocab: int = 32000, d_model: int = 512,
                 n_layers: int = 4, n_heads: int = 8, d_ff: int = 2048,
                 compute_dtype=torch.bfloat16, attn_impl: str = "reference",
                 n_kv_heads: int | None = None, mlp_impl: str = "gelu",
                 attn_window: int | None = None, flash_block_q: int = 128,
                 flash_block_k: int = 128, decode_ring_cache: bool = True,
                 remat: bool = False, device=None, **later):
        super().__init__()
        self._kwargs = dict(
            vocab=vocab, d_model=d_model, n_layers=n_layers, n_heads=n_heads,
            d_ff=d_ff, compute_dtype=compute_dtype, attn_impl=attn_impl,
            n_kv_heads=n_kv_heads, mlp_impl=mlp_impl, attn_window=attn_window,
            flash_block_q=flash_block_q, flash_block_k=flash_block_k,
            decode_ring_cache=decode_ring_cache, remat=remat)
        policy = later.get("remat_policy")
        if policy not in (None, "dots", "dots_no_batch"):
            # Validated even when remat is off, like the flax model.
            raise ValueError(f"unknown remat_policy {policy!r}")
        for name, value in later.items():
            if name not in _LATER:
                raise TypeError(f"unknown Transformer option {name!r}")
            default, what = _LATER[name]
            if value != default:
                raise NotImplementedError(
                    f"{what} ({name}={value!r}) is a later slice of the port")
        if attn_impl not in ("reference", "flash"):
            raise NotImplementedError(
                f"attn_impl={attn_impl!r}: the sequence-parallel attention "
                "impls are a later slice of the port (sequence-parallel "
                "slice)")
        device = _device.resolve(device)
        self.vocab, self.d_model, self.n_layers = vocab, d_model, n_layers
        self.n_heads, self.d_ff = n_heads, d_ff
        self.n_kv_heads = n_kv_heads
        self.compute_dtype = compute_dtype
        self.attn_impl, self.mlp_impl = attn_impl, mlp_impl
        self.attn_window = attn_window
        # Kept for config parity; the CUDA kernel picks its own tiles.
        self.flash_block_q, self.flash_block_k = flash_block_q, flash_block_k
        self.decode_ring_cache = decode_ring_cache
        self.remat = remat
        self.n_experts = 0
        head_dim = d_model // n_heads
        self.embed = nn.Parameter(torch.empty(vocab, d_model, device=device))
        for i in range(n_layers):
            self.add_module(f"block{i}", Block(
                d_model, n_heads, head_dim, d_ff, compute_dtype, attn_impl,
                n_kv_heads, mlp_impl, attn_window, device=device))
        self.norm_f = RMSNorm(d_model, device=device)
        self.lm_head = _dense(d_model, vocab, compute_dtype, device=device)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def config(self) -> dict:
        """The architecture fields (what the serving tiers must agree on)."""
        return {
            "vocab": self.vocab, "d_model": self.d_model,
            "n_layers": self.n_layers, "n_heads": self.n_heads,
            "n_kv_heads": self.n_kv_heads or self.n_heads,
            "d_ff": self.d_ff, "mlp_impl": self.mlp_impl,
            "compute_dtype": str(self.compute_dtype).replace("torch.", ""),
            "attn_window": self.attn_window,
        }

    def forward(self, tokens, train: bool = False,
                features_only: bool = False, *, cache=None,
                prefill: bool = False):
        del train  # no dropout in this family; kept for the trainer
        dt = self.compute_dtype
        x = F.embedding(tokens, self.embed).to(dt)
        for i in range(self.n_layers):
            block = getattr(self, f"block{i}")
            if self.remat and cache is None and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x, cache, prefill, f"block{i}/")
        x = self.norm_f(x)
        if features_only:
            return x.to(dt)
        return self.lm_head(x).float()


    def bind(self, params: dict, trainable: bool = False) -> "Transformer":
        """A copy of this architecture whose parameters ARE the tensors of
        `params` (a state_dict, e.g. from ``convert.from_flax`` or
        ``init_params``; nothing is copied). Each engine runs its own bound
        copy, so threads never share a module whose weights are swapped.

        trainable=False freezes the copy (inference). trainable=True takes
        `params` as ``nn.Parameter`` tensors (the trainer's f32 master
        weights) and leaves them requiring grad, so gradients land on the
        very tensors the optimizer updates."""
        net = Transformer(**self._kwargs, device="meta")
        if trainable:
            plain = [k for k, t in params.items()
                     if not isinstance(t, nn.Parameter)]
            if plain:
                raise TypeError(f"bind(trainable=True) takes nn.Parameter "
                                f"tensors; {plain[:3]} are not")
            net.load_state_dict(params, strict=True, assign=True)
            return net.requires_grad_(True)
        net.load_state_dict(params, strict=True, assign=True)
        return net.requires_grad_(False)


def init_params(model: Transformer, *, seed: int, device=None,
                dtype=None) -> dict:
    """Random parameters at the flax initialisers' scales, drawn from a
    torch.Generator seeded with `seed`: embed ~ normal(0.02), dense kernels
    lecun-normal (truncated normal, std sqrt(1/fan_in)/0.8796), norm scales
    ones. `dtype` pre-casts the dense kernels and the embedding (the norm
    scales stay f32)."""
    dev = _device.resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for name, p in model.named_parameters():
        if name.endswith(".scale"):
            out[name] = torch.ones(p.shape, device=dev)
            continue
        t = torch.empty(p.shape, device=dev)
        if name == "embed":
            t.normal_(0.0, 0.02, generator=gen)
        else:
            std = math.sqrt(1.0 / p.shape[1]) / 0.87962566103423978
            nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
        out[name] = t.to(dtype) if dtype is not None else t
    return out
