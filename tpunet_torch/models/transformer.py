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

Training: ``forward(tokens, train=False, features_only=False, *,
rng=None)`` keeps the flax signature (the family has no dropout, so
``train`` and the dropout seed ``rng`` change nothing; ``VGG`` takes the
same two).
``remat=True`` runs each block under ``torch.utils.checkpoint``
(non-reentrant): its activations are dropped in the forward and recomputed
in the backward, flax ``nn.remat(Block)`` with ``remat_policy=None``.
``remat_policy`` selects what a block keeps instead (a selective
checkpoint policy, seen at the dispatch level, where a dense layer is
``aten.mm``): "dots" saves the outputs of every matrix product
(``aten.mm``, ``addmm``, ``bmm``, ``baddbmm``; jax's ``dots_saveable``),
"dots_no_batch" only those without batch dims (``aten.mm``, ``addmm``;
``dots_with_no_batch_dims_saveable``: the dense layers, not the reference
attention's batched einsums). Everything else is recomputed, the flash
kernels too, as JAX's policies save only ``dot_general`` outputs.
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

With ``attn_window`` and ``decode_ring_cache=True`` (the default) the decode
cache is a rolling ring: leaves sized min(window, capacity), a step writes
its last min(s, capacity) positions at position mod capacity, and attends
over the pre-write ring plus its own k/v (flax's ring branch, the same
rules). ``weight_quant="int8"`` makes every dense layer a ``QuantDense``
(int8 weight and f32 per-output-channel scale, from
``quant.quantize_params``); it is an inference path.

``n_experts`` > 0 makes every ``moe_every``-th block's MLP a ``MoeMlp``
(block i when (i + 1) % moe_every == 0) with ``moe_top_k`` choices a token
and ``capacity_factor``; the trainer adds the blocks' load-balancing loss
(``forward(..., moe_aux=[])`` hands it out). ``lora_rank`` > 0 makes every
dense layer (q, k, v, out, gate, up, down, lm_head) a ``LoraDense``, over
an int8 base too (QLoRA); ``models.lora`` holds the workflow around it.

Sequence parallelism across processes: ``attn_impl`` "dcn_ring",
"dcn_zigzag" or "dcn_ulysses" runs each process's model on its sequence
shard (contiguous, or the zigzag chunk pair of ``parallel.to_zigzag``)
with rotary at the shard's global positions, k/v repeated to the q heads
after rotary, and attention through ``tpunet_torch.parallel`` over the
DCN collectives (``distributed`` initialized). They are inference paths,
as in JAX: the exchange has no gradient, and the decode cache and
``attn_window`` refuse them with the flax model's ValueErrors.

On a mesh (``mesh``, ``dp_axis``, ``sp_axis``, ``tp_axis``; the port's
mesh is a set of ranks, ``tpunet_torch.parallel.mesh``) each rank runs the
model on its own block: its batch rows (over ``dp_axis``) and, with the
in-pod sequence-parallel ``attn_impl`` "ring", "zigzag" or "ulysses", its
sequence shard over ``sp_axis`` (contiguous, or the zigzag chunk pair),
with rotary at the shard's global positions, as the dcn impls do. Tensor
parallelism follows the parameters' blocks, as XLA follows shardings:
``transformer_partition_rules`` and ``parallel.shard_params`` give each
rank its blocks, ``bind`` takes them, and each layer reads its block's
shape. A column-parallel q/k/v or up/gate (output dim sharded) takes its
input through ``pvary`` (one for q, k and v together), a row-parallel out
or down (input dim sharded) ends in ``psum``, the vocab-sharded embedding
masks the ids outside its rows, looks up and sums, and the vocab-sharded
lm_head's logits are gathered (``all_gather``) before the loss. A leaf
left replicated (an axis that does not divide its dim) runs whole, with no
collective. Under TP the attention kernels run on the rank's local heads,
the decode cache holds the rank's kv heads (``local_kv_heads``), and int8
and LoRA layers split as their base (``QuantDense``, ``LoraDense``).
``features_only`` returns the features on every rank of the tp axis. An
MoE layer on a mesh routes the global batch of the data axes and may hold
its experts' block over an ``ep`` axis of the partition rules given to
``local_params`` (``MoeMlp``).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from tpunet_torch import _device, distributed
from tpunet_torch.models import _bind
from tpunet_torch.ops.flash_attention import (_repeat_kv, attention_reference,
                                              flash_attention)
from tpunet_torch.parallel import (dcn_ring_attention, dcn_ulysses_attention,
                                   dcn_zigzag_attention, ring_self_attention,
                                   ulysses_self_attention,
                                   zigzag_positions, zigzag_self_attention)
from tpunet_torch.parallel.mesh import P
from tpunet_torch.parallel.smap import all_gather, psum, psum_scatter, pvary

# The sequence-parallel impls across processes, and over a mesh axis.
DCN_IMPLS = ("dcn_ring", "dcn_zigzag", "dcn_ulysses")
IN_POD_IMPLS = ("ring", "zigzag", "ulysses")
SP_IMPLS = DCN_IMPLS + IN_POD_IMPLS


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


def _kind(tp, shape, full) -> str | None:
    """"column" when this rank holds a block of a dense layer's output dim,
    "row" of its input dim, None when the (out, in) weight is whole."""
    if tp is None:
        return None
    if shape[0] != full[0]:
        return "column"
    if shape[1] != full[1]:
        return "row"
    return None


def _row_sum(layer, y):
    """A row block's partial product summed over the tp axis; any other
    layer's product as it is."""
    if layer.kind() == "row":
        return psum(y, layer.tp[1], mesh=layer.tp[0])
    return y


def _whole(layer, w, kind: str):
    """A whole leaf `w` of a TP layer of `kind` that meets the rank's
    block: through ``pvary``, so that its gradient sums the blocks'
    partials (the cast JAX inserts where a replicated value meets a
    varying one); as it is otherwise."""
    if layer.kind() == kind:
        return pvary(w, layer.tp[1], mesh=layer.tp[0])
    return w


class Dense(nn.Module):
    """Bias-free dense layer, flax ``nn.Dense(use_bias=False, dtype=dt)``:
    weight stored (out, in) like ``nn.Linear``; input and weight cast to
    the compute dtype at use."""

    tp = None  # (mesh, axis) of a model over a mesh with tensor parallelism

    def __init__(self, in_features: int, features: int, dtype, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.full = (features, in_features)
        self.weight = nn.Parameter(
            torch.empty(features, in_features, device=device))

    def kind(self) -> str | None:
        return _kind(self.tp, self.weight.shape, self.full)

    def partial(self, x):
        """This rank's product: the whole one, or a row block's partial."""
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt))

    def forward(self, x):
        """A column block's input is the caller's, cast by it (``pvary``);
        a row block's partial products are summed over the axis."""
        return _row_sum(self, self.partial(x))


def _tp_input(x, layer):
    """x as the input of `layer` (and of the layers split as it is):
    through ``pvary`` when it is a column-parallel block, as it is
    otherwise."""
    if layer.kind() == "column":
        mesh, axis = layer.tp
        return pvary(x, axis, mesh=mesh)
    return x


def _head_layout(n_heads: int, n_kv: int, head_dim: int, q_block: int,
                 index: int) -> tuple:
    """The heads rank `index` of a TP attention computes, from its block of
    `q_block` of q's output columns: its q columns (c0, c1), the q heads
    they touch (h0, h1), and the kv heads those read, one entry a local kv
    head: a run of whole groups, the one head of a part of a group, or
    (heads that cut groups unevenly) one a q head."""
    c0 = index * q_block
    c1 = c0 + q_block
    h0, h1 = c0 // head_dim, -(-c1 // head_dim)
    g = n_heads // n_kv
    if h0 % g == 0 and (h1 - h0) % g == 0:
        kv = list(range(h0 // g, h1 // g))
    elif h0 // g == (h1 - 1) // g:
        kv = [h0 // g]
    else:
        kv = [h // g for h in range(h0, h1)]
    return (c0, c1), (h0, h1), kv


def _tp_columns(layer, y, start: int, stop: int, tp):
    """Columns [start, stop) of the whole output of `layer`, whose output
    on this rank is `y` (its column block, or the whole output), for work
    that differs across the tp axis `tp` = (mesh, axis). A block that holds
    them is sliced; a block that does not is gathered over the axis first
    (``all_gather`` whose backward is a ``psum_scatter``: each rank's
    gradient of the others' columns goes to their owner); a whole output
    goes through ``pvary`` (the ranks' gradients of it are summed)."""
    mesh, axis = tp
    if layer.kind() == "column":
        lo = mesh.axis_index(axis) * y.shape[-1]
        if lo <= start and stop <= lo + y.shape[-1]:
            return y[..., start - lo:stop - lo]
        y = all_gather(y, axis, axis=y.dim() - 1, tiled=True, mesh=mesh,
                       varying=True)
    else:
        y = pvary(y, axis, mesh=mesh)
    return y[..., start:stop]


class QuantDense(nn.Module):
    """Weight-only int8 dense layer, flax ``QuantDense``: weight stored int8
    (out, in) with a per-output-channel f32 scale (w ≈ q · scale). The
    input and q are cast to the compute dtype, multiplied, and the product
    scaled by the scale in the compute dtype, in the flax order. The
    parameters come from ``quant.quantize_params``; a fresh init is a
    zero skeleton. The int8 leaf takes no gradient (it is created with
    requires_grad=False and ``bind`` keeps integer leaves frozen).

    Under TP a column block holds q and scale split by output; a row block
    holds q split by input and the whole scale, which distributes over the
    sum, so the local product is scaled before the psum."""

    tp = None  # as Dense's

    def __init__(self, in_features: int, features: int, dtype, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.full = (features, in_features)
        self.q = nn.Parameter(
            torch.zeros(features, in_features, dtype=torch.int8,
                        device=device), requires_grad=False)
        self.scale = nn.Parameter(torch.ones(features, device=device))

    def kind(self) -> str | None:
        return _kind(self.tp, self.q.shape, self.full)

    def partial(self, x):
        dt = self.compute_dtype
        scale = _whole(self, self.scale, "row")
        return F.linear(x.to(dt), self.q.to(dt)) * scale.to(dt)

    def forward(self, x):
        return _row_sum(self, self.partial(x))


class LoraDense(nn.Module):
    """Dense with a rank-r LoRA adapter, flax ``LoraDense``: y = base(x) +
    ((x · A) · B) · (alpha / r), computed in the compute dtype. The base (a
    ``Dense``, or a ``QuantDense`` under weight_quant="int8": QLoRA) lives
    under ``.base`` with its ordinary leaves; ``lora_a`` (in, r) and
    ``lora_b`` (r, out) are f32 in flax's layout (x · A, not a torch
    weight). B starts at zero, so a freshly adapted model is bitwise the
    base model; ``models.lora`` trains only A and B.

    Under TP it follows its base: column-parallel, A is whole and B split
    by output, and the input's one ``pvary`` (the caller's) serves both;
    row-parallel, A is split by input and B whole, and the adapter's
    partial joins the base's before the layer's one psum (the same sum in
    another order). The whole factor goes through ``pvary`` (its gradient
    is the sum of the blocks' partials: one all-reduce of A or B, in the
    backward only)."""

    def __init__(self, in_features: int, features: int, rank: int, dtype,
                 alpha: float | None = None, quant: bool = False,
                 device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.base = (QuantDense if quant else Dense)(
            in_features, features, dtype, device=device)
        self.lora_a = nn.Parameter(
            torch.empty(in_features, rank, device=device))
        self.lora_b = nn.Parameter(torch.zeros(rank, features, device=device))
        # flax multiplies by the scale as a compute-dtype scalar.
        scale = (alpha if alpha is not None else rank) / rank
        self.scale = float(torch.tensor(scale, dtype=dtype))

    @property
    def tp(self):
        return self.base.tp

    def kind(self) -> str | None:
        return self.base.kind()

    def forward(self, x):
        dt = self.compute_dtype
        a = _whole(self, self.lora_a, "column")
        b = _whole(self, self.lora_b, "row")
        delta = (x.to(dt) @ a.to(dt)) @ b.to(dt)
        return _row_sum(self.base, self.base.partial(x) + delta * self.scale)


def _dense(in_features, features, dtype, device=None, weight_quant=None,
           lora_rank=0, lora_alpha=None):
    """The dense factory every matmul goes through: fp by default,
    QuantDense under weight_quant="int8" (the same module names, so the
    quantized state_dict is the fp one with each ``weight`` swapped for
    ``q`` and ``scale``), and LoraDense when lora_rank > 0 (the base's
    leaves under ``.base``, the adapters beside it)."""
    if lora_rank > 0:
        return LoraDense(in_features, features, lora_rank, dtype,
                         alpha=lora_alpha, quant=weight_quant is not None,
                         device=device)
    if weight_quant is None:
        return Dense(in_features, features, dtype, device=device)
    return QuantDense(in_features, features, dtype, device=device)


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
    # (mesh, dp_axis, sp_axis, tp_axis) of a model over a mesh.
    mesh = None

    def __init__(self, d_model, n_heads, head_dim, compute_dtype, attn_impl,
                 n_kv_heads, attn_window, decode_ring_cache=True,
                 weight_quant=None, lora=(0, None), device=None):
        super().__init__()
        kv = n_kv_heads or n_heads
        if n_heads % kv:
            raise ValueError(
                f"n_heads {n_heads} not divisible by n_kv_heads {kv}")
        self.n_heads, self.n_kv_heads, self.head_dim = n_heads, kv, head_dim
        self.compute_dtype = compute_dtype
        self.attn_impl = attn_impl
        self.attn_window = attn_window
        # The decode cache is a rolling ring (leaves of min(window, cap)).
        self.ring = attn_window is not None and decode_ring_cache
        dt, wq = compute_dtype, weight_quant
        self.q = _dense(d_model, n_heads * head_dim, dt, device, wq, *lora)
        self.k = _dense(d_model, kv * head_dim, dt, device, wq, *lora)
        self.v = _dense(d_model, kv * head_dim, dt, device, wq, *lora)
        self.out = _dense(n_heads * head_dim, d_model, dt, device, wq, *lora)

    def forward(self, x, cache=None, prefill=False, prefix=""):
        b, s, _ = x.shape
        dh = self.head_dim
        if self.attn_window is not None and self.attn_impl in SP_IMPLS:
            raise ValueError(
                f"attn_window is only supported by attn_impl 'reference'/"
                f"'flash', not {self.attn_impl!r}")
        q, k, v, keep = self._heads(x)
        h = q.shape[2]
        if cache is not None:
            if self.attn_impl in SP_IMPLS:
                # The cached step is dense local attention: wrong for a
                # sequence shard whose k/v live on other processes.
                raise ValueError(
                    f"decode=True does not support attn_impl="
                    f"{self.attn_impl!r}; decode on the full sequence with "
                    "attn_impl='reference' (e.g. model.clone("
                    "attn_impl='reference') before generate())")
            o = self._cached(q, k, v, cache, prefill, prefix)
        elif self.attn_impl in SP_IMPLS:
            o = self._sequence_parallel(q, k, v)
        else:
            q, k = rotary_embed(q), rotary_embed(k)
            o = _causal_kernel_attention(q, k, v, self.attn_impl,
                                         self.attn_window)
        return self.out(o.reshape(b, s, h * dh)[..., keep])

    def _heads(self, x):
        """q (b, s, h, dh) and k, v (b, s, kv, dh) of this rank's heads, and
        the attention output's columns its out block reads: all of them,
        or under TP the q heads its block of q's columns touches and the
        kv heads those read (``_head_layout``), wherever the partition
        rules cut k and v: whole heads, part of a head (gathered over the
        tp axis) or not at all."""
        b, s, _ = x.shape
        dh = self.head_dim
        xq = _tp_input(x, self.q)
        q = self.q(xq)
        if self.q.kind() != "column":
            k, v = self.k(x), self.v(x)
            return (q.reshape(b, s, -1, dh), k.reshape(b, s, -1, dh),
                    v.reshape(b, s, -1, dh), slice(None))
        tp = self.q.tp
        (c0, c1), (h0, h1), kvh = _head_layout(
            self.n_heads, self.n_kv_heads, dh, q.shape[-1],
            tp[0].axis_index(tp[1]))
        q = _tp_columns(self.q, q, h0 * dh, h1 * dh, tp)
        g0, g1 = min(kvh), max(kvh) + 1
        out = [q.reshape(b, s, h1 - h0, dh)]
        for layer in (self.k, self.v):
            y = layer(xq if layer.kind() == "column" else x)
            y = _tp_columns(layer, y, g0 * dh, g1 * dh, tp).reshape(
                b, s, g1 - g0, dh)
            if len(kvh) != g1 - g0:   # one kv head a q head
                y = y[:, :, [g - g0 for g in kvh]]
            out.append(y)
        return (*out, slice(c0 - h0 * dh, c1 - h0 * dh))

    def _sequence_parallel(self, q, k, v):
        """Causal attention of this rank's sequence shard, across the
        processes (dcn impls) or over the mesh's sp axis (in-pod impls):
        rotary at the shard's global positions (index * s, or the zigzag
        pair's), k/v repeated to q's heads after rotary."""
        s = q.shape[1]
        impl = self.attn_impl
        if impl in IN_POD_IMPLS:
            mesh, dp_axis, sp_axis, tp_axis = self.mesh
            w, rank = mesh.axis_size(sp_axis), mesh.axis_index(sp_axis)
        else:
            w, rank = distributed.world_size(), distributed.rank()
        if impl in ("dcn_zigzag", "zigzag"):
            pos = zigzag_positions(w, w * s, rank).to(q.device).float()
            q = rotary_embed(q, positions=pos)
            k = rotary_embed(k, positions=pos)
        else:
            q = rotary_embed(q, pos_offset=rank * s)
            k = rotary_embed(k, pos_offset=rank * s)
        group = q.shape[2] // k.shape[2]
        k, v = _repeat_kv(k, group), _repeat_kv(v, group)
        if impl == "dcn_ring":
            return dcn_ring_attention(q, k, v, causal=True)
        if impl == "dcn_zigzag":
            return dcn_zigzag_attention(q, k, v)
        if impl == "dcn_ulysses":
            return dcn_ulysses_attention(q, k, v, causal=True)
        axes = dict(dp_axis=dp_axis, sp_axis=sp_axis, tp_axis=tp_axis)
        if impl == "zigzag":
            return zigzag_self_attention(q, k, v, mesh, **axes)
        fn = ring_self_attention if impl == "ring" else ulysses_self_attention
        return fn(q, k, v, mesh, causal=True, **axes)

    def _cached(self, q, k, v, cache, prefill, prefix):
        """The decode-cache step (flax SelfAttention's decode branch). Writes
        this step's K/V into the cache dict in place and advances its index.
        On the ring the step attends over the PRE-write ring plus its own
        k/v, so attention runs before the write."""
        b, s, h, dh = q.shape
        dt = self.compute_dtype
        ckey = cache[prefix + "cached_key"]
        cval = cache[prefix + "cached_value"]
        idx = cache[prefix + "cache_index"]
        cap = ckey.shape[1]
        per_row = idx.dim() == 1
        # (b, s) per row, (s,) lockstep
        pos = idx[..., None] + torch.arange(s, device=q.device)
        q = rotary_embed(q, positions=pos.float())
        k = rotary_embed(k, positions=pos.float())
        if self.ring and cap >= self.attn_window:
            # A ring at least as wide as the window never overflows: the
            # window addresses only resident positions.
            overflow = torch.zeros_like(idx, dtype=torch.bool)
        else:
            overflow = idx + s > cap                 # poisons the row to NaN
        cache[prefix + "cache_index"] = idx + s
        if prefill:
            # First fill of an empty cache: plain causal self-attention over
            # the block, through the configured kernel. Valid only at
            # idx == 0; any other row is poisoned, like an overflow.
            self._write(ckey, cval, k, v, idx, per_row)
            o = _causal_kernel_attention(q, k, v, self.attn_impl,
                                         self.attn_window)
            bad = overflow | (idx != 0)
            if per_row:
                bad = bad[:, None, None, None]
            return o.masked_fill(bad, float("nan")).to(dt)
        if self.ring:
            # Ring slot j holds the largest position p < idx with
            # p = j (mod cap); p < 0 was never written (or belongs to a
            # recycled serving slot's previous occupant).
            i1 = idx[..., None] - 1
            p_ring = i1 - (i1 - torch.arange(cap, device=q.device)) % cap
            o = self._attend(q, torch.cat([ckey, k], 1),
                             torch.cat([cval, v], 1),
                             torch.cat([p_ring, pos], -1), pos, overflow)
            self._write(ckey, cval, k, v, idx, per_row)
            return o
        self._write(ckey, cval, k, v, idx, per_row)
        return self._attend(q, ckey, cval, torch.arange(cap, device=q.device),
                            pos, overflow)

    def _write(self, ckey, cval, k, v, idx, per_row):
        """This step's K/V into the cache leaves, in place."""
        b, s = k.shape[:2]
        cap = ckey.shape[1]
        dev = k.device
        rows = torch.arange(b, device=dev)
        if self.ring:
            # The step's last min(s, cap) positions, at position mod cap
            # (all distinct).
            m = min(s, cap)
            slot = (idx[..., None] + torch.arange(s - m, s, device=dev)) % cap
            for buf, new in ((ckey, k), (cval, v)):
                if per_row:
                    buf[rows[:, None], slot] = new[:, s - m:]
                else:
                    buf[:, slot] = new[:, s - m:]
            return
        steps = torch.arange(s, device=dev)
        if per_row:
            # Per-row scatter at idx + arange(s), positions >= cap DROPPED
            # (the JAX scatter's out-of-bounds mode) without a host sync:
            # out-of-range writes are clamped onto slot cap-1 and carry the
            # value that slot ends up with anyway, so no two writes to one
            # slot disagree.
            pos = idx[:, None] + steps
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

    def _attend(self, q, att_k, att_v, key_pos, pos, overflow):
        """Masked softmax attention of the step's queries (at positions
        `pos`) over keys at positions `key_pos` ((K,) or (b, K); negative:
        never written), as a grouped einsum: q as (b, s, kv, group, dh)
        against (b, K, kv, dh) keys, so the group-repeated K/V never
        exists."""
        b, s, h, dh = q.shape
        kv = att_k.shape[2]  # this rank's kv heads
        qg = q.reshape(b, s, kv, h // kv, dh).float()
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                              att_k.float()) / math.sqrt(dh)
        kp = (key_pos[:, None, None, None, :] if key_pos.dim() == 2
              else key_pos)
        if pos.dim() == 2:
            q_pos = pos[:, None, None, :, None]
            row_overflow = overflow[:, None, None, None]
        else:
            q_pos = pos[:, None]
            row_overflow = overflow
        keep = (kp >= 0) & (kp <= q_pos)
        if self.attn_window is not None:
            keep &= (q_pos - kp) < self.attn_window
        scores = scores.masked_fill(~keep, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", probs,
                         att_v.float()).reshape(b, s, h, dh)
        return o.masked_fill(row_overflow, float("nan")).to(
            self.compute_dtype)


class Mlp(nn.Module):
    """"gelu" (up -> tanh-approximated gelu -> down, flax ``nn.gelu``) or
    "swiglu" (silu(gate) * up -> down)."""

    def __init__(self, d_model, d_ff, compute_dtype, mlp_impl,
                 weight_quant=None, lora=(0, None), device=None):
        super().__init__()
        if mlp_impl not in ("gelu", "swiglu"):
            raise ValueError(f"unknown mlp_impl {mlp_impl!r}")
        self.mlp_impl = mlp_impl
        dt, wq = compute_dtype, weight_quant
        if mlp_impl == "swiglu":
            self.gate = _dense(d_model, d_ff, dt, device, wq, *lora)
        self.up = _dense(d_model, d_ff, dt, device, wq, *lora)
        self.down = _dense(d_ff, d_model, dt, device, wq, *lora)

    def forward(self, x):
        x = _tp_input(x, self.up)   # gate, where there is one, splits alike
        if self.mlp_impl == "swiglu":
            h = F.silu(self.gate(x)) * self.up(x)
        else:
            h = F.gelu(self.up(x), approximate="tanh")
        return self.down(h)


class MoeMlp(nn.Module):
    """Top-k MoE with capacity-bounded one-hot dispatch, flax ``MoeMlp``
    (top_k=1 is Switch routing, top_k=2 the GShard/Mixtral family).

    ``router`` (d, e), ``wi`` (e, d, f) and ``wo`` (e, f, d) keep flax's
    layout (they are not Dense kernels). The router's logits, softmax and
    top-k run in f32; at k > 1 the gates are renormalised over the chosen
    set. Each call's t = b·s tokens get cap = max(1, ceil(k·t/e ·
    capacity_factor)) slots an expert, granted CHOICE-MAJOR by a cumulative
    count (every token's first choice before any second choice); a choice
    over capacity is dropped, so the residual passes the token. The expert
    FFN is gelu(tanh)(x · wi) · wo in the compute dtype.

    ``forward`` returns (y, aux): aux is the load-balancing loss e ·
    Σ_e(frac_tokens · frac_probs) over the PRIMARY choice (the Switch
    formula at k = 1), an output so that it survives a checkpointed block.
    ``dropped`` holds the last call's share of (token, choice) pairs over
    capacity (a 0-d tensor; for reports).

    Determinism: no scatter, no atomics. flax's (t, k, e, cap) dispatch
    tensor is only ever contracted summed over k, and a token's k choices
    name k distinct experts, so the port builds the two (t, e·cap) sums
    directly, one choice at a time: D (0/1: the dispatch) and C (the
    gate-weighted combine). Each holds one nonzero a (token, choice), so
    they are bitwise flax's k-summed tensors; every contraction is a
    plain matrix product.

    On a mesh (``mesh`` set by the Transformer) the layer is flax's over the
    GLOBAL batch, whose tokens lie on the ranks of the data axes (rows over
    dp, sequence shards over an in-pod sp): t, and so cap, count the global
    tokens; a (token, choice)'s slot is its rank in flax's choice-major
    order over the global (b, s), from an exclusive prefix of the
    per-(choice, row, sequence segment, expert) counts of every rank (one
    psum of the small count tensor, with the aux's sums); aux uses the
    global means, and its gradient counts once a rank of the data group
    (every rank holds the same aux and the trainer means the group's
    gradients). ``rows`` overrides this rank's global rows (the trainer's
    strided microbatches). Experts split over an ``ep`` axis (``ep_axis``,
    from the partition rules) dispatch at the global capacity: where ep is
    a data axis, the local (e, cap, d) buffer is reduce-scattered over ep
    onto the rank's experts (``psum_scatter``; other ranks' slots never
    overlap, so no sum over the other data axes is needed: each holds its
    own tokens' rows) and the experts' outputs all-gathered back before
    the combine; otherwise the rank dispatches to its own experts' columns
    only and the combine's partial is summed over ep. The expert FFN split
    over ``ffn_tp`` (wi's output, wo's input) is column- then row-parallel:
    ``pvary`` in, ``psum`` out."""

    # (mesh, dp_axis, sp_axis, zigzag) of a model over a mesh: the axes its
    # tokens lie on (None where they do not), and the sp shards' layout.
    mesh = None
    ep_axis = ffn_tp = None  # the axes wi's experts and its f dim split over
    rows = None  # (this rank's global row ids, the global row count)

    def __init__(self, d_model, n_experts, d_ff, capacity_factor=1.25,
                 compute_dtype=torch.bfloat16, top_k=1, device=None):
        super().__init__()
        if not 1 <= top_k <= n_experts:
            raise ValueError(f"top_k {top_k} outside [1, n_experts="
                             f"{n_experts}]")
        self.n_experts, self.d_ff = n_experts, d_ff
        self.capacity_factor = capacity_factor
        self.compute_dtype = compute_dtype
        self.top_k = top_k
        e, d, f = n_experts, d_model, d_ff
        self.router = nn.Parameter(torch.empty(d, e, device=device))
        self.wi = nn.Parameter(torch.empty(e, d, f, device=device))
        self.wo = nn.Parameter(torch.empty(e, f, d, device=device))
        self.dropped = None

    def capacity(self, tokens: int) -> int:
        return max(1, int(math.ceil(self.top_k * tokens / self.n_experts
                                    * self.capacity_factor)))

    def data_axes(self) -> tuple:
        if self.mesh is None:
            return ()
        return tuple(a for a in self.mesh[1:3] if a is not None)

    def forward(self, x):
        b, s, d = x.shape
        e, k = self.n_experts, self.top_k
        t = b * s
        xt = x.reshape(t, d)
        probs = torch.softmax(xt.float() @ self.router.float(), dim=-1)
        experts = torch.topk(probs.detach(), k, dim=-1).indices   # (t, k)
        ids = torch.arange(e, device=x.device)
        onehot = (experts[..., None] == ids).float()                # (t, k, e)
        # The gates as products with the one-hots (no gather backward).
        gates = (probs[:, None, :] * onehot).sum(-1)                # (t, k)
        if k > 1:
            gates = gates / gates.sum(-1, keepdim=True)
        if self.data_axes():
            pos, cap, aux = self._global_slots(onehot, probs, b, s)
        else:
            cap = self.capacity(t)
            aux = e * torch.sum(onehot[:, 0, :].mean(0) * probs.mean(0))
            # Slots: a cumulative count over the choice-major (k·t, e)
            # rows, 1-based.
            oh = onehot.transpose(0, 1).to(torch.int32)             # (k, t, e)
            pos = (torch.cumsum(oh.reshape(k * t, e), 0, dtype=torch.int32)
                   .reshape(k, t, e) * oh).sum(-1)                  # (k, t)
            self.dropped = (pos > cap).float().mean().detach()
        # A choice keeps its slot when it is within capacity.
        y = self._dispatch(xt, experts, gates, pos, pos <= cap, cap)
        return y.reshape(b, s, d), aux

    def _global_slots(self, onehot, probs, b, s):
        """(pos (k, t), cap, aux) of this rank's tokens in the global batch
        over the data axes (the class docstring), and ``dropped``."""
        mesh, dp, sp, zigzag = self.mesh
        e, k = self.n_experts, self.top_k
        dev = onehot.device
        if self.rows is not None:
            rows, n_rows = self.rows
            rows = torch.as_tensor(rows, device=dev)
        elif dp is not None:
            n_rows = b * mesh.axis_size(dp)
            rows = mesh.axis_index(dp) * b + torch.arange(b, device=dev)
        else:
            rows, n_rows = torch.arange(b, device=dev), b
        # This rank's sequence segments, in the global position order.
        n_sp = mesh.axis_size(sp) if sp is not None else 1
        i = mesh.axis_index(sp) if sp is not None else 0
        segs = [i, 2 * n_sp - 1 - i] if zigzag else [i]
        n_segs = n_sp * len(segs)
        seg = s // len(segs)
        segs = torch.as_tensor(segs, device=dev)
        tokens = n_rows * n_segs * seg
        cap = self.capacity(tokens)
        oh = onehot.transpose(0, 1).reshape(k, b, len(segs), seg, e)
        counts = torch.zeros((k, n_rows, n_segs, e), device=dev)
        counts[:, rows[:, None], segs[None, :]] = oh.sum(3)
        # One psum: the aux's sums and every rank's counts (each entry is
        # one rank's, so the sum places them).
        stats = psum(torch.cat([onehot[:, 0, :].sum(0), probs.sum(0),
                                counts.reshape(-1)]),
                     self.data_axes(), mesh=mesh)
        aux = e * torch.sum((stats[:e] / tokens) * (stats[e:2 * e] / tokens))
        # Every rank of the group holds this aux, and the trainer means the
        # group's gradients: its gradient counts once a rank.
        n = mesh.axis_size(self.data_axes())
        aux = aux.detach() + n * (aux - aux.detach())
        counts = stats[2 * e:].detach().round().long().reshape(counts.shape)
        flat = counts.reshape(-1, e)
        before = (torch.cumsum(flat, 0) - flat).reshape(counts.shape)
        mine = before[:, rows[:, None], segs[None, :]]            # (k,b,nl,e)
        ohi = oh.long()
        pos = ((mine[:, :, :, None, :] + torch.cumsum(ohi, 3)) * ohi).sum(-1)
        # An expert keeps its first cap (token, choice)s.
        over = (counts.sum((0, 1, 2)) - cap).clamp(min=0).sum()
        self.dropped = (over.float() / (k * tokens)).detach()
        return pos.reshape(k, b * s), cap, aux

    def _dispatch(self, xt, experts, gates, pos, keep, cap):
        """The experts' output for the tokens `xt` (t, d): dispatch at
        `cap`, the expert FFN, the combine (the class docstring)."""
        e, k, dt = self.n_experts, self.top_k, self.compute_dtype
        t, d = xt.shape
        e_here = self.wi.shape[0]
        mesh = self.mesh[0] if self.mesh is not None else None
        ep = self.ep_axis if e_here != e else None
        scatter = ep is not None and ep in self.data_axes()
        own = ep is not None and not scatter  # this rank's experts' columns
        lo = mesh.axis_index(ep) * e_here if own else 0
        if own:  # ep-invariant in, ep-varying columns
            xt, gates = pvary(xt, ep, mesh=mesh), pvary(gates, ep, mesh=mesh)
        cols = torch.arange(lo * cap, (lo + (e_here if own else e)) * cap,
                            device=xt.device)
        dispatch = combine = None
        for j in range(k):
            # This choice's (t, cols) one-hot; a dropped choice's row is 0.
            where = torch.where(keep[j], experts[:, j] * cap + pos[j] - 1, -1)
            p = (where[:, None] == cols).to(dt)
            g = p * gates[:, j, None].to(dt)
            dispatch = p if dispatch is None else dispatch + p
            combine = g if combine is None else combine + g
        xe = (dispatch.t() @ xt.to(dt)).reshape(-1, cap, d)
        if scatter:
            xe = psum_scatter(xe, ep, tiled=True, mesh=mesh)
        tp = self.ffn_tp if self.wi.shape[2] != self.d_ff else None
        if tp:
            xe = pvary(xe, tp, mesh=mesh)
        hdn = F.gelu(torch.bmm(xe, self.wi.to(dt)), approximate="tanh")
        ye = torch.bmm(hdn, self.wo.to(dt))
        if tp:
            ye = psum(ye, tp, mesh=mesh)
        if scatter:
            ye = all_gather(ye, ep, tiled=True, varying=True, mesh=mesh)
        y = combine @ ye.reshape(-1, d)
        if own:
            y = psum(y, ep, mesh=mesh)
        return y


class Block(nn.Module):
    """Pre-norm attention + MLP block. With `n_experts` > 0 the MLP is a
    ``MoeMlp`` (named ``moe``) and ``forward`` returns (x, aux loss)."""

    def __init__(self, d_model, n_heads, head_dim, d_ff, compute_dtype,
                 attn_impl, n_kv_heads, mlp_impl, attn_window,
                 decode_ring_cache=True, weight_quant=None, lora=(0, None),
                 moe=(0, 1.25, 1), device=None):
        super().__init__()
        self.norm1 = RMSNorm(d_model, device=device)
        self.attn = SelfAttention(d_model, n_heads, head_dim, compute_dtype,
                                  attn_impl, n_kv_heads, attn_window,
                                  decode_ring_cache, weight_quant, lora,
                                  device=device)
        self.norm2 = RMSNorm(d_model, device=device)
        n_experts, capacity_factor, top_k = moe
        self.is_moe = n_experts > 0
        if self.is_moe:
            self.moe = MoeMlp(d_model, n_experts, d_ff, capacity_factor,
                              compute_dtype, top_k, device=device)
        else:
            self.mlp = Mlp(d_model, d_ff, compute_dtype, mlp_impl,
                           weight_quant, lora, device=device)

    def forward(self, x, cache=None, prefill=False, prefix=""):
        x = x + self.attn(self.norm1(x), cache, prefill, prefix + "attn/")
        if self.is_moe:
            y, aux = self.moe(self.norm2(x))
            return x + y, aux
        return x + self.mlp(self.norm2(x))


_aten = torch.ops.aten
# remat_policy -> the ops whose outputs a rematerialized block saves.
REMAT_POLICIES = {
    None: (),
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default),
    "dots_no_batch": (_aten.mm.default, _aten.addmm.default),
}


class Transformer(nn.Module):
    """Causal decoder-only LM. Tokens (b, s) int -> logits (b, s, vocab) f32.

    `device=None` builds the parameters on the GPU (raising without one);
    pass "cpu" or "meta" explicitly. A "meta" model holds no weights; the
    entry points take the weights as a parameter dict and run a `bind`
    copy of the architecture that holds them. `clone(**overrides)` is the
    weightless copy with options changed (flax's ``Module.clone``)."""

    def __init__(self, vocab: int = 32000, d_model: int = 512,
                 n_layers: int = 4, n_heads: int = 8, d_ff: int = 2048,
                 compute_dtype=torch.bfloat16, attn_impl: str = "reference",
                 n_kv_heads: int | None = None, mlp_impl: str = "gelu",
                 attn_window: int | None = None, flash_block_q: int = 128,
                 flash_block_k: int = 128, decode_ring_cache: bool = True,
                 remat: bool = False, remat_policy: str | None = None,
                 weight_quant: str | None = None, n_experts: int = 0,
                 moe_every: int = 2, moe_top_k: int = 1,
                 capacity_factor: float = 1.25, lora_rank: int = 0,
                 lora_alpha: float | None = None, mesh=None,
                 dp_axis: str | None = "dp", sp_axis: str = "sp",
                 tp_axis: str | None = None, device=None):
        super().__init__()
        self._kwargs = dict(
            vocab=vocab, d_model=d_model, n_layers=n_layers, n_heads=n_heads,
            d_ff=d_ff, compute_dtype=compute_dtype, attn_impl=attn_impl,
            n_kv_heads=n_kv_heads, mlp_impl=mlp_impl, attn_window=attn_window,
            flash_block_q=flash_block_q, flash_block_k=flash_block_k,
            decode_ring_cache=decode_ring_cache, remat=remat,
            remat_policy=remat_policy, weight_quant=weight_quant,
            n_experts=n_experts, moe_every=moe_every, moe_top_k=moe_top_k,
            capacity_factor=capacity_factor, lora_rank=lora_rank,
            lora_alpha=lora_alpha, mesh=mesh, dp_axis=dp_axis,
            sp_axis=sp_axis, tp_axis=tp_axis)
        if remat_policy not in REMAT_POLICIES:
            # Validated even when remat is off, like the flax model.
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        if weight_quant not in (None, "int8"):
            raise ValueError(f"unknown weight_quant {weight_quant!r}")
        if weight_quant is not None and n_experts > 0:
            raise ValueError(
                "weight_quant does not cover MoE expert einsum weights; "
                "use a dense model or weight_quant=None")
        if attn_impl not in ("reference", "flash") + SP_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        if attn_impl in IN_POD_IMPLS and mesh is None:
            raise ValueError(f"attn_impl={attn_impl!r} requires a mesh")
        device = _device.resolve(device)
        self.mesh = mesh
        self.dp_axis, self.sp_axis, self.tp_axis = dp_axis, sp_axis, tp_axis
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
        self.remat_policy = remat_policy
        self.weight_quant = weight_quant
        self.n_experts, self.moe_every = n_experts, moe_every
        self.moe_top_k, self.capacity_factor = moe_top_k, capacity_factor
        self.lora_rank, self.lora_alpha = lora_rank, lora_alpha
        head_dim = d_model // n_heads
        lora = (lora_rank, lora_alpha)
        self.embed = nn.Parameter(torch.empty(vocab, d_model, device=device))
        for i in range(n_layers):
            moe = n_experts > 0 and (i + 1) % moe_every == 0
            self.add_module(f"block{i}", Block(
                d_model, n_heads, head_dim, d_ff, compute_dtype, attn_impl,
                n_kv_heads, mlp_impl, attn_window, decode_ring_cache,
                weight_quant, lora,
                (n_experts if moe else 0, capacity_factor, moe_top_k),
                device=device))
        self.norm_f = RMSNorm(d_model, device=device)
        self.lm_head = _dense(d_model, vocab, compute_dtype, device,
                              weight_quant, *lora)
        if mesh is not None:
            sp = sp_axis if attn_impl in IN_POD_IMPLS else None
            tokens = tuple(a if a is not None and a in mesh.shape else None
                           for a in (dp_axis, sp))
            for mod in self.modules():
                if isinstance(mod, (Dense, QuantDense)) and tp_axis:
                    mod.tp = (mesh, tp_axis)
                elif isinstance(mod, SelfAttention):
                    mod.mesh = (mesh, dp_axis, sp_axis, tp_axis)
                elif isinstance(mod, MoeMlp):
                    mod.mesh = (mesh, *tokens, attn_impl == "zigzag")
            self._apply_rules()

    #: The partition rules this model's blocks were cut by (None: its
    #: ``transformer_partition_rules`` over tp_axis, experts replicated).
    rules = None

    def partition_rules(self) -> list:
        """The rules this model's blocks are cut by: the ones given to
        ``local_params``, else ``transformer_partition_rules`` over its
        tp_axis."""
        if self.rules is not None:
            return self.rules
        return transformer_partition_rules(tp_axis=self.tp_axis)

    def _apply_rules(self) -> None:
        """Tell each MoE layer which axes its experts and FFN split over:
        the spec the rules give its ``wi`` (e, d, f) (an axis that does not
        divide its dim leaves it whole, as ``shard_params`` does)."""
        from tpunet_torch.parallel.mesh import leaf_spec

        rules = self.partition_rules()
        for name, mod in self.named_modules():
            if isinstance(mod, MoeMlp):
                spec = tuple(leaf_spec(name + ".wi", tuple(mod.wi.shape),
                                       self.mesh, rules)) + (None,) * 3
                mod.ep_axis, mod.ffn_tp = spec[0], spec[2]

    def local_params(self, params: dict, rules=None) -> dict:
        """This rank's blocks of the full state_dict `params` under the
        partition rules (``parallel.shard_params``). `rules` (e.g.
        ``transformer_partition_rules(tp_axis="mdl", ep_axis="dp")`` for
        experts over dp) replaces this model's and stays with it and its
        clones, as a sharding stays with a JAX array, so that its layers
        know which axis each block is split over."""
        from tpunet_torch.parallel.mesh import shard_params

        if rules is not None:
            self.rules = list(rules)
            self._apply_rules()
        return shard_params(params, self.mesh, self.partition_rules())[1]

    def kv_head_ids(self, index: int | None = None) -> list[int]:
        """The whole-model kv head of each of a rank's cache heads, in
        cache order: all of them, or under TP, when the partition rules
        split the q projection over tp_axis, the kv heads the q heads of
        the rank at tp index `index` (default this rank) read
        (``_head_layout``), wherever the rules cut k and v. A head may
        repeat: split across ranks, or read once a q head."""
        kv = self.n_kv_heads or self.n_heads
        if self.mesh is None or self.tp_axis is None:
            return list(range(kv))
        from tpunet_torch.parallel.mesh import leaf_spec

        name, p = next((n, p) for n, p in self.named_parameters()
                       if n.startswith("block0.attn.q."))
        spec = leaf_spec(name, tuple(p.shape), self.mesh,
                         self.partition_rules())
        if all(a is None for a in spec):
            return list(range(kv))
        if index is None:
            index = self.mesh.axis_index(self.tp_axis)
        width = self.n_heads * self.head_dim // self.mesh.axis_size(
            self.tp_axis)
        return list(_head_layout(self.n_heads, kv, self.head_dim, width,
                                 index)[2])

    def local_kv_heads(self) -> int:
        """The kv heads this rank's attention holds (the decode cache's
        width): ``len(kv_head_ids())``."""
        return len(self.kv_head_ids())

    def data_axes(self) -> tuple:
        """The mesh axes the data is sharded over: dp_axis, and sp_axis
        under an in-pod sequence-parallel impl (the axes whose gradients
        the trainer means over)."""
        axes = [self.dp_axis]
        if self.attn_impl in IN_POD_IMPLS:
            axes.append(self.sp_axis)
        return tuple(a for a in axes if a is not None and a in self.mesh.shape)

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
            "weight_quant": self.weight_quant,
            "n_experts": self.n_experts,
            "lora_rank": self.lora_rank,
        }

    def forward(self, tokens, train: bool = False,
                features_only: bool = False, *, cache=None,
                prefill: bool = False, rng=None, moe_aux: list | None = None):
        """Logits (or features). `moe_aux`, a list, receives each MoE
        block's load-balancing loss in block order (flax's sown
        ``intermediates/moe_aux_loss``), as a block output, so it keeps its
        gradient under remat."""
        del train, rng  # no dropout in this family; kept for the trainer
        if self.weight_quant is not None and features_only:
            raise ValueError(
                "weight_quant is incompatible with features_only: the "
                "blockwise fused cross-entropy reads an fp lm_head weight "
                "from the state_dict")
        if self.lora_rank > 0 and features_only:
            raise ValueError(
                "lora_rank is incompatible with features_only: the "
                "blockwise fused cross-entropy reads the lm_head weight, "
                "but the adapted model nests it under 'base' (and the "
                "lm_head adapters would be silently dropped) - merge_lora "
                "first, or train without fused xent")
        dt = self.compute_dtype
        x = self._embed(tokens)
        saved = REMAT_POLICIES[self.remat_policy]
        kw = {}
        if saved:
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, list(saved))
        for i in range(self.n_layers):
            block = getattr(self, f"block{i}")
            if self.remat and cache is None and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False, **kw)
            else:
                x = block(x, cache, prefill, f"block{i}/")
            if block.is_moe:
                x, aux = x
                if moe_aux is not None:
                    moe_aux.append(aux)
        x = self.norm_f(x)
        if features_only:
            return x.to(dt)
        head_tp = self.lm_head.kind()
        logits = self.lm_head(_tp_input(x, self.lm_head))
        if head_tp == "column":  # vocab-sharded: every rank's block
            logits = all_gather(logits, self.tp_axis, axis=-1, tiled=True,
                                mesh=self.mesh)
        return logits.float()

    def _embed(self, tokens):
        """The embedding lookup in the compute dtype; a vocab-sharded table
        looks up the ids in its rows (zeros elsewhere) and sums over the
        axis, one nonzero term an id: bitwise the whole table's lookup."""
        dt = self.compute_dtype
        rows = self.embed.shape[0]
        if self.mesh is None or self.tp_axis is None or rows == self.vocab:
            return F.embedding(tokens, self.embed).to(dt)
        lo = self.mesh.axis_index(self.tp_axis) * rows
        mine = (tokens >= lo) & (tokens < lo + rows)
        x = F.embedding((tokens - lo).clamp(0, rows - 1), self.embed).to(dt)
        x = torch.where(mine[..., None], x, torch.zeros((), dtype=dt,
                                                        device=x.device))
        return psum(x, self.tp_axis, mesh=self.mesh)


    def init_params(self, *, seed: int, device=None) -> dict:
        """This family's ``init_params`` (the trainer's init, as flax's
        ``model.init``)."""
        return init_params(self, seed=seed, device=device)

    def bind(self, params: dict, trainable: bool = False) -> "Transformer":
        """A copy of this architecture whose parameters ARE the tensors of
        `params` (a state_dict, e.g. from ``convert.from_flax`` or
        ``init_params``; nothing is copied). Each engine runs its own bound
        copy, so threads never share a module whose weights are swapped.
        trainable: as ``_bind.bind``."""
        return _bind.bind(self.clone(), params, trainable)

    def clone(self, **overrides) -> "Transformer":
        """A weightless (meta) copy of this architecture with `overrides`
        applied, e.g. ``clone(weight_quant="int8")`` for the int8
        self-draft or ``clone(decode_ring_cache=False)``."""
        out = Transformer(**{**self._kwargs, **overrides}, device="meta")
        if self.rules is not None and out.mesh is not None:
            out.rules = self.rules
            out._apply_rules()
        return out


def transformer_partition_rules(tp_axis: str | None = "mdl",
                                ep_axis: str | None = None) -> list:
    """Path-regex -> PartitionSpec rules over the flax path, in flax's
    layout (first match wins; no match = replicated): the JAX package's
    table verbatim (``parallel.shard_params`` maps it onto the port's
    state_dict). Megatron TP over `tp_axis` (None = no TP); MoE experts
    over `ep_axis` (None = experts replicated)."""
    ep = ep_axis
    return [
        (r".*attn/(q|k|v)/kernel", P(None, tp_axis)),
        (r".*attn/out/kernel", P(tp_axis, None)),
        (r".*mlp/(up|gate)/kernel", P(None, tp_axis)),
        (r".*mlp/down/kernel", P(tp_axis, None)),
        (r".*moe/router", P()),
        (r".*moe/wi", P(ep, None, tp_axis)),
        (r".*moe/wo", P(ep, tp_axis, None)),
        (r".*embed", P(tp_axis, None)),
        (r".*lm_head/kernel", P(None, tp_axis)),
        # weight_quant="int8" trees: q shards like its kernel; the
        # per-output-channel scale shards with the OUTPUT dim (replicated
        # for row-parallel kernels, whose output dim is whole).
        (r".*attn/(q|k|v)/q", P(None, tp_axis)),
        (r".*attn/(q|k|v)/scale", P(tp_axis)),
        (r".*attn/out/q", P(tp_axis, None)),
        (r".*attn/out/scale", P()),
        (r".*mlp/(up|gate)/q", P(None, tp_axis)),
        (r".*mlp/(up|gate)/scale", P(tp_axis)),
        (r".*mlp/down/q", P(tp_axis, None)),
        (r".*mlp/down/scale", P()),
        (r".*lm_head/q", P(None, tp_axis)),
        (r".*lm_head/scale", P(tp_axis)),
        # lora_rank>0 trees: base kernels one level deeper ("base/"), the
        # same specs; for a column-parallel W, A (in, r) replicates and B
        # (r, out) shards its output dim; for a row-parallel W, A shards
        # its input dim and B replicates.
        (r".*attn/(q|k|v)/base/kernel", P(None, tp_axis)),
        (r".*attn/out/base/kernel", P(tp_axis, None)),
        (r".*mlp/(up|gate)/base/kernel", P(None, tp_axis)),
        (r".*mlp/down/base/kernel", P(tp_axis, None)),
        (r".*lm_head/base/kernel", P(None, tp_axis)),
        (r".*attn/(q|k|v)/base/q", P(None, tp_axis)),
        (r".*attn/(q|k|v)/base/scale", P(tp_axis)),
        (r".*attn/out/base/q", P(tp_axis, None)),
        (r".*attn/out/base/scale", P()),
        (r".*mlp/(up|gate)/base/q", P(None, tp_axis)),
        (r".*mlp/(up|gate)/base/scale", P(tp_axis)),
        (r".*mlp/down/base/q", P(tp_axis, None)),
        (r".*mlp/down/base/scale", P()),
        (r".*lm_head/base/q", P(None, tp_axis)),
        (r".*lm_head/base/scale", P(tp_axis)),
        (r".*(attn/(q|k|v)|mlp/(up|gate)|lm_head)/lora_a", P()),
        (r".*(attn/(q|k|v)|mlp/(up|gate)|lm_head)/lora_b", P(None, tp_axis)),
        (r".*(attn/out|mlp/down)/lora_a", P(tp_axis, None)),
        (r".*(attn/out|mlp/down)/lora_b", P()),
    ]


def _fan_in(name: str, shape) -> int:
    """flax lecun_normal's fan-in: the input axis times the receptive
    field (every axis before the last two). A Dense weight here is (out,
    in); the MoE leaves keep flax's layout, router (d, e), wi (e, d, f)
    and wo (e, f, d), so wi's fan-in is e·d and wo's e·f."""
    if name.endswith(".weight"):
        return shape[1]
    return math.prod(shape[:-1])


def init_params(model: Transformer, *, seed: int, device=None,
                dtype=None) -> dict:
    """Random parameters at the flax initialisers' scales, drawn from a
    torch.Generator seeded with `seed`: embed ~ normal(0.02), dense kernels
    and the MoE router and experts lecun-normal (truncated normal, std
    sqrt(1/fan_in)/0.8796, `_fan_in`), LoRA's A ~ normal(0.02) and B zeros,
    norm scales ones. `dtype` pre-casts the dense kernels and the embedding
    (the norm scales and the LoRA adapters stay f32). An int8 model gets
    flax's zero skeleton for its int8 leaves and ones for their scales;
    its weights come from ``quant.quantize_params`` of an fp state_dict
    (and, adapted, ``lora.graft_base``)."""
    dev = _device.resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for name, p in model.named_parameters():
        if name.endswith(".scale"):
            out[name] = torch.ones(p.shape, device=dev)
            continue
        if not p.is_floating_point():
            out[name] = torch.zeros(p.shape, dtype=p.dtype, device=dev)
            continue
        adapter = ".lora_" in name
        t = torch.zeros(p.shape, device=dev)
        if name == "embed" or name.endswith(".lora_a"):
            t.normal_(0.0, 0.02, generator=gen)
        elif not adapter:
            std = math.sqrt(1.0 / _fan_in(name, p.shape)) / 0.87962566103423978
            nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
        out[name] = t.to(dtype) if dtype is not None and not adapter else t
    return out
