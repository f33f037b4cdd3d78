"""Training step with an optional cross-host gradient all-reduce over the
tpunet DCN transport: the port of ``tpunet/train/trainer.py``.

The JAX step is one jitted pure function; here it runs eagerly and updates
the state IN PLACE (the counterpart of the JAX step's buffer donation; with
``donate=False`` the step first deep-copies the state, so the caller's old
state stays valid, at twice the memory).

  * ``TrainState(params, opt_state, step)``: ``params`` maps names to the
    f32 master weights as ``nn.Parameter`` tensors, ``opt_state`` is the
    optimizer that updates them, ``step`` a host int.
  * ``tx``: an ``adamw(learning_rate)`` factory, the counterpart of
    ``optax.adamw``: ``torch.optim.AdamW`` with optax's defaults (betas
    0.9/0.999, eps 1e-8, weight decay 1e-4 where torch's default is 1e-2),
    decay on every parameter (optax with no mask); or ``sgd(learning_rate,
    momentum, nesterov)``, ``optax.sgd``'s counterpart.
  * The model is either family of ``tpunet_torch.models``: a Transformer
    (token inputs) or a VGG (float NHWC images). Its params come from its
    own ``init_params``; the step's ``rng`` seeds its dropout.
  * Cross-host sync flattens all gradients into ONE vector before the DCN
    all-reduce (one large striped message), or, with ``bucket_bytes``,
    submits byte-bounded same-dtype buckets in backward order as
    nonblocking all-reduces and then collects them all.

A model over a mesh (``mesh`` set; ``tpunet_torch.parallel``) trains on
each rank's blocks: ``create_train_state`` takes (or inits) the FULL
params and keeps this rank's blocks under the model's partition rules, and
the step means the gradients over the group of the model's data axes
(``data_axes()``: dp, and sp when the sequence is sharded), the sum XLA
inserts from the batch sharding in JAX, in one flat vector over that
group's communicator. A tensor-parallel block is not reduced over the tp
axis, and a leaf replicated under TP (the norm scales) gets the same
gradient on every rank of it with no collective. A leaf split over a data
axis (MoE experts over ep = dp: its gradient already sums every rank's
tokens, through the dispatch's collectives) is summed over the data axes
it is replicated over only, and divided by the whole group's size.
``accum_steps`` takes JAX's strided microbatches of the GLOBAL batch:
microbatch j is the global rows r with r % accum_steps == j, so a rank
takes its rows (offset + i) with that residue; where its block is not a
multiple of accum_steps the ranks' shares differ, and each microbatch's
loss is weighted by the rank's share, so that it is the global mean.
``fused_xent_block`` under TP gathers the vocab-split lm_head weight over
the tp axis (its gradient comes back to each rank's block once) and warns,
as JAX does, that the head's TP speedup is lost.

A mesh is one host's ranks (``parallel.mesh``), the counterpart of a JAX
process, and the DCN tier runs across hosts over the mesh's DCN group (the
ranks at this rank's coordinates, one a host). So on a mesh model
``cross_host=True`` first means the gradients over the in-host data axes,
as above (XLA's psum in JAX), then means them over the DCN group, divided
by the number of hosts H: the one flat vector or the ``bucket_bytes``
buckets, with ``grad_compression`` casting around the DCN tier only. At
H = 1 the DCN tier is the identity (JAX's ``dcn_pmean`` over a world of
one), its casts kept.

ZeRO-1 (``create_zero_train_state``, ``make_zero_train_step``) keeps the
params replicated and shards the optimizer: its state is built over ONE
flat f32 parameter, this rank's 1/world slice of the zero-padded flat
parameter vector. ``create_zero_train_state`` lays the params out as views
of one flat buffer, so that slice IS the params' memory and the shard costs
no copy. On a mesh model the params are the rank's blocks, the DCN world
is its DCN group (world H, rank its host), and the step means over the
in-host data axes before the reduce-scatter. The shard's geometry ({rank,
world, n}, and on a mesh its shape and coordinates) travels in the
optimizer's ``param_groups[0]["zero"]``; a replicated state over a mesh
carries the mesh's shape and coordinates in ``param_groups[0]["mesh"]``,
so that a checkpoint keeps each rank's blocks apart.

An MoE model (``n_experts > 0``) adds ``moe_aux_weight`` times the mean of
its blocks' load-balancing losses to the objective, per (micro)batch.
Integer leaves (QLoRA's int8 base) stay as they are: frozen tensors that
take no gradient and no part in the gradient mean, as the JAX trainer
passes their float0 gradients through. Frozen floating leaves (embed,
norms, an fp LoRA base) still get gradients and are all-reduced;
``models.lora.lora_optimizer`` is what leaves them unchanged. ZeRO-1
refuses integer leaves, as the JAX step does (its flat gradient vector
cannot hold them).
"""

from __future__ import annotations

import contextlib
import copy
import inspect
import re
import warnings
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from tpunet_torch import _device


class TrainState(NamedTuple):
    params: dict
    opt_state: Any
    step: int


class adamw:  # noqa: N801 — named after the optax factory it stands for
    """``optax.adamw`` for torch: ``init(params)`` builds a
    ``torch.optim.AdamW`` over the parameter tensors with optax's
    defaults."""

    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        self.kwargs = dict(lr=learning_rate, betas=(b1, b2), eps=eps,
                           weight_decay=weight_decay)

    def init(self, params: dict) -> torch.optim.Optimizer:
        return torch.optim.AdamW(list(params.values()), **self.kwargs)


class sgd:  # noqa: N801 — named after the optax factory it stands for
    """``optax.sgd`` for torch: ``init(params)`` builds a
    ``torch.optim.SGD`` with no dampening and no weight decay. optax's
    trace is t <- g + momentum * t from zeros and its update -lr * t
    (-lr * (g + momentum * t) with Nesterov); torch's momentum buffer
    starts at the first g, which is the same trajectory. optax ignores
    `nesterov` without momentum, and so does this."""

    def __init__(self, learning_rate: float, momentum: float | None = None,
                 nesterov: bool = False):
        self.kwargs = dict(lr=learning_rate, momentum=momentum or 0.0,
                           dampening=0.0, weight_decay=0.0,
                           nesterov=bool(momentum) and nesterov)

    def init(self, params: dict) -> torch.optim.Optimizer:
        return torch.optim.SGD(list(params.values()), **self.kwargs)


def create_train_state(model, rng: int, sample_input, tx, *, params=None,
                       device=None, rules=None) -> tuple[TrainState, Any]:
    """Initialize f32 trainable params (integer leaves kept as they are,
    frozen) and the optimizer. Returns (state, apply_fn), apply_fn being
    the trainable module bound to them.

    rng: the init seed (the model family's ``init_params``); `params`
    overrides the init with a given state_dict (e.g. ``from_flax`` of a
    flax init). device: where the params live; default the sample input's
    device when it is a tensor, else the GPU. rules: a mesh model's
    partition rules when they are not its own (``local_params``; e.g.
    experts over ep = dp), kept by the model for its steps."""
    if device is None:
        device = (sample_input.device
                  if isinstance(sample_input, torch.Tensor) else None)
    dev = _device.resolve(device)
    if params is None:
        params = model.init_params(seed=int(rng), device=dev)
    mesh = getattr(model, "mesh", None)
    if mesh is not None:
        params = _blocks(model, params, rules)
    params = {k: _master(t, dev) for k, t in params.items()}
    opt = tx.init(params)
    if mesh is not None:
        opt.param_groups[0]["mesh"] = _mesh_layout(mesh)
    state = TrainState(params, opt, 0)
    return state, model.bind(params, trainable=True)


def _blocks(model, params: dict, rules) -> dict:
    """This rank's blocks of the full `params` of a mesh model, under
    `rules` when given (the model keeps them)."""
    return (model.local_params(params, rules) if rules is not None
            else model.local_params(params))


def _mesh_layout(mesh) -> dict:
    """The mesh's shape, this rank's coordinates (which blocks a state
    holds) and its host."""
    return {"mesh": dict(mesh.shape), "coords": dict(mesh.coords),
            "host": mesh.host}


def _master(t: torch.Tensor, device) -> nn.Parameter:
    """A leaf as the train state holds it: a floating leaf as an f32
    master weight, an integer leaf (an int8 base) as it is, frozen."""
    if t.is_floating_point():
        return nn.Parameter(t.detach().to(device, torch.float32).clone())
    return nn.Parameter(t.detach().to(device).clone(), requires_grad=False)


def _backward_order_key(name: str):
    """Sort key approximating backward completion order: output-side
    layers (lm_head, final norm) first, blocks in descending index,
    embeddings last."""
    m = re.search(r"block(\d+)", name)
    if m:
        return (1, -int(m.group(1)), name)
    if "embed" in name:
        return (2, 0, name)
    return (0, 0, name)


def _bucketed_dcn_pmean(grads: dict, bucket_bytes: int,
                        compression: str | None, world: int) -> dict:
    """Mean-all-reduce the gradients over DCN in byte-bounded buckets,
    nonblocking: every bucket is SUBMITTED (dcn_all_reduce_start) before any
    is WAITED (dcn_all_reduce_finish), so the native worker reduces them
    while the next ones are staged. Each gradient leaves `grads` once its
    bucket is staged, and each bucket's device copy is freed then too."""
    from tpunet_torch.interop import (dcn_all_reduce_finish,
                                      dcn_all_reduce_start)

    order = sorted(grads, key=_backward_order_key)
    buckets: list[list[str]] = []
    cur: list[str] = []
    cur_bytes = 0
    for name in order:
        g = grads[name]
        nb = g.numel() * g.element_size()
        if cur and (cur_bytes + nb > bucket_bytes
                    or g.dtype != grads[cur[0]].dtype):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(name)
        cur_bytes += nb
    if cur:
        buckets.append(cur)

    tickets, shapes, dtypes = [], {}, []
    for b in buckets:
        flat = torch.cat([grads[n].reshape(-1) for n in b])
        dtypes.append(flat.dtype)
        for n in b:
            shapes[n] = grads.pop(n).shape
        if compression == "bf16":
            flat = flat.to(torch.bfloat16)
        tickets.append(dcn_all_reduce_start(flat))
        del flat
    out = {}
    for b, dtype, ticket in zip(buckets, dtypes, tickets):
        reduced = dcn_all_reduce_finish(ticket)
        off = 0
        for n in b:
            k = shapes[n].numel()
            seg = reduced[off:off + k].to(dtype)
            out[n] = seg.reshape(shapes[n]) / world
            off += k
    return out


def _flat_dcn_pmean(grads: dict, compression: str | None,
                    world: int) -> dict:
    """Mean-all-reduce the gradients as ONE flat vector, in that vector's
    own memory: the gradient dict is emptied once it is flattened, the sum
    comes back into the vector and is divided in place, so at most two
    gradient-sized device buffers exist (the dict and the vector, while it
    is filled). The bits are dcn_pmean's: x / world in place or not."""
    from tpunet_torch.interop import _all_reduce_into_

    names = list(grads)
    shapes = [grads[n].shape for n in names]
    flat = torch.cat([grads[n].reshape(-1) for n in names])
    grads.clear()  # the flat copy is all the all-reduce needs
    if compression == "bf16":
        flat.copy_(_all_reduce_into_(flat.to(torch.bfloat16)).div_(world))
    else:
        _all_reduce_into_(flat).div_(world)
    segs = torch.split(flat, [s.numel() for s in shapes])
    return {n: seg.view(s) for n, seg, s in zip(names, segs, shapes)}


def _flat_group_pmean(grads: dict, mesh, axes: tuple,
                      n: int | None = None) -> dict:
    """Sum the gradients over the group of `axes` of `mesh` as ONE flat
    vector, in its own memory (``_flat_dcn_pmean`` over the group's
    communicator), and divide by `n` (default the group's size: the
    mean)."""
    from tpunet_torch.interop import _all_reduce_into_

    comm = mesh.comm(axes)
    n = mesh.axis_size(axes) if n is None else n
    if comm is None and n == 1:
        return grads
    names = list(grads)
    shapes = [grads[n].shape for n in names]
    flat = torch.cat([grads[n].reshape(-1) for n in names])
    grads.clear()
    if comm is not None:
        _all_reduce_into_(flat, comm)
    flat.div_(n)
    segs = torch.split(flat, [s.numel() for s in shapes])
    return {n: seg.view(s) for n, seg, s in zip(names, segs, shapes)}


def _reduce_groups(model, data_axes: tuple) -> dict:
    """{data axes a leaf is replicated over: [leaf names]} under the
    model's partition rules: a leaf's gradient is summed over the data axes
    its spec does not split it over (all of them, but for experts split
    over ep = dp), in one flat vector a group."""
    from tpunet_torch.parallel.mesh import _axes, leaf_spec

    rules = model.partition_rules()
    groups: dict = {}
    for name, p in model.named_parameters():
        spec = leaf_spec(name, tuple(p.shape), model.mesh, rules)
        split = {a for entry in spec for a in _axes(entry)}
        axes = tuple(a for a in data_axes if a not in split)
        groups.setdefault(axes, set()).add(name)
    return groups


def _in_host(model) -> tuple:
    """(rows, mean) of a step on `model`: rows(b) places a rank's b local
    rows in its host's batch (``_microbatches``; None off a mesh), and
    mean(grads) means the gradients over the mesh's data axes, each group
    of leaves (``_reduce_groups``) summed over its axes in one flat vector
    and divided by the whole data group's size (the identity off a mesh or
    without a data axis)."""
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return (lambda b: None), (lambda grads: grads)
    data_axes = model.data_axes()
    reduce_over = _reduce_groups(model, data_axes)
    n_data = mesh.axis_size(data_axes)
    dp = getattr(model, "dp_axis", None)
    dp = dp if dp in data_axes else None

    def rows(b: int) -> tuple:
        n_dp = mesh.axis_size(dp) if dp else 1
        return ((mesh.axis_index(dp) if dp else 0) * b, b * n_dp)

    def mean(grads: dict) -> dict:
        if not data_axes:
            return grads
        reduced = {}
        for axes, names in reduce_over.items():
            part = {k: grads.pop(k) for k in list(grads) if k in names}
            reduced.update(_flat_group_pmean(part, mesh, axes, n_data))
        return reduced

    return rows, mean


def _dcn_tier(mesh) -> tuple:
    """(world, rank, context, communicator) of the DCN tier of a step on a
    model over `mesh` (None: no mesh): the mesh's DCN group, entered as a
    context so that the interop calls run over it, on a host mesh; the
    world's processes otherwise. The communicator is None where the tier
    has no peer to reach (a mesh of one host): the step then runs the
    identity in its place. Raises if initialize() was skipped."""
    from tpunet_torch import distributed

    world, rank = distributed.world_size(), distributed.rank()
    if mesh is None:
        return (world, rank, contextlib.nullcontext(),
                distributed.global_communicator())
    if mesh.n_hosts == 1:
        return 1, 0, contextlib.nullcontext(), None
    return mesh.n_hosts, mesh.host, mesh, mesh.dcn_comm()


def _wire_handles_bf16(comm=None) -> bool:
    """True when the DCN tier's communicator (default the world's) already
    compresses f32 payloads to bf16 ON THE WIRE (wire_dtype="bf16"): the
    trainer then ships f32 gradients and lets the ring quantize at the
    hops, with f32 accumulation, instead of casting itself."""
    from tpunet_torch import distributed

    if comm is None:
        if not distributed.is_initialized():
            return False
        comm = distributed.global_communicator()
    return comm.wire_dtype == "bf16"


def _pick(logits, labels):
    """logits[..., label] with optax's label semantics: negative labels
    wrap (-1 == V-1), labels >= V give NaN."""
    vocab = logits.shape[-1]
    labels = torch.where(labels < 0, labels + vocab, labels)
    valid = (labels >= 0) & (labels < vocab)
    picked = logits.gather(-1, labels.clamp(0, vocab - 1)[..., None])[..., 0]
    return torch.where(valid, picked, float("nan"))


class _Xent(torch.autograd.Function):
    """Per-row (nll, lse) of logits over integer labels: lse = logsumexp,
    nll = lse - logits[label] (``_pick``'s semantics). The backward forms
    softmax(logits) once and edits it in place into d(nll, lse)/d logits,
    (softmax * (g_nll + g_lse) - onehot * g_nll), so it holds one
    logits-sized buffer beside the saved logits where autograd's
    logsumexp and gather backwards hold several at once."""

    @staticmethod
    def forward(ctx, logits, labels):
        lse = torch.logsumexp(logits, dim=-1)
        vocab = logits.shape[-1]
        idx = torch.where(labels < 0, labels + vocab, labels).clamp(
            0, vocab - 1)
        ctx.save_for_backward(logits, lse, idx)
        return lse - _pick(logits, labels), lse

    @staticmethod
    def backward(ctx, g_nll, g_lse):
        logits, lse, idx = ctx.saved_tensors
        d = torch.sub(logits, lse[..., None]).exp_()
        d.mul_((g_nll + g_lse)[..., None])
        d.scatter_add_(-1, idx[..., None], -g_nll[..., None])
        return d, None


def _check_fused(model, fused_xent_block: int | None) -> None:
    """The fused cross-entropy needs the model's features (the Transformer
    family's ``features_only``); JAX raises a TypeError for a model without
    them, and so does this, at once."""
    if fused_xent_block is not None and "features_only" not in (
            inspect.signature(model.forward).parameters):
        raise TypeError(
            f"fused_xent_block needs a model whose forward takes "
            f"features_only (the Transformer family); "
            f"{type(model).__name__} has none")


def _make_loss_fn(fused_xent_block: int | None = None, z_loss: float = 0.0,
                  moe_aux_weight: float = 0.0, model=None):
    """The train-step objective on a bound module: cross-entropy over
    integer labels (optax's ``softmax_cross_entropy_with_integer_labels``,
    i.e. logsumexp - picked logit), fused blockwise over the vocab when
    `fused_xent_block` is set (the (b, s, vocab) logits never exist), plus
    z_loss * mean(lse^2) when z_loss > 0, plus, for an MoE `model`,
    moe_aux_weight * the mean of its blocks' load-balancing losses (without
    it the router can collapse onto one expert). `rng` seeds the model's
    dropout (None: a model with dropout raises in training)."""
    fused = fused_xent_block is not None
    has_moe = getattr(model, "n_experts", 0) > 0

    def xent(net, out, labels):
        if fused:
            from tpunet_torch.ops import blockwise_cross_entropy

            nll, lse = blockwise_cross_entropy(
                out.reshape(-1, out.shape[-1]), _head_weight(net).t(),
                labels.reshape(-1), block_vocab=fused_xent_block,
                return_lse=True)
            loss = nll.mean()
            if z_loss:
                loss = loss + z_loss * torch.mean(torch.square(lse))
            return loss
        nll, lse = _Xent.apply(out, labels)
        loss = nll.mean()
        if z_loss:
            loss = loss + z_loss * torch.mean(torch.square(lse.float()))
        return loss

    def loss_fn(net, inputs, labels, rng=None, weight: float = 1.0):
        """`weight` scales the cross-entropy (a rank's share of a global
        microbatch), not the MoE aux loss (every rank holds the global
        one)."""
        aux: list = []
        kw = {"features_only": True} if fused else {}
        if has_moe:
            kw["moe_aux"] = aux
        loss = xent(net, net(inputs, train=True, rng=rng, **kw), labels)
        if weight != 1.0:
            loss = loss * weight
        if aux:
            loss = loss + moe_aux_weight * (sum(aux) / len(aux)).to(
                loss.dtype)
        return loss

    return loss_fn


def _head_weight(net) -> torch.Tensor:
    """The lm_head's (vocab, d) weight; a vocab-split block under TP is
    gathered over the tp axis (every rank of it computes the same loss, so
    the gather's backward hands each rank its block's gradient once)."""
    head = net.lm_head
    w = head.weight
    if getattr(head, "kind", lambda: None)() == "column":
        from tpunet_torch.parallel.smap import all_gather

        mesh, axis = head.tp
        w = all_gather(w, axis, axis=0, tiled=True, mesh=mesh)
    return w


def _split_rng(rng, n: int) -> list:
    """`n` dropout seeds derived from `rng`, jax.random.split's role (None
    stays None)."""
    if rng is None:
        return [None] * n
    return [int(s.generate_state(1)[0])
            for s in np.random.SeedSequence(int(rng)).spawn(n)]


def _microbatches(batch: int, accum_steps: int, rows) -> list:
    """[(rows of the local batch, cross-entropy weight, MoE rows)] of each
    strided microbatch. `rows` = (offset, global batch) on a mesh: this
    rank holds global rows offset + i, and microbatch j takes those with
    (offset + i) % accum_steps == j, at their place in the global
    microbatch, weighted by the rank's share (1 when the shares are
    equal)."""
    if rows is None:
        if batch % accum_steps:
            raise ValueError(f"batch {batch} not divisible by accum_steps "
                             f"{accum_steps}")
        return [(slice(j, None, accum_steps), 1.0, None)
                for j in range(accum_steps)]
    offset, total = rows
    if total % accum_steps:
        raise ValueError(f"global batch {total} not divisible by "
                         f"accum_steps {accum_steps}")
    out = []
    for j in range(accum_steps):
        mine = [i for i in range(batch) if (offset + i) % accum_steps == j]
        if not mine:
            raise ValueError(
                f"accum_steps {accum_steps} leaves microbatch {j} no row of "
                f"this rank's {batch}: every rank needs a row of each")
        even = batch % accum_steps == 0 and offset % accum_steps == 0
        take = slice(j, None, accum_steps) if even else mine
        out.append((take, accum_steps * len(mine) / batch,
                    ([(offset + i) // accum_steps for i in mine],
                     total // accum_steps)))
    return out


def _value_and_grads(net, params: dict, inputs, labels, loss_fn,
                     accum_steps: int | None, rng=None, rows=None):
    """(mean loss, {name: mean grad}) for the batch: one backward, or (with
    accum_steps=k) k microbatches whose activations are freed in between.
    Microbatches are STRIDED (row r -> microbatch r % k), as in the JAX
    trainer; any equal-size grouping keeps the mean of means equal to the
    full-batch mean (an MoE model routes, and sizes its capacity, per
    microbatch, as JAX's does). On a mesh `rows` = (offset, global batch)
    places the rank's rows in the global batch (``_microbatches``). `rng`
    seeds the dropout; each microbatch gets its own seed derived from it,
    as JAX splits the key. Only the floating leaves get a gradient (integer
    leaves are frozen)."""
    names = [n for n, t in params.items() if t.is_floating_point()]
    tensors = [params[n] for n in names]
    if accum_steps is None or accum_steps == 1:
        loss = loss_fn(net, inputs, labels, rng)
        grads = torch.autograd.grad(loss, tensors)
        return loss.detach(), dict(zip(names, grads))
    from tpunet_torch.models.transformer import MoeMlp

    moes = [m for m in net.modules() if isinstance(m, MoeMlp)]
    loss_sum = torch.zeros((), device=inputs.device)
    grad_sum = None
    plan = _microbatches(inputs.shape[0], accum_steps, rows)
    for (take, weight, moe_rows), seed in zip(
            plan, _split_rng(rng, accum_steps)):
        for m in moes:
            m.rows = moe_rows
        loss = loss_fn(net, inputs[take], labels[take], seed, weight)
        grads = torch.autograd.grad(loss, tensors)
        loss_sum = loss_sum + loss.detach()
        grad_sum = (list(grads) if grad_sum is None
                    else [a + g for a, g in zip(grad_sum, grads)])
    for m in moes:
        m.rows = None
    return loss_sum / accum_steps, {n: g / accum_steps
                                    for n, g in zip(names, grad_sum)}


def _as_batch(x, device) -> torch.Tensor:
    """A batch array as a tensor on `device`: float inputs (images) stay
    float, token ids and labels become int64."""
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x, device=device)
    return t if t.is_floating_point() else t.long()


def make_train_step(model, tx=None, cross_host: bool = False,
                    donate: bool = True, grad_compression: str | None = None,
                    moe_aux_weight: float = 0.01,
                    bucket_bytes: int | None = None,
                    fused_xent_block: int | None = None,
                    accum_steps: int | None = None, z_loss: float = 0.0):
    """Build the train step ``(state, inputs, labels, rng) -> (state,
    loss)``; loss is the batch's mean loss as a device scalar (read it to
    the host only when needed: that is a sync point).

    cross_host=True adds the DCN gradient mean over the processes of
    ``tpunet_torch.distributed`` (initialize() first), or, on a mesh
    model, over the mesh's DCN group after the in-host mean (module
    docstring). grad_compression="bf16" casts the gradient vector to bf16
    around the all-reduce, or, when the DCN tier's wire already compresses
    to bf16, ships f32 and lets the ring quantize. bucket_bytes
    (cross_host only): nonblocking byte-bounded buckets instead of one
    flat vector. `rng` (an int) seeds
    the model's dropout, as JAX's dropout key; fused_xent_block needs a
    model with ``features_only`` (the Transformer family)."""
    del tx  # the optimizer lives in the state (tx.init in create_train_state)
    if grad_compression not in (None, "bf16"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}")
    if bucket_bytes is not None and not cross_host:
        raise ValueError("bucket_bytes requires cross_host=True")
    _check_fused(model, fused_xent_block)
    if fused_xent_block is not None and getattr(model, "tp_axis", None):
        warnings.warn(
            "fused_xent_block with a tensor-parallel lm head replicates the "
            "head compute (kernel is gathered); the TP head speedup is lost",
            stacklevel=2)
    rows, in_host_mean = _in_host(model)
    if cross_host:
        world, _, dcn, comm = _dcn_tier(getattr(model, "mesh", None))
        if grad_compression == "bf16" and _wire_handles_bf16(comm):
            grad_compression = None
    loss_fn = _make_loss_fn(fused_xent_block, z_loss, moe_aux_weight, model)

    def train_step(state: TrainState, inputs, labels, rng=None):
        if not donate:
            state = copy.deepcopy(state)
        params = state.params
        dev = next(iter(params.values())).device
        inputs, labels = _as_batch(inputs, dev), _as_batch(labels, dev)
        net = model.bind(params, trainable=True)
        loss, grads = _value_and_grads(net, params, inputs, labels, loss_fn,
                                       accum_steps, rng,
                                       rows(inputs.shape[0]))
        grads = in_host_mean(grads)
        if cross_host and comm is not None:
            with dcn:
                if bucket_bytes is not None:
                    grads = _bucketed_dcn_pmean(grads, bucket_bytes,
                                                grad_compression, world)
                else:
                    grads = _flat_dcn_pmean(grads, grad_compression, world)
        elif cross_host and grad_compression == "bf16":
            # One host: the DCN tier is the identity between its casts.
            grads = {k: g.to(torch.bfloat16).to(g.dtype)
                     for k, g in grads.items()}
        for name in list(grads):
            params[name].grad = grads.pop(name)
        state.opt_state.step()
        for p in params.values():
            p.grad = None
        return TrainState(params, state.opt_state, state.step + 1), loss

    return train_step


def _zero_shard_geometry(n: int, world: int) -> tuple[int, int]:
    """(padded_size, shard_size) for an n-element flat vector over `world`
    equal shards."""
    pad = (-n) % world
    return n + pad, (n + pad) // world


def _shard_pairs(params: dict, lo: int, hi: int):
    """(flat view of a param's slice, offset into the shard) for every
    param overlapping flat elements [lo, hi) of the params laid end to end
    in dict order."""
    off = 0
    for p in params.values():
        k = p.numel()
        a, b = max(lo, off), min(hi, off + k)
        if a < b:
            yield p.detach().view(-1)[a - off:b - off], a - lo
        off += k


def _zero_layout(params: dict, rank: int, world: int, device
                 ) -> tuple[dict, nn.Parameter]:
    """ZeRO-1's layout of `params`: ({name: nn.Parameter view}, shard)
    over ONE new flat f32 buffer on `device` holding the params end to end
    in dict order, zero-padded to a multiple of `world`; the shard is the
    view of this rank's 1/world slice, so it costs no memory of its own."""
    n = sum(t.numel() for t in params.values())
    padded, shard_n = _zero_shard_geometry(n, world)
    flat = torch.zeros(padded, dtype=torch.float32, device=device)
    views, off = {}, 0
    for k, t in params.items():
        seg = flat[off:off + t.numel()]
        seg.copy_(t.detach().reshape(-1))
        views[k] = nn.Parameter(seg.view(t.shape))
        off += t.numel()
    return views, nn.Parameter(flat[rank * shard_n:(rank + 1) * shard_n])


def _refuse_integer_leaves(params: dict) -> None:
    """ZeRO-1 flattens every leaf and its gradient into one f32 vector;
    an integer leaf (an int8 base) has no gradient to put there. The JAX
    step fails there too (float0 gradients have no promotion), so this
    refuses with a ValueError at once."""
    ints = [k for k, t in params.items() if not t.is_floating_point()]
    if ints:
        raise ValueError(
            f"ZeRO-1 needs floating-point params; {ints[:3]} are "
            f"{params[ints[0]].dtype} (an int8 base: train QLoRA with "
            "make_train_step)")


def create_zero_train_state(model, rng: int, sample_input, tx, *,
                            params=None, device=None, rules=None
                            ) -> tuple[TrainState, Any]:
    """ZeRO-1 companion to create_train_state: the optimizer state is built
    on THIS RANK's flat parameter shard (1/world of the elements), not on
    every parameter, so the memory that dominates adamw training (2 f32
    moments per parameter) shrinks by the DCN world size. Requires
    ``tpunet_torch.distributed.initialize()`` first; every rank must call
    it. rng, params, device, rules: as create_train_state.

    The params are ``nn.Parameter`` views of one flat f32 buffer
    (``_zero_layout``), and the optimizer's one parameter is the view of
    this rank's slice of it. On a mesh model the params are the rank's
    blocks and the shard its DCN group's: 1/H of the blocks, H hosts."""
    mesh = getattr(model, "mesh", None)
    world, rank, _, _ = _dcn_tier(mesh)
    if device is None:
        device = (sample_input.device
                  if isinstance(sample_input, torch.Tensor) else None)
    dev = _device.resolve(device)
    if params is None:
        params = model.init_params(seed=int(rng), device=dev)
    if mesh is not None:
        params = _blocks(model, params, rules)
    _refuse_integer_leaves(params)
    views, shard = _zero_layout(params, rank, world, dev)
    opt = tx.init({"zero_shard": shard})
    # The shard's geometry travels with the optimizer (its state_dict
    # too), so a checkpoint can refuse another rank's, world's or mesh
    # position's shard.
    zero = {"rank": rank, "world": world,
            "n": sum(t.numel() for t in views.values())}
    if mesh is not None:
        zero.update(_mesh_layout(mesh))
    opt.param_groups[0]["zero"] = zero
    return TrainState(views, opt, 0), model.bind(views, trainable=True)


def make_zero_train_step(model, tx=None, donate: bool = True,
                         grad_compression: str | None = None,
                         moe_aux_weight: float = 0.01,
                         fused_xent_block: int | None = None,
                         accum_steps: int | None = None, z_loss: float = 0.0):
    """ZeRO-1 (optimizer-state sharding) cross-host train step
    ``(state, inputs, labels, rng) -> (state, loss)``.

    Instead of all-reducing the full gradient and updating a replicated
    optimizer (make_train_step cross_host=True), each step (on a mesh
    model, after the gradient mean over the in-host data axes; the DCN
    world is then the mesh's DCN group, and at one host each collective
    below is the identity):
      1. reduce-scatters the flat, zero-padded gradient over DCN: each rank
         receives the MEAN of its 1/world shard (the bytes of the ring
         all-reduce's reduce-scatter phase);
      2. steps the optimizer on that shard: update work and optimizer
         memory both drop by world;
      3. all-gathers the updated shards (the all-reduce's all-gather
         phase's bytes) and copies them into the params in place.
    The trajectory matches the replicated path to float rounding (bitwise
    at world 2): the ring all-reduce computes each element's sum in
    exactly the reduce-scatter this path runs, and adamw is elementwise,
    so sharding the vector reorders no per-element arithmetic.

    State must come from create_zero_train_state. grad_compression="bf16"
    casts the gradient to bf16 around the reduce-scatter (or, on a
    wire_dtype="bf16" communicator, ships f32 and lets the ring quantize);
    the gather of updated params stays full precision either way.
    (rank, world) are captured here, when the step is made.

    Elastic caveat: the shard geometry bakes in (rank, world), so after an
    elastic rebuild that CHANGES the world size the sharded optimizer
    state is invalid: rebuild it with create_zero_train_state and restore
    params (not optimizer state) from the checkpoint. Fixed-world rebuilds
    resume fine."""
    del tx  # the optimizer lives in the state (create_zero_train_state)
    if grad_compression not in (None, "bf16"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}")
    _check_fused(model, fused_xent_block)
    from tpunet_torch.interop import dcn_all_gather, dcn_reduce_scatter

    world, rank, dcn, comm = _dcn_tier(getattr(model, "mesh", None))
    rows, in_host_mean = _in_host(model)
    # One cast path (see make_train_step): the native wire codec quantizes
    # the reduce-scatter's hops itself, with f32 accumulation.
    if grad_compression == "bf16" and _wire_handles_bf16(comm):
        grad_compression = None
    loss_fn = _make_loss_fn(fused_xent_block, z_loss, moe_aux_weight, model)

    def train_step(state: TrainState, inputs, labels, rng=None):
        if not donate:
            state = copy.deepcopy(state)
        params = state.params
        _refuse_integer_leaves(params)
        (group,) = state.opt_state.param_groups
        (shard,) = group["params"]
        n = sum(p.numel() for p in params.values())
        padded, shard_n = _zero_shard_geometry(n, world)
        if shard.numel() != shard_n:
            raise ValueError(
                f"the optimizer shard holds {shard.numel()} elements; a "
                f"ZeRO state of {n} params over world {world} holds "
                f"{shard_n}: rebuild it with create_zero_train_state")
        lo = rank * shard_n
        with torch.no_grad():
            # The shard IS the params' memory in a state laid out by
            # create_zero_train_state; a deep copy (donate=False) or a
            # caller's new params need it refreshed, as JAX slices it
            # from the params every step.
            sv = shard.detach()
            for src, at in _shard_pairs(params, lo, lo + shard_n):
                dst = sv[at:at + src.numel()]
                if dst.data_ptr() != src.data_ptr():
                    dst.copy_(src)
        dev = shard.device
        inputs, labels = _as_batch(inputs, dev), _as_batch(labels, dev)
        net = model.bind(params, trainable=True)
        loss, grads = _value_and_grads(net, params, inputs, labels, loss_fn,
                                       accum_steps, rng,
                                       rows(inputs.shape[0]))
        grads = in_host_mean(grads)
        parts = [grads[k].reshape(-1) for k in params]
        gflat = torch.cat(parts + [parts[0].new_zeros(padded - n)])
        del parts
        grads.clear()  # the flat copy is all the reduce-scatter needs
        if grad_compression == "bf16":
            gflat = gflat.to(torch.bfloat16)
        if comm is not None:
            with dcn:
                gflat = dcn_reduce_scatter(gflat)
        shard.grad = gflat.to(torch.float32) / world
        del gflat
        state.opt_state.step()
        shard.grad = None
        gathered = shard.detach()
        if comm is not None:
            with dcn:
                gathered = dcn_all_gather(gathered).reshape(-1)
        with torch.no_grad():
            off = 0
            for p in params.values():
                src = gathered[off:off + p.numel()]
                if src.data_ptr() != p.data_ptr():
                    p.copy_(src.view(p.shape))
                off += p.numel()
        del gathered
        return TrainState(params, state.opt_state, state.step + 1), loss

    return train_step


def synthetic_batch(rng: np.random.Generator, batch: int, image_size: int,
                    num_classes: int, channels: int = 3):
    """Random NHWC f32 images and int32 labels (the synthetic-benchmark
    diet), as numpy arrays: the JAX package's draws in its order, so one
    generator state gives both packages the same batch."""
    images = rng.standard_normal(
        (batch, image_size, image_size, channels)).astype(np.float32)
    labels = rng.integers(0, num_classes, size=(batch,)).astype(np.int32)
    return images, labels
