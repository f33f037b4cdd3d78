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
    decay on every parameter (optax with no mask).
  * Cross-host sync flattens all gradients into ONE vector before the DCN
    all-reduce (one large striped message), or, with ``bucket_bytes``,
    submits byte-bounded same-dtype buckets in backward order as
    nonblocking all-reduces and then collects them all.

The MoE auxiliary loss (``n_experts > 0``) and ZeRO
(``create_zero_train_state``, ``make_zero_train_step``) belong to later
slices of the port and raise NotImplementedError.
"""

from __future__ import annotations

import copy
import re
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from tpunet_torch import _device
from tpunet_torch.models.transformer import init_params


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


def create_train_state(model, rng: int, sample_input, tx, *, params=None,
                       device=None) -> tuple[TrainState, Any]:
    """Initialize f32 trainable params and the optimizer. Returns
    (state, apply_fn), apply_fn being the trainable module bound to them.

    rng: the init seed (``init_params``); `params` overrides the init with a
    given state_dict (e.g. ``from_flax`` of a flax init). device: where the
    params live; default the sample input's device when it is a tensor,
    else the GPU."""
    if device is None:
        device = (sample_input.device
                  if isinstance(sample_input, torch.Tensor) else None)
    dev = _device.resolve(device)
    if params is None:
        params = init_params(model, seed=int(rng), device=dev)
    params = {k: nn.Parameter(t.detach().to(dev, torch.float32).clone())
              for k, t in params.items()}
    state = TrainState(params, tx.init(params), 0)
    return state, model.bind(params, trainable=True)


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
    while the next ones are staged."""
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

    tickets = []
    for b in buckets:
        flat = torch.cat([grads[n].reshape(-1) for n in b])
        if compression == "bf16":
            flat = flat.to(torch.bfloat16)
        tickets.append(dcn_all_reduce_start(flat))
    out = {}
    for b, ticket in zip(buckets, tickets):
        reduced = dcn_all_reduce_finish(ticket)
        off = 0
        for n in b:
            g = grads[n]
            seg = reduced[off:off + g.numel()].to(g.dtype)
            out[n] = seg.reshape(g.shape) / world
            off += g.numel()
    return out


def _flat_dcn_pmean(grads: dict, compression: str | None) -> dict:
    """Mean-all-reduce the gradients as ONE flat vector (dcn_pmean)."""
    from tpunet_torch.interop import dcn_pmean

    names = list(grads)
    shapes = [grads[n].shape for n in names]
    flat = torch.cat([grads[n].reshape(-1) for n in names])
    grads.clear()  # the flat copy is all the all-reduce needs
    if compression == "bf16":
        reduced = dcn_pmean(flat.to(torch.bfloat16)).to(flat.dtype)
    else:
        reduced = dcn_pmean(flat)
    del flat
    segs = torch.split(reduced, [int(np.prod(s)) for s in shapes])
    return {n: seg.view(s) for n, seg, s in zip(names, segs, shapes)}


def _wire_handles_bf16() -> bool:
    """True when the native communicator already compresses f32 payloads to
    bf16 ON THE WIRE (wire_dtype="bf16"): the trainer then ships f32
    gradients and lets the ring quantize at the hops, with f32
    accumulation, instead of casting itself."""
    from tpunet_torch import distributed

    if not distributed.is_initialized():
        return False
    return distributed.global_communicator().wire_dtype == "bf16"


def _pick(logits, labels):
    """logits[..., label] with optax's label semantics: negative labels
    wrap (-1 == V-1), labels >= V give NaN."""
    vocab = logits.shape[-1]
    labels = torch.where(labels < 0, labels + vocab, labels)
    valid = (labels >= 0) & (labels < vocab)
    picked = logits.gather(-1, labels.clamp(0, vocab - 1)[..., None])[..., 0]
    return torch.where(valid, picked, float("nan"))


def _make_loss_fn(fused_xent_block: int | None = None, z_loss: float = 0.0):
    """The train-step objective on a bound module: token cross-entropy
    (optax's ``softmax_cross_entropy_with_integer_labels``, i.e.
    logsumexp - picked logit), fused blockwise over the vocab when
    `fused_xent_block` is set (the (b, s, vocab) logits never exist), plus
    z_loss * mean(lse^2) when z_loss > 0."""
    fused = fused_xent_block is not None

    def loss_fn(net, inputs, labels):
        out = net(inputs, train=True, features_only=fused)
        if fused:
            from tpunet_torch.ops import blockwise_cross_entropy

            nll, lse = blockwise_cross_entropy(
                out.reshape(-1, out.shape[-1]), net.lm_head.weight.t(),
                labels.reshape(-1), block_vocab=fused_xent_block,
                return_lse=True)
            loss = nll.mean()
            if z_loss:
                loss = loss + z_loss * torch.mean(torch.square(lse))
            return loss
        lse = torch.logsumexp(out, dim=-1)
        loss = (lse - _pick(out, labels)).mean()
        if z_loss:
            loss = loss + z_loss * torch.mean(torch.square(lse.float()))
        return loss

    return loss_fn


def _value_and_grads(net, params: dict, inputs, labels, loss_fn,
                     accum_steps: int | None):
    """(mean loss, {name: mean grad}) for the batch: one backward, or (with
    accum_steps=k) k microbatches whose activations are freed in between.
    Microbatches are STRIDED (row r -> microbatch r % k), as in the JAX
    trainer; any equal-size grouping keeps the mean of means equal to the
    full-batch mean."""
    names = list(params)
    tensors = [params[n] for n in names]
    if accum_steps is None or accum_steps == 1:
        loss = loss_fn(net, inputs, labels)
        grads = torch.autograd.grad(loss, tensors)
        return loss.detach(), dict(zip(names, grads))
    batch = inputs.shape[0]
    if batch % accum_steps:
        raise ValueError(f"batch {batch} not divisible by accum_steps "
                         f"{accum_steps}")
    loss_sum = torch.zeros((), device=inputs.device)
    grad_sum = None
    for j in range(accum_steps):
        loss = loss_fn(net, inputs[j::accum_steps], labels[j::accum_steps])
        grads = torch.autograd.grad(loss, tensors)
        loss_sum = loss_sum + loss.detach()
        grad_sum = (list(grads) if grad_sum is None
                    else [a + g for a, g in zip(grad_sum, grads)])
    return loss_sum / accum_steps, {n: g / accum_steps
                                    for n, g in zip(names, grad_sum)}


def _as_tokens(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x, device=device).long()


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
    ``tpunet_torch.distributed`` (initialize() first). grad_compression=
    "bf16" casts the gradient vector to bf16 around the all-reduce, or,
    when the communicator's wire already compresses to bf16, ships f32 and
    lets the ring quantize. bucket_bytes (cross_host only): nonblocking
    byte-bounded buckets instead of one flat vector. `rng` is accepted for
    signature parity: the model family has no dropout."""
    del tx  # the optimizer lives in the state (tx.init in create_train_state)
    if grad_compression not in (None, "bf16"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}")
    if bucket_bytes is not None and not cross_host:
        raise ValueError("bucket_bytes requires cross_host=True")
    if getattr(model, "n_experts", 0) > 0:
        raise NotImplementedError(
            "the MoE auxiliary loss belongs to the model options slice of "
            "the port (ROADMAP A.5)")
    del moe_aux_weight
    if cross_host:
        from tpunet_torch import distributed

        world = distributed.world_size()  # raises if initialize() was skipped
        if grad_compression == "bf16" and _wire_handles_bf16():
            grad_compression = None
    loss_fn = _make_loss_fn(fused_xent_block, z_loss)

    def train_step(state: TrainState, inputs, labels, rng=None):
        del rng
        if not donate:
            state = copy.deepcopy(state)
        params = state.params
        dev = next(iter(params.values())).device
        inputs, labels = _as_tokens(inputs, dev), _as_tokens(labels, dev)
        net = model.bind(params, trainable=True)
        loss, grads = _value_and_grads(net, params, inputs, labels, loss_fn,
                                       accum_steps)
        if cross_host:
            if bucket_bytes is not None:
                grads = _bucketed_dcn_pmean(grads, bucket_bytes,
                                            grad_compression, world)
            else:
                grads = _flat_dcn_pmean(grads, grad_compression)
        for name, p in params.items():
            p.grad = grads.pop(name)
        state.opt_state.step()
        for p in params.values():
            p.grad = None
        return TrainState(params, state.opt_state, state.step + 1), loss

    return train_step


def create_zero_train_state(*args, **kwargs):
    raise NotImplementedError(
        "ZeRO (optimizer-state sharding) is a later slice of the port "
        "(ROADMAP queue A, training leftovers)")


def make_zero_train_step(*args, **kwargs):
    raise NotImplementedError(
        "ZeRO (optimizer-state sharding) is a later slice of the port "
        "(ROADMAP queue A, training leftovers)")
