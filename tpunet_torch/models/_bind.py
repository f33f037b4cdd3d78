"""``bind``: a copy of an architecture whose parameters ARE given tensors,
shared by the model families."""

from __future__ import annotations

import torch
from torch import nn


def bind(net: nn.Module, params: dict, trainable: bool) -> nn.Module:
    """Load `params` into the weightless (meta) module `net` by assignment
    (nothing is copied) and return it.

    trainable=False freezes it (inference). trainable=True takes `params`
    as ``nn.Parameter`` tensors (the trainer's f32 master weights) and
    leaves them requiring grad, so gradients land on the very tensors the
    optimizer updates. Integer leaves (the int8 weights of a quantized
    model) take no gradient: they stay frozen either way."""
    if trainable:
        plain = [k for k, t in params.items()
                 if t.is_floating_point() and not isinstance(t, nn.Parameter)]
        if plain:
            raise TypeError(f"bind(trainable=True) takes nn.Parameter "
                            f"tensors; {plain[:3]} are not")
    if getattr(net, "mesh", None) is not None:
        _adopt_block_shapes(net, params)
    net.load_state_dict(params, strict=True, assign=True)
    for p in net.parameters():
        p.requires_grad_(trainable and p.is_floating_point())
    return net


def _adopt_block_shapes(net: nn.Module, params: dict) -> None:
    """Give the weightless module of a mesh model the shapes of this rank's
    blocks (``parallel.shard_params``'s `local`): a leaf whose given shape
    differs from the full one must divide it dim by dim."""
    own = dict(net.named_parameters())
    for name, t in params.items():
        full = own.get(name)
        if full is None or tuple(full.shape) == tuple(t.shape):
            continue
        if t.dim() != full.dim() or any(
                f % b for f, b in zip(full.shape, t.shape)):
            raise ValueError(f"{name}: {tuple(t.shape)} is no block of "
                             f"{tuple(full.shape)}")
        mod_name, _, leaf = name.rpartition(".")
        mod = net.get_submodule(mod_name) if mod_name else net
        setattr(mod, leaf, nn.Parameter(
            torch.empty(t.shape, dtype=full.dtype, device="meta"),
            requires_grad=full.requires_grad))
