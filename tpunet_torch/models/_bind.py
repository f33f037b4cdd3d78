"""``bind``: a copy of an architecture whose parameters ARE given tensors,
shared by the model families."""

from __future__ import annotations

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
    net.load_state_dict(params, strict=True, assign=True)
    for p in net.parameters():
        p.requires_grad_(trainable and p.is_floating_point())
    return net
