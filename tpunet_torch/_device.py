"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`None` means the GPU. Without one this raises instead of quietly
    running on the CPU; callers that want the CPU say so explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def params_device(params: dict) -> torch.device:
    """The device a parameter dict lives on (its first tensor's)."""
    return next(iter(params.values())).device


def same(a, b) -> bool:
    """Whether two devices are one (``cuda`` and ``cuda:0`` are, when 0 is
    the current card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (
        cur if b.index is None else b.index)
