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
