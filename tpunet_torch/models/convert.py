"""Carry weights between the JAX package's flax tree and the port.

The flax tree of ``tpunet.models.Transformer`` holds ``embed``,
``block{i}/attn/{q,k,v,out}/kernel``, ``block{i}/mlp/{up,gate,down}/kernel``,
``block{i}/norm{1,2}/scale``, ``norm_f/scale`` and ``lm_head/kernel``;
that of ``tpunet.models.VGG`` holds ``conv{i}/{kernel,bias}`` and
``{fc1,fc2,head}/{kernel,bias}``. The port's module trees use the same
names with ``.`` for ``/`` and ``weight`` for ``kernel``. A flax Dense
kernel is (in, out) and a torch weight (out, in), so dense kernels are
transposed on the way in and out. A flax conv kernel is (kh, kw, in, out)
(HWIO) and a torch one (out, in, kh, kw) (OIHW): ``permute(3, 2, 0, 1)``
in, ``(2, 3, 1, 0)`` out (a plain ``.T`` would give the right shape with
kh and kw swapped); the port keeps them channels-last. An int8 model's
dense layers (``QuantDense``) hold ``{q, scale}`` instead of ``kernel``:
``q`` is int8 (in, out) in flax and (out, in) here, transposed like a
kernel, and never cast; ``scale`` is (out,) f32 either way. (The
attention's Dense named ``q`` then has a leaf ``q``:
``block{i}/attn/q/q`` <-> ``block{i}.attn.q.q``.)
An MoE block's ``block{i}/moe/{router,wi,wo}`` are einsum weights, not
Dense kernels: they keep flax's layout, (d, e), (e, d, f) and (e, f, d),
and are never transposed. A LoRA model's dense layers nest the base one
level deeper, ``…/q/base/kernel`` <-> ``….q.base.weight`` (or
``base/q`` and ``base/scale`` over an int8 base, QLoRA), and keep
``lora_a`` (in, r) and ``lora_b`` (r, out) in flax's layout, untransposed
(``LoraDense`` computes x · A · B).
`to_flax(from_flax(tree))` gives back the tree bitwise.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _flatten(value, path + "/")
        else:
            yield path, value


def _torch_name(flax_path: str) -> str:
    parts = flax_path.split("/")
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


def _transposed(leaf: str, ndim: int) -> bool:
    """A dense or conv kernel, or a QuantDense's int8 matrix: the leaves
    whose layout differs between flax and the port."""
    return leaf == "kernel" or (leaf == "q" and ndim == 2)


def _torch_layout(path: str, arr):
    """A flax array in the port's layout, as a numpy view (no copy)."""
    if not _transposed(path.rsplit("/", 1)[-1], arr.ndim):
        return arr
    return arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T


def from_flax(params, model, dtype=None, device=None) -> dict:
    """The port's state_dict from a flax param tree of numpy arrays (a
    nested dict, as ``jax.tree.map(np.asarray, params)`` gives). `dtype`
    pre-casts the floating-point leaves but the scales (norm and int8
    scales stay f32); `device` defaults to the model's own parameters'
    device."""
    expected = dict(model.named_parameters())
    if device is None:
        device = next(iter(expected.values())).device
    out = {}
    for path, value in _flatten(params):
        name = _torch_name(path)
        if name not in expected:
            raise KeyError(f"flax parameter {path!r} has no counterpart "
                           f"{name!r} in the port's model")
        t = torch.from_numpy(np.array(_torch_layout(path, np.asarray(value)),
                                      order="C"))
        if t.dim() == 4:
            t = t.contiguous(memory_format=torch.channels_last)
        if tuple(t.shape) != tuple(expected[name].shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)} does not match "
                             f"the port's {tuple(expected[name].shape)}")
        if (dtype is not None and t.is_floating_point()
                and not name.endswith(".scale")):
            t = t.to(dtype)
        out[name] = t.to(device)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"flax tree lacks parameters {missing}")
    return out


def to_flax(state_dict) -> dict:
    """Invert `from_flax`: a nested dict of numpy arrays in flax layout
    (bf16 tensors come back as f32, numpy having no bfloat16; int8 stays
    int8)."""
    tree: dict = {}
    for name, t in state_dict.items():
        parts = name.split(".")
        if parts[-1] == "weight":
            parts[-1] = "kernel"
        t = t.detach().cpu()
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if _transposed(parts[-1], arr.ndim):
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        node[parts[-1]] = np.ascontiguousarray(arr)
    return tree
