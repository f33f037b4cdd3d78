"""VGG in PyTorch, the port of ``tpunet/models/vgg.py``.

Same plan, parameter names and numerics as the flax module: 3x3 convs with
padding 1 and biases (``conv{i}``), each followed by relu; 2x2 max-pools
of stride 2 that floor odd sizes; then ``fc1`` -> relu -> dropout ->
``fc2`` -> relu -> dropout -> ``head``. Input, kernels and biases are cast
to ``compute_dtype`` (bf16 by default) at use over f32 params, as flax's
``promote_dtype``; the logits come out f32. ``width_mult`` scales every
channel count and the hidden width, ``max(8, int(c * width_mult))``, only
when it is not 1.0 (so a caller's already scaled ``hidden`` is scaled a
second time, as in the flax module).

Layout: inputs are NHWC images, as in JAX. ``x.permute(0, 3, 1, 2)`` of a
contiguous NHWC tensor IS a channels-last NCHW tensor (no copy), and the
conv kernels are kept channels-last (OIHW shape, OHWI memory), so cuDNN
runs its NHWC kernels. The pooled features are flattened in NHWC order,
free from channels-last and the order flax flattens in, so fc1's rows run
over (H, W, C) as the flax kernel's do.

flax infers the input widths from the sample input at init; the port takes
them at construction: ``image_size`` (224) and ``in_channels`` (3).

Dropout (training only) draws its keep-masks from a ``torch.Generator`` on
the input's device seeded with ``forward``'s ``rng`` (the train step's rng,
JAX's dropout key), keeps each entry with probability 1 - rate and scales
it by 1 / (1 - rate), as flax does; the masks are not JAX's bits.

Tensor parallelism of the classifier (``mesh`` and ``tp_axis``, with
``vgg_partition_rules`` through ``parallel.shard_params``; the JAX model
gets it from the shardings alone): fc1 column-parallel with its bias
sharded (its input through ``pvary``), fc2 row-parallel (its partial
products summed over the axis, its bias added once after the sum), head
column-parallel with its logits gathered. Each layer reads its block's
shape, as the Transformer's do. Dropout draws the full hidden-wide mask
and keeps the rank's columns, so a TP run equals the unsharded one for
one seed.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpunet_torch import _device
from tpunet_torch.models import _bind
from tpunet_torch.parallel.mesh import P, vgg_partition_rules
from tpunet_torch.parallel.smap import all_gather, psum, pvary

# Channel plan per block; "M" = 2x2 max-pool. The classic 16-layer config.
VGG16_CFG: tuple = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512,
                    512, 512, "M", 512, 512, 512, "M")


class Conv3x3(nn.Module):
    """flax ``nn.Conv(features, (3, 3), padding=1, dtype=dt)``: weight
    (out, in, 3, 3) in channels-last memory, bias (out,); input, weight and
    bias cast to the compute dtype at use."""

    def __init__(self, in_channels: int, features: int, dtype, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            features, in_channels, 3, 3, device=device,
            memory_format=torch.channels_last))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        padding=1)


class Dense(nn.Module):
    """flax ``nn.Dense(features, dtype=dt)``: weight (out, in) like
    ``nn.Linear``, bias (out,); cast to the compute dtype at use."""

    def __init__(self, in_features: int, features: int, dtype, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def _dropout(x, rate: float, gen: torch.Generator | None, width=None,
             cols=slice(None)):
    """flax ``nn.Dropout`` in training (no generator: off). Under TP x is a
    block of `cols` of a `width`-wide activation: the full mask is drawn
    and its block kept."""
    if gen is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    shape = x.shape[:-1] + (width or x.shape[-1],)
    keep = torch.empty(shape, device=x.device).bernoulli_(keep_prob,
                                                          generator=gen)
    return torch.where(keep[..., cols].bool(), x / keep_prob, 0.0)


class VGG(nn.Module):
    """VGG-style conv net: (batch, H, W, C) NHWC images -> (batch,
    num_classes) f32 logits.

    cfg: channel plan (ints = 3x3 conv channels, "M" = maxpool);
    num_classes: classifier output size; width_mult: scales every channel
    count (tiny configs for tests); hidden: classifier hidden width (4096
    in the paper config); compute_dtype: activation and matmul dtype;
    classifier_dropout: train-mode dropout rate in the head; image_size,
    in_channels: the input's H = W and C. `device=None` builds the
    parameters on the GPU (raising without one); pass "cpu" or "meta"
    explicitly."""

    def __init__(self, cfg: Sequence = VGG16_CFG, num_classes: int = 1000,
                 width_mult: float = 1.0, hidden: int = 4096,
                 compute_dtype=torch.bfloat16,
                 classifier_dropout: float = 0.5, *, image_size: int = 224,
                 in_channels: int = 3, mesh=None, dp_axis: str | None = "dp",
                 tp_axis: str | None = None, device=None):
        super().__init__()
        self._kwargs = dict(
            cfg=tuple(cfg), num_classes=num_classes, width_mult=width_mult,
            hidden=hidden, compute_dtype=compute_dtype,
            classifier_dropout=classifier_dropout, image_size=image_size,
            in_channels=in_channels, mesh=mesh, dp_axis=dp_axis,
            tp_axis=tp_axis)
        device = _device.resolve(device)
        self.mesh, self.dp_axis, self.tp_axis = mesh, dp_axis, tp_axis
        self.cfg = tuple(cfg)
        self.num_classes, self.width_mult = num_classes, width_mult
        self.compute_dtype = compute_dtype
        self.classifier_dropout = classifier_dropout
        self.image_size, self.in_channels = image_size, in_channels
        side, c, i = image_size, in_channels, 0
        for item in self.cfg:
            if item == "M":
                side //= 2
            else:
                self.add_module(f"conv{i}", Conv3x3(
                    c, self._width(item), compute_dtype, device=device))
                c = self._width(item)
                i += 1
        if side < 1:
            raise ValueError(f"image_size {image_size} pools away to nothing "
                             f"under cfg {self.cfg}")
        self.hidden = self._width(hidden)
        self.fc1 = Dense(side * side * c, self.hidden, compute_dtype, device)
        self.fc2 = Dense(self.hidden, self.hidden, compute_dtype, device)
        self.head = Dense(self.hidden, num_classes, compute_dtype, device)

    def _width(self, c: int) -> int:
        return (max(8, int(c * self.width_mult)) if self.width_mult != 1.0
                else c)

    def forward(self, x, train: bool = False, *, rng=None):
        """x: NHWC images; rng: the dropout seed (needed in training when
        classifier_dropout > 0)."""
        want = (self.image_size, self.image_size, self.in_channels)
        if x.dim() != 4 or tuple(x.shape[1:]) != want:
            raise ValueError(f"VGG takes (batch, {want[0]}, {want[1]}, "
                             f"{want[2]}) NHWC images, got "
                             f"{tuple(x.shape)}")
        gen = None
        if train and self.classifier_dropout > 0.0:
            if rng is None:
                raise ValueError("VGG's dropout needs an rng in training: "
                                 "pass the train step's rng")
            gen = torch.Generator(device=x.device)
            gen.manual_seed(int(rng))
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        i = 0
        for item in self.cfg:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"conv{i}")(x))
                i += 1
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        if self._tp("fc1") is None:
            x = _dropout(F.relu(self.fc1(x)), self.classifier_dropout, gen)
            x = _dropout(F.relu(self.fc2(x)), self.classifier_dropout, gen)
            return self.head(x).float()
        return self._tp_classifier(x, gen)

    def _tp(self, name: str) -> str | None:
        """"column" or "row" for a classifier layer held as a block under
        tensor parallelism, None when whole."""
        w = getattr(self, name).weight
        full = (self.hidden if name != "head" else self.num_classes,
                self.fc1.weight.shape[1] if name == "fc1" else self.hidden)
        if self.mesh is None or self.tp_axis is None:
            return None
        if w.shape[0] != full[0]:
            return "column"
        if w.shape[1] != full[1]:
            return "row"
        return None

    def _tp_classifier(self, x, gen):
        """fc1 column, fc2 row, head column, over the tp axis."""
        if (self._tp("fc1"), self._tp("fc2")) != ("column", "row"):
            raise ValueError("tensor parallelism: fc1 must be column- and "
                             "fc2 row-parallel (vgg_partition_rules)")
        mesh, axis, dt = self.mesh, self.tp_axis, self.compute_dtype
        rate = self.classifier_dropout
        n = self.fc1.weight.shape[0]
        i = mesh.axis_index(axis)
        x = pvary(x.to(dt), axis, mesh=mesh)
        x = F.relu(self.fc1(x))
        x = _dropout(x, rate, gen, self.hidden, slice(i * n, (i + 1) * n))
        x = psum(F.linear(x.to(dt), self.fc2.weight.to(dt)), axis, mesh=mesh)
        x = _dropout(F.relu(x + self.fc2.bias.to(dt)), rate, gen)
        if self._tp("head") != "column":
            return self.head(x).float()
        y = self.head(pvary(x, axis, mesh=mesh))
        return all_gather(y, axis, axis=-1, tiled=True, mesh=mesh).float()

    def partition_rules(self) -> list:
        """``vgg_partition_rules`` over this model's tp_axis (none without
        one)."""
        if self.tp_axis is None:
            return []
        return [(pat, P(*(self.tp_axis if a == "mdl" else a for a in spec)))
                for pat, spec in vgg_partition_rules()]

    def local_params(self, params: dict) -> dict:
        """This rank's blocks of the full state_dict `params` under the
        partition rules (``parallel.shard_params``)."""
        from tpunet_torch.parallel.mesh import shard_params

        return shard_params(params, self.mesh, self.partition_rules())[1]

    def data_axes(self) -> tuple:
        """The mesh axes the images are sharded over (the trainer's
        gradient mean)."""
        return tuple(a for a in (self.dp_axis,)
                     if a is not None and a in self.mesh.shape)

    def init_params(self, *, seed: int, device=None) -> dict:
        """This family's ``init_params`` (the trainer's init, as flax's
        ``model.init``)."""
        return init_params(self, seed=seed, device=device)

    def bind(self, params: dict, trainable: bool = False) -> "VGG":
        """A copy of this architecture whose parameters ARE the tensors of
        `params` (nothing is copied); trainable: as ``_bind.bind``."""
        return _bind.bind(VGG(**self._kwargs, device="meta"), params,
                          trainable)


def init_params(model: VGG, *, seed: int, device=None) -> dict:
    """Random parameters at the flax initialisers' scales, drawn from a
    torch.Generator seeded with `seed`: kernels lecun-normal (truncated
    normal, std sqrt(1/fan_in)/0.8796, fan_in = 9 * in for a conv and in
    for a dense; conv kernels channels-last), biases zeros."""
    dev = _device.resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for name, p in model.named_parameters():
        if name.endswith(".bias"):
            out[name] = torch.zeros(p.shape, device=dev)
            continue
        fmt = (torch.channels_last if p.dim() == 4
               else torch.contiguous_format)
        t = torch.empty(p.shape, device=dev, memory_format=fmt)
        std = math.sqrt(1.0 / math.prod(p.shape[1:])) / 0.87962566103423978
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)
        out[name] = t
    return out


def vgg16(num_classes: int = 1000, width_mult: float = 1.0,
          compute_dtype=torch.bfloat16, *, image_size: int = 224,
          device=None) -> VGG:
    return VGG(cfg=VGG16_CFG, num_classes=num_classes, width_mult=width_mult,
               compute_dtype=compute_dtype, image_size=image_size,
               device=device)


VGG16 = vgg16  # alias
