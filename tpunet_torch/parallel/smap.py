"""``shard_map`` and the differentiable collectives over a mesh axis.

The port of ``tpunet/parallel/smap.py`` and of the ``lax`` collectives its
callers use inside ``shard_map``. A process holds only its own block, so
``shard_map(fn, mesh, in_specs, out_specs)`` calls `fn` on the blocks it is
given, with `mesh` active so that axis names resolve against it; the specs
say which block each argument is (``shard`` cuts a rank's block out of a
global tensor, ``unshard`` gathers the blocks back). JAX's ``full_varying``
and ``vma_of`` are typing shims of its varying-manual-axes checker and have
no torch counterpart: nothing here types values by the axes they vary
over, so the casts JAX inserts implicitly are written out (``pvary``).

Each collective runs over the group communicator of its axes (``Mesh``);
a CUDA tensor is staged through pinned host memory, as in ``interop``. XLA
differentiates its collectives, and so do these, with JAX's transposes:

  * ``psum``: all-reduce forward, identity backward (Megatron's g: every
    rank of the axis holds the same loss, and each backprops into its own
    partial);
  * ``pvary``: identity forward, all-reduce backward (Megatron's f: the
    cast JAX inserts where an axis-invariant value meets a varying one);
  * ``ppermute``: backward is the inverse permutation;
  * ``all_to_all``: backward is the inverse all-to-all;
  * ``all_gather``: backward takes this rank's slice of the cotangent with
    no communication (every rank already holds the whole cotangent), or,
    with ``varying=True`` (the gathered value feeds work that differs
    across the axis: a data axis), JAX's transpose, ``psum_scatter``;
  * ``psum_scatter``: reduce-scatter forward, ``all_gather`` backward;
  * ``axis_index`` and ``axis_size``.

A collective's backward is itself collective, so every rank of the group
must run it, in the same order. PyTorch runs a backward graph's nodes in
the reverse order of their creation, and only the nodes the loss reaches.
So, under grad mode, every collective records its node whether or not its
input needs a gradient, and ``shard_map`` ties every collective output of
its call to its outputs (``_Sink``, with a zero gradient), so that a rank
whose schedule leaves an exchange's result unused (a pipeline bubble, a
skipped causal block) still runs that exchange's transpose.

``axis_stats()`` counts each collective's calls, bytes and host seconds by
axis.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpunet_torch.parallel.mesh import Mesh, P, _axes, active_mesh, local_slices

_stats: dict = {}
_tapes: list = []  # collective outputs of the open shard_map calls


def axis_stats() -> dict:
    """{axes: {collective: {"calls", "bytes", "seconds"}}} since the last
    reset; `axes` joined by "+", bytes the input's."""
    return {k: {c: dict(v) for c, v in d.items()} for k, d in _stats.items()}


def axis_stats_reset() -> None:
    _stats.clear()


def _count(axes: tuple, name: str, x: torch.Tensor, t0: float) -> None:
    st = _stats.setdefault("+".join(axes), {}).setdefault(
        name, {"calls": 0, "bytes": 0, "seconds": 0.0})
    st["calls"] += 1
    st["bytes"] += x.numel() * x.element_size()
    st["seconds"] += time.perf_counter() - t0


def _host(x: torch.Tensor) -> torch.Tensor:
    from tpunet_torch.interop import _to_host

    return _to_host(x)


def _back(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    from tpunet_torch.interop import _to_device

    return _to_device(host, like.device)


def _resolve(axes, mesh: Mesh | None):
    """(mesh, axes in mesh order): `mesh`, or the active one."""
    mesh = mesh if mesh is not None else active_mesh()
    return mesh, mesh.canonical(axes)


# -- the raw collectives (no autograd) ---------------------------------------


def _all_reduce(x, mesh, axes):
    comm = mesh.comm(axes)
    if comm is None:
        return x.clone()
    t0 = time.perf_counter()
    host = _host(x)
    out = comm.all_reduce(host, "sum", inplace=host is not x)
    out = _back(out, x)
    _count(axes, "psum", x, t0)
    return out


def _permute(x, mesh, axes, perm):
    """Send x to perm[my] and return what perm's source of this rank sent:
    one ring step by the neighbor exchange, any other permutation by an
    all-to-all carrying x in its destination's block."""
    comm = mesh.comm(axes)
    w, my = mesh.axis_size(axes), mesh.axis_index(axes)
    if comm is None:
        return x.clone()
    t0 = time.perf_counter()
    if all(perm[i] == (i + 1) % w for i in range(w)):
        out = comm.neighbor_exchange(_host(x))
    else:
        blocks = x.new_zeros((w,) + tuple(x.shape))
        blocks[perm[my]] = x
        got = comm.all_to_all(_host(blocks))
        src = [i for i in range(w) if perm[i] == my]
        out = got[src[0]] if src else torch.zeros_like(got[0])
    out = _back(out, x)
    _count(axes, "ppermute", x, t0)
    return out


def _a2a(x, mesh, axes, split_axis, concat_axis):
    comm = mesh.comm(axes)
    w = mesh.axis_size(axes)
    if x.shape[split_axis] % w:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"not divisible by {'+'.join(axes)}={w}")
    if comm is None:
        return x.clone()
    t0 = time.perf_counter()
    blocks = torch.stack(x.chunk(w, split_axis)).contiguous()
    got = _back(comm.all_to_all(_host(blocks)), x)
    _count(axes, "all_to_all", x, t0)
    return torch.cat(list(got.unbind(0)), dim=concat_axis)


def _reduce_scatter(x, mesh, axes):
    """Sum over the group, this rank's block of dim 0 (divisible by the
    group's size) back."""
    comm = mesh.comm(axes)
    w = mesh.axis_size(axes)
    if x.shape[0] % w:
        raise ValueError(f"psum_scatter: dim 0 of {tuple(x.shape)} not "
                         f"divisible by {'+'.join(axes)}={w}")
    if comm is None:
        return x.clone()
    t0 = time.perf_counter()
    out = None
    if x.device.type != "cpu":
        out = torch.empty((x.shape[0] // w,) + tuple(x.shape[1:]),
                          dtype=x.dtype, pin_memory=True)
    out = _back(comm.reduce_scatter(_host(x), "sum", out), x)
    _count(axes, "psum_scatter", x, t0)
    return out


def _gather(x, mesh, axes):
    comm = mesh.comm(axes)
    if comm is None:
        return x.unsqueeze(0).clone()
    t0 = time.perf_counter()
    host = _host(x)
    out = None
    if x.device.type != "cpu":
        out = torch.empty((comm.world_size,) + tuple(x.shape), dtype=x.dtype,
                          pin_memory=True)
    out = _back(comm.all_gather(host, out), x)
    _count(axes, "all_gather", x, t0)
    return out


# -- the autograd Functions --------------------------------------------------


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.mesh, ctx.axes), None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, perm):
        ctx.mesh, ctx.axes, ctx.perm = mesh, axes, perm
        return _permute(x.contiguous(), mesh, axes, perm)

    @staticmethod
    def backward(ctx, g):
        inv = [0] * len(ctx.perm)
        for i, j in enumerate(ctx.perm):
            inv[j] = i
        return (_permute(g.contiguous(), ctx.mesh, ctx.axes, inv), None, None,
                None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, split_axis, concat_axis):
        ctx.args = (mesh, axes, split_axis, concat_axis)
        return _a2a(x, mesh, axes, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, split_axis, concat_axis = ctx.args
        return (_a2a(g.contiguous(), mesh, axes, concat_axis, split_axis),
                None, None, None, None)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, varying):
        ctx.my, ctx.args = mesh.axis_index(axes), (mesh, axes, varying)
        return _gather(x.contiguous(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, varying = ctx.args
        if varying:  # (group, *x.shape): the group dim is dim 0
            g = _reduce_scatter(g.contiguous(), mesh, axes)[0]
        else:
            g = g[ctx.my]
        return g, None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return _reduce_scatter(x.contiguous(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        blocks = _gather(g.contiguous(), mesh, axes)
        return blocks.reshape((-1,) + tuple(g.shape[1:])), None, None


class _Sink(torch.autograd.Function):
    """out, unchanged; the other inputs (collective outputs) get no
    gradient, but their nodes are reached, so their transposes run."""

    @staticmethod
    def forward(ctx, out, *tied):
        ctx.n = len(tied)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g,) + (None,) * ctx.n


def _recorded(x: torch.Tensor) -> torch.Tensor:
    """x as a collective's input: under grad mode a floating x that needs
    no gradient becomes a leaf that does, so that every rank records the
    collective's node (its transpose is collective too)."""
    if (torch.is_grad_enabled() and x.is_floating_point()
            and not x.requires_grad):
        return x.detach().requires_grad_()
    return x


def _taped(y: torch.Tensor) -> torch.Tensor:
    if _tapes and y.requires_grad:
        _tapes[-1].append(y)
    return y


def psum(x: torch.Tensor, axis_name, mesh: Mesh | None = None):
    """Sum over the axis (or tuple of axes) `axis_name` of the active
    mesh (or `mesh`); the gradient passes through unchanged."""
    mesh, axes = _resolve(axis_name, mesh)
    return _taped(_Psum.apply(_recorded(x), mesh, axes))


def pvary(x: torch.Tensor, axis_name, mesh: Mesh | None = None):
    """x itself, whose gradient is summed over the axis: the cast of an
    axis-invariant value that meets axis-varying ones."""
    mesh, axes = _resolve(axis_name, mesh)
    return _taped(_Pvary.apply(_recorded(x), mesh, axes))


def ppermute(x: torch.Tensor, axis_name, perm, mesh: Mesh | None = None):
    """``lax.ppermute``: `perm` pairs (source, destination) of axis
    indices (a tuple of axes is indexed in mesh order), a whole
    permutation."""
    mesh, axes = _resolve(axis_name, mesh)
    w = mesh.axis_size(axes)
    dst = list(range(w))
    for s, d in perm:
        dst[s] = d
    if sorted(dst) != list(range(w)):
        raise ValueError(f"ppermute: {perm} is not a permutation of {w}")
    return _taped(_Ppermute.apply(_recorded(x), mesh, axes, dst))


def all_to_all(x: torch.Tensor, axis_name, split_axis: int, concat_axis: int,
               tiled: bool = True, mesh: Mesh | None = None):
    """``lax.all_to_all(..., tiled=True)``: x's dim `split_axis` in axis-size
    chunks, chunk j to axis index j; the chunks received concatenated on
    `concat_axis` in axis order."""
    if not tiled:
        raise NotImplementedError("all_to_all: only tiled=True is ported")
    mesh, axes = _resolve(axis_name, mesh)
    return _taped(_AllToAll.apply(_recorded(x), mesh, axes,
                                  split_axis % x.dim(), concat_axis % x.dim()))


def all_gather(x: torch.Tensor, axis_name, axis: int = 0, tiled: bool = False,
               mesh: Mesh | None = None, varying: bool = False):
    """``lax.all_gather``: every rank's x along a new dim `axis` in axis
    order, or concatenated on dim `axis` with `tiled`. `varying`: the
    result feeds work that differs across the axis (each rank's own
    tokens), so the backward sums the ranks' cotangents (``psum_scatter``)
    instead of taking this rank's slice of an axis-invariant one."""
    mesh, axes = _resolve(axis_name, mesh)
    y = _taped(_AllGather.apply(_recorded(x), mesh, axes, varying))
    if tiled:
        return torch.cat(list(y.unbind(0)), dim=axis)
    return y.movedim(0, axis)


def psum_scatter(x: torch.Tensor, axis_name, scatter_dimension: int = 0,
                 tiled: bool = False, mesh: Mesh | None = None):
    """``lax.psum_scatter``: the sum over the axis, of which this rank
    keeps block `axis_index` of dim `scatter_dimension` (a dim of the
    axis' size, dropped, or with `tiled` any multiple of it, cut in equal
    blocks). The backward all-gathers the cotangent."""
    mesh, axes = _resolve(axis_name, mesh)
    dim = scatter_dimension % x.dim()
    w = mesh.axis_size(axes)
    if not tiled and x.shape[dim] != w:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} is "
                         f"not the axis size {w} (tiled=False)")
    y = _taped(_PsumScatter.apply(_recorded(x.movedim(dim, 0)), mesh, axes))
    y = y.movedim(0, dim)
    return y if tiled else y.squeeze(dim)


def axis_index(axis_name, mesh: Mesh | None = None) -> int:
    mesh = mesh if mesh is not None else active_mesh()
    return mesh.axis_index(axis_name)


def axis_size(axis_name, mesh: Mesh | None = None) -> int:
    mesh = mesh if mesh is not None else active_mesh()
    return mesh.axis_size(axis_name)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


def shard_map(fn, mesh: Mesh, in_specs, out_specs):
    """``jax.shard_map`` over local blocks: the returned function calls
    `fn` on the blocks it is given (each argument already this rank's
    block under its in_spec) with `mesh` active, and returns fn's blocks
    (under out_specs). Under grad mode every collective output of the call
    is tied to the outputs (module docstring)."""
    del in_specs, out_specs  # the blocks are the caller's, as the specs say

    def wrapped(*args):
        _tapes.append([])
        try:
            with mesh:
                out = fn(*args)
        finally:
            tape = _tapes.pop()
        if not tape:
            return out
        tied = [False]

        def sink(y):
            if (isinstance(y, torch.Tensor) and y.is_floating_point()
                    and not tied[0] and torch.is_grad_enabled()):
                tied[0] = True
                return _Sink.apply(y, *tape)
            return y

        return _tree_map(sink, out)

    return wrapped


def shard(x: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """This rank's block of the global tensor `x` under `spec` (a
    contiguous copy)."""
    return x[local_slices(P(*spec), x.shape, mesh)].contiguous()


def unshard(y: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """The global tensor whose blocks the ranks hold under `spec`: one
    all-gather over the spec's axes (differentiable), the blocks placed by
    their ranks' indices."""
    spec = P(*spec)
    sharded = [(d, _axes(a)) for d, a in enumerate(spec) if a is not None]
    if not sharded:
        return y
    axes = mesh.canonical(tuple(a for _, ax in sharded for a in ax))
    blocks = all_gather(y, axes, mesh=mesh)       # (group, *y.shape)
    by_index = {}
    for g, rank in enumerate(mesh.group(axes)):
        coords = dict(zip(mesh.axis_names,
                          (int(c) for c in np.argwhere(mesh.devices == rank)[0])))
        key = []
        for _, ax in sharded:
            i = 0
            for a in ax:
                i = i * mesh.shape[a] + coords[a]
            key.append(i)
        by_index[tuple(key)] = blocks[g]

    def place(level: int, prefix: tuple):
        if level == len(sharded):
            return by_index[prefix]
        d, ax = sharded[level]
        return torch.cat([place(level + 1, prefix + (i,))
                          for i in range(mesh.axis_size(ax))], dim=d)

    return place(0, ())
