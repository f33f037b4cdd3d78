"""Pipeline parallelism: the GPipe microbatch schedule over a `pp` mesh
axis.

The port of ``tpunet/parallel/pipeline.py``. Stage s holds the parameters
of its layer slice (the stacked leading dim, sharded over `pp`); M + W - 1
ticks run, every stage applies its stage function to one microbatch a
tick, and activations hop to the next stage by ``ppermute``. The last
stage's outputs are summed over the axis (zeros elsewhere), so every stage
returns them. Autograd runs through the ticks, so the same schedule serves
forward and backward (the backward pipeline runs in reverse).

One difference from JAX, where every tick of a stage computes and the
bubbles' results are masked out: a stage computes only on its own M ticks
(the fill and drain bubbles send zeros), so each stage runs its stage
function M times, not M + W - 1. The results are the same.

Constraint: every stage maps (microbatch, ...) -> the same shape and dtype
(true for stacks of identical transformer blocks).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from tpunet_torch.parallel.mesh import P
from tpunet_torch.parallel.smap import (_leaves, _tree_map, axis_index,
                                        axis_size, ppermute, psum, pvary,
                                        shard_map)


def stack_stage_params(param_trees):
    """Stack per-stage param trees (dicts, lists or tuples of tensors)
    along a new leading dim (the `pp` axis)."""
    first = param_trees[0]
    if isinstance(first, dict):
        return type(first)((k, stack_stage_params([t[k] for t in param_trees]))
                           for k in first)
    if isinstance(first, (list, tuple)):
        return type(first)(stack_stage_params([t[i] for t in param_trees])
                           for i in range(len(first)))
    return torch.stack(param_trees)


def gpipe_stage_loop(stage_fn, stage_params, xs, axis_name: str,
                     dp_axis: str | None = None):
    """Per-stage GPipe schedule; call inside ``shard_map``.

    stage_fn: (params, x) -> y with y.shape == x.shape. stage_params: this
    stage's params, leaves with leading dim 1 (squeezed here). xs: (M, mb,
    ...) microbatched input, replicated across the pp axis. Returns (M,
    mb, ...) outputs on every stage. `dp_axis`: the axis that shards the
    microbatch rows, over which the stage params are replicated (their
    gradient is summed over it, the cast JAX inserts)."""
    w, idx = axis_size(axis_name), axis_index(axis_name)
    params = _tree_map(lambda a: a[0], stage_params)
    if dp_axis is not None:
        params = _tree_map(lambda a: pvary(a, dp_axis), params)
    # xs is read by stage 0 only: JAX casts it varying over pp, so its
    # gradient is summed over the stages.
    xs = pvary(xs, axis_name)
    m = xs.shape[0]
    ring = [(i, (i + 1) % w) for i in range(w)]
    recv = None
    outs = []
    for t in range(m + w - 1):
        mb = t - idx  # the microbatch this stage holds at tick t
        if 0 <= mb < m:
            y = stage_fn(params, xs[t] if idx == 0 else recv)
            if idx == w - 1:
                outs.append(y)
        else:  # a fill or drain bubble: nothing to compute
            y = xs.new_zeros(xs.shape[1:])
        if t + 1 < m + w - 1:
            recv = ppermute(y, axis_name, ring)
    out = torch.stack(outs) if idx == w - 1 else xs.new_zeros(xs.shape)
    return psum(out, axis_name)


def gpipe(stage_fn, stacked_params, x, mesh, num_microbatches: int,
          pp_axis: str = "pp", dp_axis: str | None = None,
          remat_stages: bool = False):
    """The entry point over a mesh, JAX's signature, on THIS RANK'S blocks:
    stacked_params has a leading stage dim of 1 (this stage's slice of the
    W = mesh.shape[pp_axis] stages of ``stack_stage_params``); x is this
    rank's block of the (num_microbatches, mb, ...) microbatched input,
    flattened to (num_microbatches * mb_local, ...): the whole input
    without `dp_axis`; with it, each microbatch's rows sharded over that
    axis (``smap.shard(x.reshape(M, mb, ...), mesh, P(None, dp_axis))``).
    Returns the output block of the same shape, on every stage.

    remat_stages: checkpoint the stage function, so the backward recomputes
    each tick's internal activations from its input instead of keeping
    them."""
    w = mesh.shape[pp_axis]
    for leaf in _leaves(stacked_params):
        if leaf.shape[0] != 1:
            raise ValueError(
                f"stacked param leading dim {leaf.shape[0]} is not this "
                f"stage's slice (1) of the pp axis size {w}")
    if x.shape[0] % num_microbatches:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"{num_microbatches} microbatches")
    xs = x.reshape((num_microbatches, x.shape[0] // num_microbatches)
                   + tuple(x.shape[1:]))
    fn = stage_fn
    if remat_stages:
        def fn(p, y):
            return checkpoint(stage_fn, p, y, use_reentrant=False)

    data = P(None, dp_axis)
    loop = shard_map(
        lambda p, a: gpipe_stage_loop(fn, p, a, pp_axis, dp_axis),
        mesh=mesh, in_specs=(P(pp_axis), data), out_specs=data)
    ys = loop(stacked_params, xs)
    return ys.reshape(x.shape)
