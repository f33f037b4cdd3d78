"""Torch tensors <-> tpunet: cross-host (DCN) collectives in a training step.

The port of ``tpunet/interop.py``, under the same names, on torch tensors.
The JAX package enters jitted programs two ways: an XLA FFI custom call
(``cpp/src/xla_ffi.cc``) that hands XLA's buffers to the ring directly, and
an ``io_callback`` that stages device buffers through the host. The FFI
route is specific to XLA and has no torch counterpart; the port takes the
second one:

- a CPU tensor goes to the communicator as it is;
- a CUDA tensor is copied into pinned host memory, the copy is completed
  (the stream is synchronised) BEFORE the collective is submitted, because
  the native worker reads the host buffer from the moment ``iall_reduce``
  returns; the result is copied back to the tensor's device.

PyTorch runs eagerly, so collectives are ordered by program order on every
rank and the JAX package's ``after=`` ordering operands have no
counterpart. ``dcn_all_reduce(sum)`` is differentiable: the gradient of a
sum all-reduce is a sum all-reduce of the gradient. The other collectives
are not, as in the JAX package, where they are io_callback or FFI calls
with no VJP: their forward runs under grad mode, and a backward through
them raises instead of dropping their term from the gradient.
``dcn_reduce_stats()`` counts the blocking all-reduces and the host wall
time they took: in all, in the device-to-host staging, and in the
collective itself; and, under their own keys, the same for the
reduce-scatters and all-gathers (ZeRO's two halves of the all-reduce), the
all-to-alls and the neighbor exchanges (sequence parallelism's).

The DCN world is the world's processes, or, while a HOST mesh is active
(``with mesh:`` or ``shard_map`` over a mesh that is one host's ranks of a
world of several hosts, ``tpunet_torch.parallel.mesh``), that mesh's DCN
group: the ranks at this rank's coordinates in every host, the port's
counterpart of the JAX package's processes. Every ``dcn_*`` call then runs
over the group, `world` is the number of hosts, and the group's calls are
counted under the same keys. With no mesh active, or a mesh that spans the
world, they run over the world as before.

``hierarchical_psum`` with an axis sums over that axis of the active mesh
(``tpunet_torch.parallel.smap``), then across the hosts over the DCN group:
JAX's ``lax.psum`` over the axis, then its DCN all-reduce across processes.
"""

from __future__ import annotations

import time
from typing import Any

import torch

from tpunet_torch import distributed


def _host_mesh():
    """The active mesh when it is one host's ranks of several hosts, else
    None."""
    from tpunet_torch.parallel.mesh import _active

    return _active[-1] if _active and _active[-1].n_hosts > 1 else None


def _comm():
    """The DCN world's communicator: the active host mesh's DCN group, or
    the world's."""
    mesh = _host_mesh()
    return (mesh.dcn_comm() if mesh is not None
            else distributed.global_communicator())


def _world() -> int:
    """The DCN world's size: the hosts of an active host mesh, or the
    world's processes (raises if initialize() was skipped)."""
    mesh = _host_mesh()
    return mesh.n_hosts if mesh is not None else distributed.world_size()


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy of `x`, complete on return (pinned when `x`
    lies on the card); CPU tensors pass through."""
    if x.device.type == "cpu":
        return x.contiguous()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    torch.cuda.current_stream(x.device).synchronize()
    return host


def _to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "cpu":
        return host
    # The caching host allocator keeps the pinned block until this copy
    # has run, even once `host` is dropped.
    return host.to(device, non_blocking=True)


# -- all-reduce -------------------------------------------------------------

_ZERO_STATS = {"calls": 0, "bytes": 0, "seconds": 0.0, "to_host_seconds": 0.0,
               "collective_seconds": 0.0}
_reduce_stats = dict(_ZERO_STATS)
_other_stats = {name: dict(_ZERO_STATS) for name in (
    "reduce_scatter", "all_gather", "all_to_all", "neighbor_exchange")}


def dcn_reduce_stats() -> dict:
    """Blocking all-reduces since the last reset: calls, payload bytes
    (the input's) and host wall seconds: `seconds` in all (staging, the
    collective, queueing the copy back), `to_host_seconds` staging the
    input to host memory (finished), `collective_seconds` the native
    collective. The keys "reduce_scatter", "all_gather", "all_to_all"
    and "neighbor_exchange" hold the same five counts for those calls."""
    return dict(_reduce_stats,
                **{k: dict(v) for k, v in _other_stats.items()})


def dcn_reduce_stats_reset() -> None:
    _reduce_stats.update(_ZERO_STATS)
    for v in _other_stats.values():
        v.update(_ZERO_STATS)


def _staged(stats: dict, x: torch.Tensor, collective,
            out_shape: tuple | None = None) -> torch.Tensor:
    """Stage `x` to the host, run collective(host, out) and bring the
    result back to `x`'s device, counting the call and its times in
    `stats`. For a CUDA `x`, `out` is a pinned host buffer of `out_shape`
    (None: the collective allocates or works in place): the caching host
    allocator hands the same warm pages back every step, where a fresh
    pageable buffer would page-fault under the native collective's writes
    and make the copy back synchronous."""
    t0 = time.perf_counter()
    host = _to_host(x)
    out = None
    if out_shape is not None and x.device.type != "cpu":
        out = torch.empty(out_shape, dtype=x.dtype, pin_memory=True)
    t1 = time.perf_counter()
    out = collective(host, out)
    t2 = time.perf_counter()
    out = _to_device(out, x.device)
    stats["calls"] += 1
    stats["bytes"] += x.numel() * x.element_size()
    stats["to_host_seconds"] += t1 - t0
    stats["collective_seconds"] += t2 - t1
    stats["seconds"] += time.perf_counter() - t0
    return out


def _all_reduce_impl(x: torch.Tensor, op: str, comm) -> torch.Tensor:
    return _staged(_reduce_stats, x, lambda host, _: comm.all_reduce(
        host, op, inplace=host is not x))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op):
        if op != "sum" and ctx.needs_input_grad[0]:
            raise NotImplementedError(
                f"gradient of dcn_all_reduce only defined for sum, got {op}")
        # The backward runs over the forward's DCN world, whatever mesh is
        # active then.
        ctx.comm = _comm()
        return _all_reduce_impl(x, op, ctx.comm)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_impl(g.contiguous(), "sum", ctx.comm), None


def dcn_all_reduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """AllReduce `x` across all processes over the DCN transport."""
    return _AllReduce.apply(x, op)


def dcn_psum(x: torch.Tensor) -> torch.Tensor:
    """A sum across processes over DCN."""
    return dcn_all_reduce(x, "sum")


def dcn_pmean(x: torch.Tensor) -> torch.Tensor:
    """A mean across processes over DCN: the sum divided by the world."""
    return dcn_all_reduce(x, "sum") / _world()


def _all_reduce_into_(x: torch.Tensor, comm=None) -> torch.Tensor:
    """Sum-all-reduce the contiguous tensor `x` INTO ITS OWN MEMORY and
    return it: staged through pinned host memory, reduced there in place,
    copied back into `x`. No second device buffer exists, and there is no
    autograd. `comm`: another communicator than the global one (a mesh
    group's; default the DCN world's). Counted in dcn_reduce_stats() as
    the blocking all-reduce."""
    if not x.is_contiguous():
        raise ValueError("_all_reduce_into_ needs a contiguous tensor")

    def collective(host, _):
        (comm or _comm()).all_reduce(host, "sum", inplace=True)
        if host is not x:
            x.copy_(host, non_blocking=True)
        return x

    return _staged(_reduce_stats, x, collective)


# -- nonblocking all-reduce (gradient buckets) ------------------------------

# Outstanding (AsyncResult, device) keyed by (communicator identity, native
# ticket): two live communicators both count tickets from 1, so a
# ticket-only key could pair a finish with the wrong buffer.
# max_in_flight shows that buckets overlapped.
_async_pending: dict[tuple[int, int], Any] = {}
_async_stats = {"in_flight": 0, "max_in_flight": 0}


def _drop_pending_for(comm) -> int:
    """Forget every pending async op of `comm` (called by
    distributed.finalize before closing it)."""
    stale = [k for k in _async_pending if k[0] == id(comm)]
    for k in stale:
        del _async_pending[k]
        _async_stats["in_flight"] -= 1
    return len(stale)


def dcn_async_stats() -> dict[str, int]:
    """Snapshot of nonblocking-collective depth."""
    return dict(_async_stats)


def dcn_async_stats_reset() -> None:
    _async_stats["in_flight"] = 0
    _async_stats["max_in_flight"] = 0


def dcn_all_reduce_start(x: torch.Tensor, op: str = "sum") -> int:
    """Begin a nonblocking AllReduce of `x`; returns a ticket for
    `dcn_all_reduce_finish`. The reduction runs on the native worker thread
    while the caller goes on (the bucketed-gradient overlap primitive)."""
    c = _comm()
    res = c.iall_reduce(_to_host(x), op, inplace=x.device.type != "cpu")
    ticket = res._ticket & 0xFFFFFFFF
    # Only x's device is kept: x itself may be freed once it is staged.
    _async_pending[(id(c), ticket)] = (res, x.device)
    _async_stats["in_flight"] += 1
    _async_stats["max_in_flight"] = max(_async_stats["max_in_flight"],
                                        _async_stats["in_flight"])
    return ticket


def dcn_all_reduce_finish(ticket: int, like: torch.Tensor | None = None):
    """Complete the nonblocking AllReduce for `ticket`; returns the reduced
    tensor on the device (and of the dtype) of the tensor passed to the
    start call. `like` exists for parity with the JAX signature."""
    del like
    try:
        res, device = _async_pending.pop((id(_comm()), int(ticket)))
    except KeyError:
        raise RuntimeError(
            f"no pending async collective with ticket {ticket} on the "
            "current global communicator: dcn_all_reduce_finish without a "
            "matching start, or the communicator was re-initialized "
            "mid-flight") from None
    _async_stats["in_flight"] -= 1
    return _to_device(res.wait(), device)


# -- other collectives: no gradient ----------------------------------------


class _NoVjp(torch.autograd.Function):
    """A collective the JAX package cannot differentiate: the forward runs
    it, a backward through it raises."""

    @staticmethod
    def forward(ctx, x, name, run):
        ctx.name = name
        return run(x)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(
            f"{ctx.name} is not differentiable: in the JAX package it is an "
            "io_callback or XLA FFI call with no VJP, so jax.grad through it "
            "raises too. Only dcn_all_reduce has a gradient; detach the "
            "input or run under torch.no_grad()")


def dcn_all_gather(x: torch.Tensor) -> torch.Tensor:
    """Gather `x` from every process: result shape (world, *x.shape)."""
    return _NoVjp.apply(x, "dcn_all_gather", lambda t: _staged(
        _other_stats["all_gather"], t, _comm().all_gather,
        (_world(), *t.shape)))


def dcn_reduce_scatter(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """x: leading axis divisible by world; returns this process's reduced
    shard (shape[0]/world leading axis)."""
    w = _world()
    if x.shape[0] % w:
        raise ValueError(f"leading axis {x.shape[0]} not divisible by world "
                         f"size {w}")
    return _NoVjp.apply(x, "dcn_reduce_scatter", lambda t: _staged(
        _other_stats["reduce_scatter"], t,
        lambda host, out: _comm().reduce_scatter(host, op, out),
        (t.shape[0] // w, *t.shape[1:])))


def dcn_broadcast(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Root's `x` on every process."""
    return _NoVjp.apply(x, "dcn_broadcast", lambda t: _to_device(
        _comm().broadcast(_to_host(t), root), t.device))


def dcn_barrier() -> None:
    """Host-level barrier."""
    _comm().barrier()


def dcn_all_to_all(x: torch.Tensor) -> torch.Tensor:
    """AllToAll across processes: `x`'s leading axis is the world, block j
    goes to process j, and the result's block j came from process j
    (shape-preserving; raw bytes, any dtype). A CUDA tensor is staged
    through pinned host memory and the result comes back on its device."""
    w = _world()
    if x.dim() == 0 or x.shape[0] != w:
        raise ValueError(f"leading axis must equal world size {w}, got "
                         f"{tuple(x.shape)}")
    return _NoVjp.apply(x, "dcn_all_to_all", lambda t: _staged(
        _other_stats["all_to_all"], t,
        lambda host, _: _comm().all_to_all(host)))


def dcn_neighbor_exchange(x: torch.Tensor) -> torch.Tensor:
    """Send `x` to process (rank+1) % world and return the same-shaped
    message from process (rank-1+world) % world: the ring shift of ring
    attention across processes (raw bytes, any dtype). A CUDA tensor is
    staged through pinned host memory, the message received into a pinned
    buffer, and the result comes back on its device."""
    return _NoVjp.apply(x, "dcn_neighbor_exchange", lambda t: _staged(
        _other_stats["neighbor_exchange"], t,
        lambda host, out: _comm().neighbor_exchange(host, out), t.shape))


def hierarchical_psum(x: torch.Tensor, axis_name: str | None = None):
    """Two-tier psum. With `axis_name`: ``smap.psum`` over that axis of the
    active mesh (``with mesh:`` or ``shard_map``), then a sum all-reduce
    across the hosts over the mesh's DCN group, and nothing else: JAX's
    ``lax.psum`` over the axis, then its DCN all-reduce across processes.
    A mesh that spans the world is one host, where this is the psum alone.
    Without it: a sum all-reduce across the DCN world when it has more
    than one member (``world_size()`` raises if ``initialize()`` was
    skipped, as the JAX version does, which bakes the decision in at
    trace time)."""
    if axis_name is not None:
        from tpunet_torch.parallel import smap
        from tpunet_torch.parallel.mesh import active_mesh

        mesh = active_mesh()
        x = smap.psum(x, axis_name, mesh=mesh)
        if mesh.n_hosts == 1:
            return x
        with mesh:
            return dcn_all_reduce(x, "sum")
    if _world() > 1:
        x = dcn_all_reduce(x, "sum")
    return x
