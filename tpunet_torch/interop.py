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
sum all-reduce is a sum all-reduce of the gradient. ``dcn_reduce_stats()``
counts the blocking all-reduces and the host wall time they took: in all,
in the device-to-host staging, and in the collective itself.
"""

from __future__ import annotations

import time
from typing import Any

import torch

from tpunet_torch import distributed


def _comm():
    return distributed.global_communicator()


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy of `x`, complete on return (pinned when `x`
    lies on the card); CPU tensors pass through."""
    if x.device.type == "cpu":
        return x.contiguous()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    torch.cuda.current_stream(x.device).synchronize()
    return host


def _to_device(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.device.type == "cpu":
        return host
    # The caching host allocator keeps the pinned block until this copy
    # has run, even once `host` is dropped.
    return host.to(like.device, non_blocking=True)


# -- all-reduce -------------------------------------------------------------

_ZERO_STATS = {"calls": 0, "bytes": 0, "seconds": 0.0, "to_host_seconds": 0.0,
               "collective_seconds": 0.0}
_reduce_stats = dict(_ZERO_STATS)


def dcn_reduce_stats() -> dict:
    """Blocking all-reduces since the last reset: calls, payload bytes and
    host wall seconds: `seconds` in all (staging, the collective, queueing
    the copy back), `to_host_seconds` staging the input to host memory
    (finished), `collective_seconds` the native all-reduce."""
    return dict(_reduce_stats)


def dcn_reduce_stats_reset() -> None:
    _reduce_stats.update(_ZERO_STATS)


def _all_reduce_impl(x: torch.Tensor, op: str) -> torch.Tensor:
    t0 = time.perf_counter()
    host = _to_host(x)
    t1 = time.perf_counter()
    out = _comm().all_reduce(host, op, inplace=host is not x)
    t2 = time.perf_counter()
    out = _to_device(out, x)
    _reduce_stats["calls"] += 1
    _reduce_stats["bytes"] += x.numel() * x.element_size()
    _reduce_stats["to_host_seconds"] += t1 - t0
    _reduce_stats["collective_seconds"] += t2 - t1
    _reduce_stats["seconds"] += time.perf_counter() - t0
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op):
        if op != "sum" and ctx.needs_input_grad[0]:
            raise NotImplementedError(
                f"gradient of dcn_all_reduce only defined for sum, got {op}")
        return _all_reduce_impl(x, op)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_impl(g.contiguous(), "sum"), None


def dcn_all_reduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """AllReduce `x` across all processes over the DCN transport."""
    return _AllReduce.apply(x, op)


def dcn_psum(x: torch.Tensor) -> torch.Tensor:
    """A sum across processes over DCN."""
    return dcn_all_reduce(x, "sum")


def dcn_pmean(x: torch.Tensor) -> torch.Tensor:
    """A mean across processes over DCN: the sum divided by the world."""
    return dcn_all_reduce(x, "sum") / distributed.world_size()


# -- nonblocking all-reduce (gradient buckets) ------------------------------

# Outstanding (AsyncResult, like) keyed by (communicator identity, native
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
    _async_pending[(id(c), ticket)] = (res, x)
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
        res, x = _async_pending.pop((id(_comm()), int(ticket)))
    except KeyError:
        raise RuntimeError(
            f"no pending async collective with ticket {ticket} on the "
            "current global communicator: dcn_all_reduce_finish without a "
            "matching start, or the communicator was re-initialized "
            "mid-flight") from None
    _async_stats["in_flight"] -= 1
    return _to_device(res.wait(), x)


# -- other collectives ------------------------------------------------------


def dcn_all_gather(x: torch.Tensor) -> torch.Tensor:
    """Gather `x` from every process: result shape (world, *x.shape)."""
    return _to_device(_comm().all_gather(_to_host(x)), x)


def dcn_reduce_scatter(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """x: leading axis divisible by world; returns this process's reduced
    shard (shape[0]/world leading axis)."""
    w = distributed.world_size()
    if x.shape[0] % w:
        raise ValueError(f"leading axis {x.shape[0]} not divisible by world "
                         f"size {w}")
    return _to_device(_comm().reduce_scatter(_to_host(x), op), x)


def dcn_broadcast(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    return _to_device(_comm().broadcast(_to_host(x), root), x)


def dcn_barrier() -> None:
    """Host-level barrier."""
    _comm().barrier()


def dcn_all_to_all(x: torch.Tensor) -> torch.Tensor:
    raise NotImplementedError(
        "dcn_all_to_all belongs to the MoE slice of the port (ROADMAP A.5)")


def dcn_neighbor_exchange(x: torch.Tensor) -> torch.Tensor:
    raise NotImplementedError(
        "dcn_neighbor_exchange belongs to the sequence-parallel slice of the "
        "port (ROADMAP A.6)")


def hierarchical_psum(x: torch.Tensor, axis_name: str | None = None):
    raise NotImplementedError(
        "hierarchical_psum (an ICI psum, then the DCN all-reduce) belongs to "
        "a later training slice of the port (ROADMAP A.1)")
