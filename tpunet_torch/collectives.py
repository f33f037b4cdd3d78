"""Host-side collectives over the tpunet ring communicator.

The port of ``tpunet/collectives.py``: the algorithm layer above the native
transport, on host buffers. All ranks must call the same collectives in the
same order (MPI semantics). A buffer is a numpy array or a CPU torch
tensor; results come back as the same kind, C-contiguous, of the input
dtype. CUDA tensors are staged through pinned host memory by
``tpunet_torch.interop``.

Supported dtypes: float32, float64, bfloat16, int32, int64, uint8. numpy has
no bfloat16 without ``ml_dtypes`` (which the JAX package uses and the port
does not depend on), so bfloat16 is passed as a ``torch.bfloat16`` tensor: its
``data_ptr()`` goes to the native layer with dtype code 2. Ops: sum, prod,
min, max.

``all_to_all``/``all_to_all_typed``/``iall_to_all`` wait for the MoE slice
of the port and ``neighbor_exchange`` for the sequence-parallel slice.
"""

from __future__ import annotations

import ctypes
import os
from typing import Any

import numpy as np
import torch

from tpunet_torch import _native

_OPS = {"sum": 0, "prod": 1, "min": 2, "max": 3}
_NUMPY_CODES = {np.dtype(np.float32): 0, np.dtype(np.float64): 1,
                np.dtype(np.int32): 3, np.dtype(np.int64): 4,
                np.dtype(np.uint8): 5}
_TORCH_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
                torch.int32: 3, torch.int64: 4, torch.uint8: 5}


def _dtype_code(dt) -> int:
    """The native dtype code of a numpy dtype or a torch dtype."""
    if isinstance(dt, torch.dtype):
        code = _TORCH_CODES.get(dt)
    else:
        code = _NUMPY_CODES.get(np.dtype(dt))
    if code is None:
        raise TypeError(f"unsupported dtype for tpunet collectives: {dt} "
                        "(bfloat16 travels as a torch.bfloat16 tensor)")
    return code


class _Buf:
    """A C-contiguous host buffer (numpy array or CPU tensor) with what the
    native calls need: pointer, element count, byte count, dtype code."""

    def __init__(self, x: Any):
        if isinstance(x, torch.Tensor):
            if x.device.type != "cpu":
                raise ValueError(
                    f"Communicator takes host buffers, got a tensor on "
                    f"{x.device}; tpunet_torch.interop stages device tensors")
            self.obj = x.contiguous()
            self.code = _dtype_code(x.dtype)
            self.size = self.obj.numel()
            self.nbytes = self.size * self.obj.element_size()
            self.shape = tuple(self.obj.shape)
        else:
            arr = np.asarray(x)
            self.obj = arr if arr.flags.c_contiguous else np.ascontiguousarray(
                arr)
            self.code = _dtype_code(self.obj.dtype)
            self.size = self.obj.size
            self.nbytes = self.obj.nbytes
            self.shape = self.obj.shape

    @property
    def ptr(self):
        if not self.size:
            return None
        if isinstance(self.obj, torch.Tensor):
            return self.obj.data_ptr()
        return self.obj.ctypes.data

    def empty(self, shape=None):
        """A new buffer of this kind and dtype (default: this shape)."""
        shape = self.shape if shape is None else tuple(shape)
        if isinstance(self.obj, torch.Tensor):
            return _Buf(torch.empty(shape, dtype=self.obj.dtype))
        return _Buf(np.empty(shape, dtype=self.obj.dtype))


class AsyncResult:
    """Handle for a nonblocking collective. Pins the send/recv buffers until
    `wait()`: the native layer reads and writes them from its worker
    thread."""

    def __init__(self, comm: "Communicator", ticket: int, send, out):
        self._comm = comm
        self._ticket = ticket
        self._send = send  # keep alive until wait
        self._out = out

    def test(self) -> bool:
        """True iff the collective has completed (non-blocking)."""
        if self._send is None:  # already waited: the native ticket is gone
            return True
        done = ctypes.c_uint8(0)
        _native.check(self._comm._lib.tpunet_comm_ticket_test(
            self._comm._id, self._ticket, ctypes.byref(done)), "ticket_test")
        return bool(done.value)

    def wait(self):
        """Block until complete; returns the result buffer. Idempotent."""
        if self._send is not None:
            try:
                _native.check(self._comm._lib.tpunet_comm_ticket_wait(
                    self._comm._id, self._ticket), "ticket_wait")
            finally:
                # Error or not, the native job has reached completion (or
                # was dropped unstarted): release the pins.
                self._send = None
        return self._out

    def __del__(self):
        # Dropping an un-waited result must not free the buffers while the
        # native worker may still reduce into them: quiesce first. Raw
        # call, no check: __del__ must not raise.
        if getattr(self, "_send", None) is not None:
            try:
                self._comm._lib.tpunet_comm_ticket_wait(self._comm._id,
                                                        self._ticket)
            except Exception:  # noqa: BLE001 — interpreter teardown
                pass
            self._send = None


class Communicator:
    """Ring communicator; rank/world/coordinator default from env
    (TPUNET_RANK/RANK, TPUNET_WORLD_SIZE/WORLD_SIZE, TPUNET_COORDINATOR).

    wire_dtype ("f32"/"bf16"/"int8"; None defers to TPUNET_WIRE_DTYPE),
    algo ("auto"/"ring"/"rhd"/"tree"/"hier"; None defers to TPUNET_ALGO) and
    traffic_class ("latency"/"bulk"/"control"; None defers to
    TPUNET_TRAFFIC_CLASS) are negotiated at wiring: a disagreement between
    ranks raises a typed ``_native.NativeError`` on every rank. Collectives
    raise typed subclasses of ``_native.NativeError`` on failure."""

    def __init__(self, coordinator: str | None = None, rank: int | None = None,
                 world_size: int | None = None, wire_dtype: str | None = None,
                 algo: str | None = None, traffic_class: str | None = None):
        env = os.environ
        coordinator = coordinator or env.get("TPUNET_COORDINATOR",
                                             "127.0.0.1:29500")
        if rank is None:
            rank = int(env.get("TPUNET_RANK", env.get("RANK", "0")))
        if world_size is None:
            world_size = int(env.get("TPUNET_WORLD_SIZE",
                                     env.get("WORLD_SIZE", "1")))
        self._lib = _native.load()
        cid = ctypes.c_size_t(0)
        _native.check(self._lib.tpunet_comm_create_ex(
            coordinator.encode(), rank, world_size,
            (wire_dtype or "").encode(), (algo or "").encode(),
            (traffic_class or "").encode(), ctypes.byref(cid)),
            "comm_create")
        self._id = cid.value
        self.rank = rank
        self.world_size = world_size
        codec = ctypes.c_int32(0)
        _native.check(self._lib.tpunet_comm_wire_dtype(
            self._id, ctypes.byref(codec)), "comm_wire_dtype")
        #: Negotiated wire codec name, read back from the native layer.
        self.wire_dtype: str = {0: "f32", 1: "bf16", 2: "int8"}[codec.value]

    # -- collectives -------------------------------------------------------

    def all_reduce(self, arr: Any, op: str = "sum", inplace: bool = False):
        """AllReduce. inplace=True reduces into `arr` itself (a C-contiguous
        numpy array or CPU tensor), skipping the output buffer."""
        buf = _Buf(arr)
        if inplace and buf.obj is not arr:
            raise ValueError("inplace=True requires a C-contiguous buffer (a "
                             "staging copy would leave the caller's "
                             "unchanged)")
        out = buf if inplace else buf.empty()
        _native.check(self._lib.tpunet_comm_all_reduce(
            self._id, buf.ptr, out.ptr, buf.size, buf.code, _OPS[op]),
            "all_reduce")
        return out.obj

    def iall_reduce(self, arr: Any, op: str = "sum",
                    inplace: bool = False) -> AsyncResult:
        """Nonblocking AllReduce: returns at once with an AsyncResult whose
        `wait()` yields the reduced buffer. The reduction runs on the
        communicator's worker thread, which reads `arr` from the moment this
        returns; submission order across ranks must match."""
        buf = _Buf(arr)
        if inplace and buf.obj is not arr:
            raise ValueError("inplace=True requires a C-contiguous buffer")
        out = buf if inplace else buf.empty()
        ticket = ctypes.c_uint64(0)
        _native.check(self._lib.tpunet_comm_iall_reduce(
            self._id, buf.ptr, out.ptr, buf.size, buf.code, _OPS[op],
            ctypes.byref(ticket)), "iall_reduce")
        return AsyncResult(self, ticket.value, buf.obj, out.obj)

    def reduce_scatter(self, arr: Any, op: str = "sum"):
        """arr: leading axis divisible by world_size; returns this rank's
        reduced shard (shape[0] / world_size leading axis)."""
        buf = _Buf(arr)
        if buf.shape[0] % self.world_size:
            raise ValueError(f"leading axis {buf.shape[0]} not divisible by "
                             f"world size {self.world_size}")
        out = buf.empty((buf.shape[0] // self.world_size,) + buf.shape[1:])
        _native.check(self._lib.tpunet_comm_reduce_scatter(
            self._id, buf.ptr, out.ptr, out.size, buf.code, _OPS[op]),
            "reduce_scatter")
        return out.obj

    def all_gather(self, arr: Any):
        """Returns shape (world_size, *arr.shape), rank-ordered."""
        buf = _Buf(arr)
        out = buf.empty((self.world_size,) + tuple(buf.shape))
        _native.check(self._lib.tpunet_comm_all_gather(
            self._id, buf.ptr, out.ptr, buf.nbytes), "all_gather")
        return out.obj

    def broadcast(self, arr: Any, root: int = 0):
        """Returns root's buffer on every rank (a copy; `arr` is left as
        it was)."""
        src = _Buf(arr)
        out = src.empty()
        if isinstance(out.obj, torch.Tensor):
            out.obj.copy_(src.obj)
        else:
            out.obj[...] = src.obj
        _native.check(self._lib.tpunet_comm_broadcast(
            self._id, out.ptr, out.nbytes, root), "broadcast")
        return out.obj

    def all_to_all(self, arr: Any):
        raise NotImplementedError(
            "all_to_all belongs to the MoE slice of the port (ROADMAP A.5)")

    def all_to_all_typed(self, arr: Any):
        raise NotImplementedError(
            "all_to_all_typed belongs to the MoE slice of the port "
            "(ROADMAP A.5)")

    def iall_to_all(self, arr: Any):
        raise NotImplementedError(
            "iall_to_all belongs to the MoE slice of the port (ROADMAP A.5)")

    def neighbor_exchange(self, arr: Any):
        raise NotImplementedError(
            "neighbor_exchange belongs to the sequence-parallel slice of the "
            "port (ROADMAP A.6)")

    def barrier(self) -> None:
        _native.check(self._lib.tpunet_comm_barrier(self._id), "barrier")

    def close(self) -> None:
        if self._id:
            cid = ctypes.c_size_t(self._id)
            self._id = 0
            _native.check(self._lib.tpunet_comm_destroy(ctypes.byref(cid)),
                          "comm_destroy")

    def __enter__(self) -> "Communicator":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
