"""Host-side collectives over the tpunet ring communicator.

The port of ``tpunet/collectives.py``: the algorithm layer above the native
transport, on host buffers. All ranks must call the same collectives in the
same order (MPI semantics). A buffer is a numpy array or a CPU torch
tensor; results come back as the same kind, C-contiguous, of the input
dtype. CUDA tensors are staged through pinned host memory by
``tpunet_torch.interop``.

The reductions take float32, float64, bfloat16, int32, int64 and uint8.
numpy has no bfloat16 without ``ml_dtypes`` (which the JAX package uses and
the port does not depend on), so bfloat16 is passed as a ``torch.bfloat16``
tensor: its ``data_ptr()`` goes to the native layer with dtype code 2. Ops:
sum, prod, min, max. ``all_gather``, ``broadcast``, ``all_to_all`` and
``iall_to_all`` move raw bytes, so they take any dtype;
``all_to_all_typed`` takes the reductions' dtypes and compresses float32
blocks on a bf16 or int8 wire. ``neighbor_exchange``, the ring shift of
sequence parallelism, moves raw bytes too.
"""

from __future__ import annotations

import ctypes
import os
from typing import Any

import numpy as np
import torch

from tpunet_torch import _native

_OPS = {"sum": 0, "prod": 1, "min": 2, "max": 3}

# The native tree and ring broadcasts cut a call into 1 MiB pieces
# (cpp/src/coll_comm.h kBcastChunk). The root posts every piece of a call
# at once, spread round-robin over the data streams, while a receiver posts
# them one at a time. Under an armed QoS wire window
# (TPUNET_QOS_INFLIGHT_BYTES wire=...), a stream writer keeps its wire
# credit through a blocking write. A later piece that fills a socket the
# receiver has not posted to yet then holds the credit the earlier,
# awaited piece needs, and both ends park until the progress watchdog
# fails the broadcast (ROADMAP C.12). So ``Communicator.broadcast`` makes
# one native call a piece: one message in flight on each edge, and the wire
# carries the same 1 MiB messages either way, so a JAX peer on the other
# end sees no difference.
BCAST_PIECE = 1 << 20
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
    native calls need: pointer, element count, byte count and, for a
    reduction (`typed`), the dtype code; the byte-moving collectives take
    any dtype."""

    def __init__(self, x: Any, typed: bool = True):
        if isinstance(x, torch.Tensor):
            if x.device.type != "cpu":
                raise ValueError(
                    f"Communicator takes host buffers, got a tensor on "
                    f"{x.device}; tpunet_torch.interop stages device tensors")
            self.obj = x.contiguous()
            self.size = self.obj.numel()
            self.nbytes = self.size * self.obj.element_size()
            self.shape = tuple(self.obj.shape)
        else:
            arr = np.asarray(x)
            self.obj = arr if arr.flags.c_contiguous else np.ascontiguousarray(
                arr)
            self.size = self.obj.size
            self.nbytes = self.obj.nbytes
            self.shape = self.obj.shape
        self.dtype = self.obj.dtype
        self.code = _dtype_code(self.dtype) if typed else None

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
        typed = self.code is not None
        if isinstance(self.obj, torch.Tensor):
            return _Buf(torch.empty(shape, dtype=self.dtype), typed)
        return _Buf(np.empty(shape, dtype=self.dtype), typed)


def _out_buf(like: _Buf, shape: tuple, out: Any) -> _Buf:
    """The output buffer of a collective: `out` itself, checked to be a
    C-contiguous buffer of `shape` and `like`'s dtype, or a new one."""
    if out is None:
        return like.empty(shape)
    buf = _Buf(out, typed=False)
    if buf.obj is not out or buf.shape != tuple(shape) or (
            buf.dtype != like.dtype):
        raise ValueError(f"out must be a C-contiguous buffer of shape "
                         f"{tuple(shape)} and the input's dtype")
    return buf


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
        #: The algorithm and traffic class asked for (None: the env's), so
        #: that a communicator derived from this one can ask for the same.
        self.algo = algo
        self.traffic_class = traffic_class
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

    def reduce_scatter(self, arr: Any, op: str = "sum", out: Any = None):
        """arr: leading axis divisible by world_size; returns this rank's
        reduced shard (shape[0] / world_size leading axis), written into
        `out` when given (a C-contiguous buffer of that shape and dtype)."""
        buf = _Buf(arr)
        if buf.shape[0] % self.world_size:
            raise ValueError(f"leading axis {buf.shape[0]} not divisible by "
                             f"world size {self.world_size}")
        out = _out_buf(buf, (buf.shape[0] // self.world_size,)
                       + tuple(buf.shape[1:]), out)
        _native.check(self._lib.tpunet_comm_reduce_scatter(
            self._id, buf.ptr, out.ptr, out.size, buf.code, _OPS[op]),
            "reduce_scatter")
        return out.obj

    def all_gather(self, arr: Any, out: Any = None):
        """Returns shape (world_size, *arr.shape), rank-ordered, written
        into `out` when given (a C-contiguous buffer of that shape and
        dtype). Moves raw bytes: any dtype."""
        buf = _Buf(arr, typed=False)
        out = _out_buf(buf, (self.world_size,) + tuple(buf.shape), out)
        _native.check(self._lib.tpunet_comm_all_gather(
            self._id, buf.ptr, out.ptr, buf.nbytes), "all_gather")
        return out.obj

    def broadcast(self, arr: Any, root: int = 0, out: Any = None):
        """Returns root's buffer on every rank: a copy, `arr` left as it
        was, or written into `out` when given (a C-contiguous buffer of
        arr's shape and dtype; `out` may be `arr` itself). Moves raw bytes:
        any dtype, one native call a BCAST_PIECE (an empty buffer, one
        empty call)."""
        src = _Buf(arr, typed=False)
        out = _out_buf(src, src.shape, out)
        if out.obj is not src.obj:
            if isinstance(out.obj, torch.Tensor):
                out.obj.copy_(src.obj)
            else:
                out.obj[...] = src.obj
        for lo in range(0, max(out.nbytes, 1), BCAST_PIECE):
            n = min(BCAST_PIECE, out.nbytes - lo)
            _native.check(self._lib.tpunet_comm_broadcast(
                self._id, out.ptr + lo if n else out.ptr, n, root),
                "broadcast")
        return out.obj

    def _a2a_bufs(self, arr: Any, typed: bool) -> tuple[_Buf, _Buf]:
        """(send, recv) buffers of an all-to-all: `arr`'s leading axis is
        the world, block j bound for rank j."""
        buf = _Buf(arr, typed)
        if not buf.shape or buf.shape[0] != self.world_size:
            lead = buf.shape[0] if buf.shape else None
            raise ValueError(f"leading axis {lead} must equal world size "
                             f"{self.world_size}")
        return buf, buf.empty()

    def all_to_all(self, arr: Any):
        """arr: leading axis == world_size, block j destined for rank j.
        Returns the same shape with block j originating at rank j (the
        cross-host MoE dispatch and Ulysses primitive). Moves raw bytes:
        any dtype."""
        buf, out = self._a2a_bufs(arr, typed=False)
        _native.check(self._lib.tpunet_comm_all_to_all(
            self._id, buf.ptr, out.ptr, buf.nbytes // self.world_size),
            "all_to_all")
        return out.obj

    def all_to_all_typed(self, arr: Any):
        """Typed AllToAll: like `all_to_all`, but blocks count ELEMENTS of
        the array's dtype (the reductions' dtypes), and float32 blocks
        honour the negotiated wire codec (``wire_dtype="bf16"``/"int8"):
        every non-self block is encoded once at the source (int8 scale
        blocks restart per (src, dst) block) and decoded once at the
        destination; the self block arrives exact. The MoE
        dispatch/combine primitive (``tpunet_torch.workloads.moe``)."""
        buf, out = self._a2a_bufs(arr, typed=True)
        _native.check(self._lib.tpunet_comm_all_to_all_typed(
            self._id, buf.ptr, out.ptr, buf.size // self.world_size,
            buf.code), "all_to_all_typed")
        return out.obj

    def iall_to_all(self, arr: Any) -> AsyncResult:
        """Nonblocking byte AllToAll: returns at once with an AsyncResult
        whose `wait()` yields the result. Mesh-routed schedules run on the
        communicator's mesh worker, so it overlaps an async all-reduce;
        submission order across ranks must match, as for iall_reduce."""
        buf, out = self._a2a_bufs(arr, typed=False)
        ticket = ctypes.c_uint64(0)
        _native.check(self._lib.tpunet_comm_iall_to_all(
            self._id, buf.ptr, out.ptr, buf.nbytes // self.world_size,
            ctypes.byref(ticket)), "iall_to_all")
        return AsyncResult(self, ticket.value, buf.obj, out.obj)

    def neighbor_exchange(self, arr: Any, out: Any = None):
        """Send `arr` to rank (rank+1) % W and return the same-shaped
        message from rank (rank-1+W) % W: the ring shift of sequence
        parallelism, written into `out` when given (a C-contiguous buffer
        of arr's shape and dtype). Moves raw bytes: any dtype. A message of
        another size than `arr`'s raises RuntimeError."""
        buf = _Buf(arr, typed=False)
        out = _out_buf(buf, buf.shape, out)
        got = ctypes.c_uint64(0)
        _native.check(self._lib.tpunet_comm_neighbor_exchange(
            self._id, buf.ptr, buf.nbytes, out.ptr, out.nbytes,
            ctypes.byref(got)), "neighbor_exchange")
        if got.value != buf.nbytes:
            raise RuntimeError(f"neighbor_exchange size mismatch: sent "
                               f"{buf.nbytes}, got {got.value}")
        return out.obj

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
