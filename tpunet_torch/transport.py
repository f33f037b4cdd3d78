"""Point-to-point transport over libtpunet.so, from numpy host buffers.

``Net`` is one native engine instance: listen/connect/accept rendezvous
through a 64-byte handle shipped out of band, then chunk-striped
isend/irecv over parallel TCP streams. Every in-flight request pins its
buffer until ``test()``/``wait()`` reports done, so the garbage collector
cannot free memory the native stream workers still read or write.

Device tensors never reach this layer: callers stage them to host memory
first (the serving tier ships KV blocks as f32 numpy rows), and
``reduce_into`` refuses a CUDA tensor rather than copy it. The module also
carries the native layer's socket-free goldens (``reduce_into``,
``lane_parse``, ``stripe_map``, ``qos_drr_golden``), the QoS scheduler's
parsed state, and the process-wide fault slot (``fault_inject`` /
``fault_clear``) that chaos runs and the churn script arm.
"""

from __future__ import annotations

import ctypes
import time
from typing import Any

import numpy as np
import torch

from tpunet_torch import _native

TRAFFIC_CLASSES = ("latency", "bulk", "control")
_CODECS = {"f32": 0, "bf16": 1, "int8": 2}
_REDUCE_DTYPES = {"f32": 0, "f64": 1, "bf16": 2, "i32": 3, "i64": 4, "u8": 5}
_REDUCE_OPS = {"sum": 0, "prod": 1, "min": 2, "max": 3}


def fault_inject(spec: str) -> None:
    """Arm a deterministic transport fault process-wide (chaos testing),
    in the native grammar, e.g. ``"stream=1:after_bytes=1M:action=close"``
    (close / stall / corrupt / delay=<ms>), or a churn script
    (``"churn:at_step=3:rank=1:action=kill"``). One fault at a time;
    re-arming replaces it and resets the byte counters and churn latches.
    A malformed spec raises NativeError (INVALID) naming the bad token. The
    env knob TPUNET_FAULT_SPEC arms the same slot at engine creation."""
    _native.check(_native.load().tpunet_c_fault_inject(spec.encode()),
                  "fault_inject")


def fault_clear() -> None:
    """Disarm any injected fault (safe to call when none is armed)."""
    _native.check(_native.load().tpunet_c_fault_clear(), "fault_clear")


def crc32c(data: Any, seed: int = 0) -> int:
    """CRC32C (Castagnoli) of a bytes-like object via the native library;
    chain calls by passing the previous value as ``seed``."""
    lib = _native.load()
    mv = memoryview(data)
    if not mv.c_contiguous:
        raise ValueError("crc32c needs a C-contiguous buffer")
    # Hashed in place (no copy of a weight-sized buffer).
    buf = np.frombuffer(mv.cast("B"), np.uint8) if mv.nbytes else None
    return int(lib.tpunet_c_crc32c(
        buf.ctypes.data if buf is not None else None, mv.nbytes,
        seed & 0xFFFFFFFF))


def _reduce_operand(name: str, x: Any, writable: bool) -> tuple[int, int]:
    """(address, element count) of a C-contiguous numpy array or CPU torch
    tensor; a CUDA tensor raises TypeError (it is never copied)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise TypeError(f"{name} is a tensor on {x.device}: reduce_into "
                            "takes host buffers (stage the tensor first)")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CPU tensor")
        return x.data_ptr(), x.numel()
    if not isinstance(x, np.ndarray) or not x.flags.c_contiguous:
        raise ValueError(f"{name} must be a C-contiguous numpy array or CPU "
                         "tensor")
    if writable and not x.flags.writeable:
        raise ValueError(f"{name} must be writable")
    return x.ctypes.data, x.size


def reduce_into(dst, a, b, dtype: str, op: str = "sum") -> None:
    """Elementwise ``dst = a op b`` with the native reduction kernel (SIMD
    where the CPU has it) that the ring collectives run after the wire.
    ``dst`` may be ``a`` itself (in-place accumulate). ``dtype`` is the
    wire dtype ("f32", "f64", "bf16", "i32", "i64", "u8"). Each operand is
    a C-contiguous numpy array (bf16 as a uint16 view) or a contiguous CPU
    torch tensor (bf16 as ``torch.bfloat16``); a CUDA tensor raises
    TypeError."""
    if dtype not in _REDUCE_DTYPES:
        raise ValueError(f"unknown reduce dtype {dtype!r}")
    if op not in _REDUCE_OPS:
        raise ValueError(f"unknown reduce op {op!r}")
    (pd, nd), (pa, na), (pb, nb) = (
        _reduce_operand("dst", dst, True), _reduce_operand("a", a, False),
        _reduce_operand("b", b, False))
    if not nd == na == nb:
        raise ValueError("dst/a/b element counts differ")
    _native.check(
        _native.load().tpunet_c_reduce(pd, pa, pb, nd, _REDUCE_DTYPES[dtype],
                                       _REDUCE_OPS[op]),
        "reduce")


def qos_state() -> dict:
    """Parsed view of the process QoS scheduler's config and live state:
    weights/budgets/admitted/queued ({class: int}), wire_window and
    wire_inflight (ints), so tests pin what ``TPUNET_QOS_WEIGHTS`` /
    ``TPUNET_QOS_INFLIGHT_BYTES`` parsed to."""
    buf = ctypes.create_string_buffer(4096)
    n = _native.load().tpunet_c_qos_state(buf, 4096)
    if n < 0:
        raise _native.NativeError(n, "qos_state")
    out: dict = {}
    for line in buf.value.decode().splitlines():
        parts = line.split()
        if not parts:
            continue
        if "=" in (parts[1] if len(parts) > 1 else ""):
            out[parts[0]] = {k: int(v) for k, v in
                             (kv.split("=") for kv in parts[1:])}
        elif len(parts) == 2:
            out[parts[0]] = int(parts[1])
    return out


def qos_drr_golden(weights: str, window: str, chunks: str) -> list[str]:
    """The exact wire-credit grant order the QoS scheduler's deficit round
    robin gives ``chunks`` ("class:bytes,...", queued in order) under
    ``weights`` (TPUNET_QOS_WEIGHTS grammar) and ``window``
    ("wire=<bytes>"). Pure arithmetic, no sockets. A malformed spec raises
    NativeError (INVALID) naming the token."""
    buf = ctypes.create_string_buffer(65536)
    n = _native.load().tpunet_c_qos_drr_golden(
        weights.encode(), window.encode(), chunks.encode(), buf, 65536)
    _native.check(min(n, 0), "qos_drr_golden")
    return buf.value.decode().split(",") if buf.value else []


def lane_parse(spec: str) -> list[dict]:
    """Parse a ``TPUNET_LANES`` spec with the native parser the engines use
    (``"addr=10.0.0.1:w=4,addr=10.0.1.1:w=1"``; either key may be left
    out): one ``{"lane", "addr", "w"}`` dict per lane, ``addr`` None for the
    default path. A malformed spec raises NativeError (INVALID) naming the
    token."""
    buf = ctypes.create_string_buffer(16384)
    n = _native.load().tpunet_c_lane_parse(spec.encode(), buf, 16384)
    _native.check(min(n, 0), "lane_parse")
    out = []
    for line in buf.value.decode().splitlines():
        kv = dict(tok.split("=", 1) for tok in line.split())
        out.append({"lane": int(kv["lane"]),
                    "addr": None if kv["addr"] == "-" else kv["addr"],
                    "w": int(kv["w"])})
    return out


def stripe_map(length: int, min_chunksize: int,
               weights: list[int] | tuple[int, ...],
               cursor: int = 0) -> list[int]:
    """The stream each chunk of a ``length``-byte message goes to under the
    weighted stripe scheduler, from the arithmetic both engines run, so a
    sender and a receiver derive one layout from (length, min_chunksize,
    weights) alone. Equal weights give the uniform rotation
    ``(cursor + i) % nstreams``."""
    lib = _native.load()
    wspec = ",".join(str(int(w)) for w in weights).encode()
    # Two calls: the text's length first, then the text (a dense map of a
    # long message is long).
    n = lib.tpunet_c_stripe_map(length, min_chunksize, wspec, cursor, None, 0)
    _native.check(min(n, 0), "stripe_map")
    buf = ctypes.create_string_buffer(n + 1)
    n = lib.tpunet_c_stripe_map(length, min_chunksize, wspec, cursor, buf,
                                n + 1)
    _native.check(min(n, 0), "stripe_map")
    return [int(t) for t in buf.value.decode().split(",")] if buf.value else []


def codec_wire_bytes(codec: str, n: int) -> int:
    """Encoded byte count of ``n`` f32 elements under ``codec`` (bf16: 2n;
    int8: n + 4*ceil(n/256) for the per-block f32 scales)."""
    if codec not in _CODECS:
        raise ValueError(f"unknown wire codec {codec!r}")
    return int(_native.load().tpunet_c_codec_wire_bytes(_CODECS[codec], n))


def codec_encode(arr: np.ndarray, codec: str) -> np.ndarray:
    """Encode a C-contiguous float32 array into its wire form (uint8) with
    the native codec kernel the compressed collectives run."""
    if codec not in _CODECS:
        raise ValueError(f"unknown wire codec {codec!r}")
    if (not isinstance(arr, np.ndarray) or arr.dtype != np.float32
            or not arr.flags.c_contiguous):
        raise ValueError("codec_encode needs a C-contiguous float32 array")
    lib = _native.load()
    out = np.empty(codec_wire_bytes(codec, arr.size), np.uint8)
    _native.check(
        lib.tpunet_c_codec_encode(_CODECS[codec], arr.ctypes.data, arr.size,
                                  out.ctypes.data if out.size else None,
                                  out.size),
        "codec_encode")
    return out


def codec_decode(wire: np.ndarray, codec: str, n: int) -> np.ndarray:
    """Decode a wire buffer of ``n`` encoded f32 elements back to float32."""
    if codec not in _CODECS:
        raise ValueError(f"unknown wire codec {codec!r}")
    wire = np.ascontiguousarray(wire, np.uint8)
    want = codec_wire_bytes(codec, n)
    if wire.size != want:
        raise ValueError(f"wire buffer is {wire.size}B but {codec} x {n} "
                         f"elements encodes to {want}B")
    lib = _native.load()
    out = np.empty(n, np.float32)
    _native.check(
        lib.tpunet_c_codec_decode(_CODECS[codec],
                                  wire.ctypes.data if wire.size else None, n,
                                  out.ctypes.data if out.size else None),
        "codec_decode")
    return out


def _as_buffer(obj: Any, writable: bool) -> tuple[int, int, Any]:
    """Return (address, nbytes, pin) for bytes/bytearray/numpy/memoryview."""
    if isinstance(obj, np.ndarray):
        if writable and not obj.flags.writeable:
            raise ValueError("recv buffer must be writable")
        if not obj.flags.c_contiguous:
            raise ValueError("buffer must be C-contiguous")
        return obj.ctypes.data, obj.nbytes, obj
    mv = memoryview(obj)
    if writable and mv.readonly:
        raise ValueError("recv buffer must be writable")
    if not mv.c_contiguous:
        raise ValueError("buffer must be C-contiguous")
    arr_t = ctypes.c_char * mv.nbytes
    c = arr_t.from_buffer_copy(mv) if mv.readonly else arr_t.from_buffer(mv)
    return ctypes.addressof(c), mv.nbytes, (c, mv)


class Request:
    """In-flight isend/irecv; poll with test(), or wait()."""

    def __init__(self, net: "Net", req_id: int, pin: Any):
        self._net = net
        self._id = req_id
        self._pin = pin  # keeps the buffer alive until done
        self._done = False
        self._nbytes = 0

    def test(self) -> tuple[bool, int]:
        if self._done:
            return True, self._nbytes
        done = ctypes.c_uint8(0)
        nbytes = ctypes.c_uint64(0)
        _native.check(
            self._net._lib.tpunet_c_test(self._net._id, self._id,
                                         ctypes.byref(done),
                                         ctypes.byref(nbytes)),
            "test")
        if done.value:
            self._done = True
            self._nbytes = nbytes.value
            self._pin = None
        return self._done, self._nbytes

    def wait(self, timeout: float | None = None) -> int:
        if self._done:
            return self._nbytes
        if timeout is None:
            # Blocking wait in native code: ctypes drops the GIL and the
            # condvar park costs no CPU.
            nbytes = ctypes.c_uint64(0)
            _native.check(
                self._net._lib.tpunet_c_wait(self._net._id, self._id,
                                             ctypes.byref(nbytes)),
                "wait")
            self._done = True
            self._nbytes = nbytes.value
            self._pin = None
            return self._nbytes
        deadline = time.monotonic() + timeout
        polls = 0
        while True:
            done, nbytes = self.test()
            if done:
                return nbytes
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"request {self._id} not done within {timeout}s")
            polls += 1
            if polls > 200:
                time.sleep(min(1e-3, 1e-5 * (polls - 200)))


class SendComm:
    def __init__(self, net: "Net", comm_id: int):
        self._net = net
        self._id = comm_id

    def isend(self, buf: Any) -> Request:
        addr, nbytes, pin = _as_buffer(buf, writable=False)
        req = ctypes.c_size_t(0)
        _native.check(
            self._net._lib.tpunet_c_isend(self._net._id, self._id, addr,
                                          nbytes, ctypes.byref(req)),
            "isend")
        return Request(self._net, req.value, pin)

    def send(self, buf: Any, timeout: float | None = None) -> int:
        return self.isend(buf).wait(timeout)

    def close(self) -> None:
        _native.check(
            self._net._lib.tpunet_c_close_send(self._net._id, self._id),
            "close_send")


class RecvComm:
    def __init__(self, net: "Net", comm_id: int):
        self._net = net
        self._id = comm_id

    def irecv(self, buf: Any) -> Request:
        addr, nbytes, pin = _as_buffer(buf, writable=True)
        req = ctypes.c_size_t(0)
        _native.check(
            self._net._lib.tpunet_c_irecv(self._net._id, self._id, addr,
                                          nbytes, ctypes.byref(req)),
            "irecv")
        return Request(self._net, req.value, pin)

    def recv(self, buf: Any, timeout: float | None = None) -> int:
        return self.irecv(buf).wait(timeout)

    def close(self) -> None:
        _native.check(
            self._net._lib.tpunet_c_close_recv(self._net._id, self._id),
            "close_recv")


class ListenComm:
    def __init__(self, net: "Net", comm_id: int, handle: bytes):
        self._net = net
        self._id = comm_id
        self.handle = handle  # 64-byte rendezvous blob, ship out of band

    def accept(self) -> RecvComm:
        rid = ctypes.c_size_t(0)
        _native.check(
            self._net._lib.tpunet_c_accept(self._net._id, self._id,
                                           ctypes.byref(rid)),
            "accept")
        return RecvComm(self._net, rid.value)

    def close(self) -> None:
        _native.check(
            self._net._lib.tpunet_c_close_listen(self._net._id, self._id),
            "close_listen")


class Net:
    """One transport engine instance. ``traffic_class`` ("latency" / "bulk"
    / "control") pins the QoS lane every comm this engine connects carries
    (the class rides the connect preamble; the far side adopts it). None
    defers to TPUNET_TRAFFIC_CLASS (default bulk)."""

    def __init__(self, traffic_class: str | None = None) -> None:
        if traffic_class is not None and traffic_class not in TRAFFIC_CLASSES:
            raise ValueError(f"traffic_class must be one of "
                             f"{TRAFFIC_CLASSES}, got {traffic_class!r}")
        self._lib = _native.load()
        inst = ctypes.c_size_t(0)
        _native.check(
            self._lib.tpunet_c_create_ex((traffic_class or "").encode(),
                                         ctypes.byref(inst)),
            "create")
        self._id = inst.value
        self.traffic_class = traffic_class

    def devices(self) -> int:
        n = ctypes.c_int32(0)
        _native.check(self._lib.tpunet_c_devices(self._id, ctypes.byref(n)),
                      "devices")
        return n.value

    def properties(self, dev: int = 0) -> dict:
        p = _native.NetProperties()
        _native.check(self._lib.tpunet_c_get_properties(self._id, dev,
                                                        ctypes.byref(p)),
                      "props")
        return {"name": (p.name or b"").decode(),
                "pci_path": (p.pci_path or b"").decode(),
                "guid": p.guid, "ptr_support": p.ptr_support,
                "speed_mbps": p.speed_mbps, "port": p.port,
                "max_comms": p.max_comms}

    def listen(self, dev: int = 0) -> ListenComm:
        h = _native.SocketHandle()
        lid = ctypes.c_size_t(0)
        _native.check(
            self._lib.tpunet_c_listen(self._id, dev, ctypes.byref(h),
                                      ctypes.byref(lid)),
            "listen")
        return ListenComm(self, lid.value, bytes(h.data))

    def connect(self, handle: bytes, dev: int = 0) -> SendComm:
        if len(handle) != _native.HANDLE_SIZE:
            raise ValueError(f"handle must be {_native.HANDLE_SIZE} bytes")
        h = _native.SocketHandle()
        ctypes.memmove(h.data, handle, _native.HANDLE_SIZE)
        sid = ctypes.c_size_t(0)
        _native.check(
            self._lib.tpunet_c_connect(self._id, dev, ctypes.byref(h),
                                       ctypes.byref(sid)),
            "connect")
        return SendComm(self, sid.value)

    def close(self) -> None:
        if self._id:
            inst = ctypes.c_size_t(self._id)
            self._id = 0
            _native.check(self._lib.tpunet_c_destroy(ctypes.byref(inst)),
                          "destroy")

    def __enter__(self) -> "Net":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
