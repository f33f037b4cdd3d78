"""Loader + ctypes signatures for libtpunet.so, the native transport core.

The PyTorch port's own binding to the same C ABI (``cpp/include/tpunet``)
the JAX package binds: it builds the library on demand with
``make -C cpp build/libtpunet.so`` under the SAME ``cpp/.build.lock`` as the
JAX package's loader, so concurrent test processes of either package never
race one build. Only the shared object is built (not the C++ test
binaries), which keeps first-use set-up short.

Argtypes are set only for the symbols the port calls. Two bindings in one
process load the same handle (dlopen dedupes by path), so native singletons
(metrics, fault slot and churn latches, QoS scheduler, flight recorder,
tracer directory, host id) are shared between them.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from pathlib import Path

_REPO_ROOT = Path(__file__).resolve().parent.parent
_CPP_DIR = _REPO_ROOT / "cpp"
_LIB_PATH = _CPP_DIR / "build" / "libtpunet.so"

TPUNET_OK = 0
TPUNET_ERR_NULL = -1
TPUNET_ERR_INVALID = -2
TPUNET_ERR_INNER = -3
TPUNET_ERR_CORRUPT = -4        # per-chunk CRC32C mismatch (TPUNET_CRC=1)
TPUNET_ERR_TIMEOUT = -5        # progress watchdog (TPUNET_PROGRESS_TIMEOUT_MS)
TPUNET_ERR_VERSION = -6        # wire-framing version mismatch with the peer
TPUNET_ERR_CODEC = -7          # ranks disagree on the collective wire codec
TPUNET_ERR_QOS_ADMISSION = -8  # QoS class in-flight budget full (retryable)
TPUNET_ERR_REWIRE = -9         # elastic rewire exceeded its deadline
TPUNET_ERR_WEIGHT_SWAP = -10   # live weight publication aborted

HANDLE_SIZE = 64


class SocketHandle(ctypes.Structure):
    _fields_ = [("data", ctypes.c_uint8 * HANDLE_SIZE)]


class NetProperties(ctypes.Structure):
    _fields_ = [
        ("name", ctypes.c_char_p),
        ("pci_path", ctypes.c_char_p),
        ("guid", ctypes.c_uint64),
        ("ptr_support", ctypes.c_int32),
        ("speed_mbps", ctypes.c_int32),
        ("port", ctypes.c_int32),
        ("max_comms", ctypes.c_int32),
    ]


def _sources_mtime() -> float:
    newest = 0.0
    for sub in ("src", "include/tpunet", "tests"):
        d = _CPP_DIR / sub
        if d.is_dir():
            for f in d.rglob("*"):
                if f.suffix in (".cc", ".h"):
                    newest = max(newest, f.stat().st_mtime)
    mk = _CPP_DIR / "Makefile"
    if mk.exists():
        newest = max(newest, mk.stat().st_mtime)
    return newest


def build_native(force: bool = False) -> Path:
    """Build libtpunet.so if missing or stale. Safe across processes and
    across the two packages (one lock file)."""
    lock_path = _CPP_DIR / ".build.lock"
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            stale = (force or not _LIB_PATH.exists()
                     or _LIB_PATH.stat().st_mtime < _sources_mtime())
            if stale:
                jobs = str(max(1, min(8, os.cpu_count() or 1)))
                # src/ncclnet_shim.cc calls vsnprintf without <cstdio>,
                # which newer libstdc++ (gcc 13) no longer pulls in
                # transitively: force the header into every unit.
                subprocess.run(
                    ["make", "-C", str(_CPP_DIR), "-j", jobs,
                     "INCLUDES=-Iinclude -include cstdio",
                     "build/libtpunet.so"],
                    check=True, capture_output=True, text=True)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(
                f"native build failed:\n{e.stdout}\n{e.stderr}") from e
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return _LIB_PATH


_lib: ctypes.CDLL | None = None


def load() -> ctypes.CDLL:
    """Load (building if needed) and memoize the native library."""
    global _lib
    if _lib is not None:
        return _lib
    path = os.environ.get("TPUNET_LIBRARY_PATH", "")
    lib = ctypes.CDLL(str(Path(path) if path else build_native()))

    u = ctypes.c_uintptr if hasattr(ctypes, "c_uintptr") else ctypes.c_size_t
    i32, u8, u64 = ctypes.c_int32, ctypes.c_uint8, ctypes.c_uint64
    P = ctypes.POINTER
    vp = ctypes.c_void_p
    cp = ctypes.c_char_p

    sigs = {
        "tpunet_c_create_ex": ([ctypes.c_char_p, P(u)], i32),
        "tpunet_c_destroy": ([P(u)], i32),
        "tpunet_c_devices": ([u, P(i32)], i32),
        "tpunet_c_get_properties": ([u, i32, P(NetProperties)], i32),
        "tpunet_c_listen": ([u, i32, P(SocketHandle), P(u)], i32),
        "tpunet_c_connect": ([u, i32, P(SocketHandle), P(u)], i32),
        "tpunet_c_accept": ([u, u, P(u)], i32),
        "tpunet_c_isend": ([u, u, vp, u64, P(u)], i32),
        "tpunet_c_irecv": ([u, u, vp, u64, P(u)], i32),
        "tpunet_c_test": ([u, u, P(u8), P(u64)], i32),
        "tpunet_c_wait": ([u, u, P(u64)], i32),
        "tpunet_c_close_send": ([u, u], i32),
        "tpunet_c_close_recv": ([u, u], i32),
        "tpunet_c_close_listen": ([u, u], i32),
        "tpunet_c_last_error": ([], ctypes.c_char_p),
        "tpunet_c_metrics_text": ([ctypes.c_char_p, u64], i32),
        "tpunet_c_metrics_reset": ([], i32),
        "tpunet_c_serve_observe": ([i32, u64], i32),
        "tpunet_c_serve_queue_depth": ([i32, u64], i32),
        "tpunet_c_churn_event": ([i32], i32),
        "tpunet_c_trace_flush": ([], i32),
        "tpunet_c_trace_set_dir": ([cp], i32),
        "tpunet_c_metrics_port": ([], i32),
        "tpunet_c_qos_state": ([cp, u64], i32),
        "tpunet_c_lane_parse": ([cp, cp, u64], i32),
        "tpunet_c_stripe_map": ([u64, u64, cp, u64, cp, u64], i32),
        "tpunet_c_qos_drr_golden": ([cp, cp, cp, cp, u64], i32),
        "tpunet_c_fault_inject": ([cp], i32),
        "tpunet_c_fault_clear": ([], i32),
        "tpunet_c_churn_poll": ([u64, ctypes.c_int64], i32),
        "tpunet_c_churn_pending": ([], i32),
        "tpunet_c_swap_poll": ([u64], i32),
        "tpunet_c_swap_pending": ([], i32),
        "tpunet_c_rewire_observe": ([i32, u64], i32),
        "tpunet_c_world_size": ([u64], i32),
        "tpunet_c_swap_observe": ([i32, u64], i32),
        "tpunet_c_swap_event": ([i32], i32),
        "tpunet_c_flightrec_dump": ([cp, cp, cp, u64], i32),
        "tpunet_c_flightrec_stats": ([P(u64), P(u64)], i32),
        "tpunet_c_reduce": ([vp, vp, vp, u64, i32, i32], i32),
        "tpunet_c_weight_version": ([u64], i32),
        "tpunet_c_crc32c": ([vp, u64, ctypes.c_uint32], ctypes.c_uint32),
        "tpunet_c_codec_wire_bytes": ([i32, u64], u64),
        "tpunet_c_codec_encode": ([i32, vp, u64, vp, u64], i32),
        "tpunet_c_codec_decode": ([i32, vp, u64, vp], i32),
        # Ring communicator (the data-parallel step's collectives, the
        # all-to-alls of expert parallelism and the ring shift of sequence
        # parallelism).
        "tpunet_comm_create_ex": ([ctypes.c_char_p, i32, i32,
                                   ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_char_p, P(u)], i32),
        "tpunet_comm_wire_dtype": ([u, P(i32)], i32),
        "tpunet_comm_destroy": ([P(u)], i32),
        "tpunet_comm_all_reduce": ([u, vp, vp, u64, i32, i32], i32),
        "tpunet_comm_iall_reduce": ([u, vp, vp, u64, i32, i32, P(u64)],
                                    i32),
        "tpunet_comm_ticket_wait": ([u, u64], i32),
        "tpunet_comm_ticket_test": ([u, u64, P(u8)], i32),
        "tpunet_comm_reduce_scatter": ([u, vp, vp, u64, i32, i32], i32),
        "tpunet_comm_all_gather": ([u, vp, vp, u64], i32),
        "tpunet_comm_broadcast": ([u, vp, u64, i32], i32),
        "tpunet_comm_all_to_all": ([u, vp, vp, u64], i32),
        "tpunet_comm_all_to_all_typed": ([u, vp, vp, u64, i32], i32),
        "tpunet_comm_iall_to_all": ([u, vp, vp, u64, P(u64)], i32),
        "tpunet_comm_neighbor_exchange": ([u, vp, u64, vp, u64, P(u64)],
                                          i32),
        "tpunet_comm_barrier": ([u], i32),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return lib


def last_error() -> str:
    if _lib is None:
        return ""
    msg = _lib.tpunet_c_last_error()
    return msg.decode("utf-8", "replace") if msg else ""


class NativeError(RuntimeError):
    def __init__(self, code: int, op: str):
        self.code = code
        super().__init__(
            f"tpunet native {op} failed (code {code}): {last_error()}")


class CorruptionError(NativeError):
    """Wire payload failed its per-chunk CRC32C check (TPUNET_CRC=1); the
    comm survives and the next message may flow."""


class ProgressTimeoutError(NativeError):
    """The progress watchdog saw a request move zero bytes for a full
    window: the peer is alive but stuck."""


class VersionMismatchError(NativeError):
    """The peer speaks a different tpunet wire-framing version."""


class CodecMismatchError(NativeError):
    """The ranks of a group disagree on the wire compression codec."""


class QosAdmissionError(NativeError):
    """QoS admission control rejected a send: the traffic class's in-flight
    byte budget is fully posted. Nothing was enqueued, so the send is
    safely retryable."""


class RewireTimeoutError(NativeError):
    """An elastic membership rewire (``tpunet_torch.elastic.ElasticWorld``)
    did not complete inside TPUNET_REWIRE_TIMEOUT_MS. The old communicator
    was already finalized when this raises, so the process holds no live
    comm: retry the rewire or exit."""


class WeightSwapError(NativeError):
    """A live weight publication aborted; the previous version serves on."""


_TYPED_ERRORS = {
    TPUNET_ERR_CORRUPT: CorruptionError,
    TPUNET_ERR_TIMEOUT: ProgressTimeoutError,
    TPUNET_ERR_VERSION: VersionMismatchError,
    TPUNET_ERR_CODEC: CodecMismatchError,
    TPUNET_ERR_QOS_ADMISSION: QosAdmissionError,
    TPUNET_ERR_REWIRE: RewireTimeoutError,
    TPUNET_ERR_WEIGHT_SWAP: WeightSwapError,
}


def check(code: int, op: str) -> None:
    if code != TPUNET_OK:
        raise _TYPED_ERRORS.get(code, NativeError)(code, op)
