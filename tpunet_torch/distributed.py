"""Process-group lifecycle: one global ring communicator per process.

The port of ``tpunet/distributed.py``. ``tpunet_torch.interop`` routes the
cross-host (DCN) collectives of the data-parallel step through it. The JAX
package also registers the communicator as the process default for its XLA
FFI custom calls; the port has no FFI route, so nothing is registered.
"""

from __future__ import annotations

import atexit
import sys
import threading

from tpunet_torch.collectives import Communicator

_lock = threading.Lock()
_comm: Communicator | None = None
_comm_args: tuple | None = None


def initialize(coordinator: str | None = None, rank: int | None = None,
               world_size: int | None = None, wire_dtype: str | None = None,
               algo: str | None = None,
               traffic_class: str | None = None) -> Communicator:
    """Create (or return) the process-global communicator.

    Collective across processes: every process of the job must call it.
    Defaults from env: TPUNET_COORDINATOR, TPUNET_RANK/RANK,
    TPUNET_WORLD_SIZE/WORLD_SIZE. wire_dtype, algo and traffic_class are
    the Communicator's (negotiated across ranks at wiring)."""
    global _comm, _comm_args
    args = (coordinator, rank, world_size, wire_dtype, algo, traffic_class)
    with _lock:
        if _comm is None:
            _comm = Communicator(*args)
            _comm_args = args
        elif args != _comm_args and any(a is not None for a in args):
            raise RuntimeError(
                f"tpunet_torch.distributed already initialized with "
                f"{_comm_args}; got conflicting {args}: call finalize() "
                f"first to re-initialize")
        return _comm


def is_initialized() -> bool:
    return _comm is not None


def global_communicator() -> Communicator:
    if _comm is None:
        raise RuntimeError("tpunet_torch.distributed.initialize() has not "
                           "been called in this process")
    return _comm


def finalize() -> None:
    global _comm, _comm_args
    with _lock:
        if _comm is not None:
            interop = sys.modules.get("tpunet_torch.interop")
            if interop is not None:
                interop._drop_pending_for(_comm)
            _comm.close()
            _comm = None
            _comm_args = None


def rank() -> int:
    return global_communicator().rank


def world_size() -> int:
    return global_communicator().world_size


@atexit.register
def _cleanup() -> None:  # pragma: no cover - interpreter teardown
    try:
        finalize()
    except Exception:  # noqa: BLE001
        pass
