"""Pipeline-parallel stage driver: directed microbatch chains with tickets.

The port of ``tpunet/workloads/pipeline.py``, on numpy buffers as the JAX
package's. W ranks form a linear pipeline (stage k feeds stage k+1, no
wraparound). Each adjacent pair gets a dedicated P2P link over the
transport (``tpunet_torch.transport.Net``): every stage listens, the
64-byte rendezvous handles travel over the group's Communicator in ONE
``all_gather``, then stage k connects forward to stage k+1:
connect-all-then-accept-all, the non-deadlocking wiring order the
collectives use. The links inherit the whole transport stack: striping,
CRC, QoS class, fault injection, telemetry.

Ordering rides tickets: ``isend``/``irecv`` return a :class:`Ticket`, and
``after=`` pins a new operation behind earlier tickets. A microbatch chain

    t_r = stage.irecv(buf)                      # from stage k-1
    y   = f(buf)                                # once t_r settled
    t_s = stage.isend(y, after=(t_r,))          # to stage k+1

never reorders a send ahead of the receive and compute it depends on,
while independent microbatches keep overlapping on the wire. A dead
neighbour surfaces as a typed NativeError from the pending receive or send
(dead-peer EOF, or the progress watchdog under
TPUNET_PROGRESS_TIMEOUT_MS), never a hang.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np

from tpunet_torch import transport


class Ticket:
    """One posted pipeline transfer plus the tickets it was ordered after.

    ``wait()`` settles the dependencies first (idempotent: a dependency
    may be shared by several tickets), then the transfer itself; errors
    surface as typed NativeError. ``done()`` is the non-blocking probe."""

    def __init__(self, request, deps: Sequence["Ticket"] = ()):
        self._req = request
        self._deps = tuple(deps)
        self._settled = False

    def wait(self, timeout: float | None = None) -> int:
        for d in self._deps:
            d.wait(timeout)
        if self._settled:
            return 0
        n = self._req.wait(timeout) if self._req is not None else 0
        self._settled = True
        return n

    def done(self) -> bool:
        if self._settled:
            return True
        if any(not d.done() for d in self._deps):
            return False
        if self._req is None:
            return True
        ok, _ = self._req.test()
        return ok


class PipelineStage:
    """One stage of a linear pipeline over dedicated P2P links.

    ``comm`` is the group Communicator (rank = stage index); it carries the
    handle rendezvous and stays available for collectives (e.g. the
    data-parallel gradient all-reduce a trainer would interleave).
    ``traffic_class`` pins the QoS lane of the stage links ("latency" for
    activation hops competing with bulk gradient traffic)."""

    def __init__(self, comm, traffic_class: str | None = None):
        self.comm = comm
        self.rank = comm.rank
        self.world = comm.world_size
        self.net = transport.Net(traffic_class=traffic_class)
        self._listen = self.net.listen()
        handle = np.frombuffer(self._listen.handle, np.uint8).copy()
        handles = comm.all_gather(handle)
        self._send = None  # link to stage rank + 1
        self._recv = None  # link from stage rank - 1
        # connect() never blocks on the peer's accept (TCP backlog and a
        # buffered preamble), so the forward chain wires without any
        # cross-stage ordering.
        if self.rank + 1 < self.world:
            self._send = self.net.connect(handles[self.rank + 1].tobytes())
        if self.rank > 0:
            self._recv = self._listen.accept()

    @property
    def is_first(self) -> bool:
        return self.rank == 0

    @property
    def is_last(self) -> bool:
        return self.rank == self.world - 1

    # -- ticketed microbatch transfers ------------------------------------

    def isend(self, arr: np.ndarray, after: Sequence[Ticket] = ()) -> Ticket:
        """Post a microbatch to the NEXT stage, ordered after `after`
        (their transfers settle before this send posts). The last stage
        has no next one: an error, not silence."""
        if self._send is None:
            raise RuntimeError(
                f"stage {self.rank} is last: no next stage to send to")
        for d in after:
            d.wait()
        return Ticket(self._send.isend(np.ascontiguousarray(arr)), ())

    def irecv(self, buf: np.ndarray, after: Sequence[Ticket] = ()) -> Ticket:
        """Post a microbatch receive from the PREVIOUS stage into `buf`
        (pinned until the ticket settles), ordered after `after`."""
        if self._recv is None:
            raise RuntimeError(
                f"stage {self.rank} is first: no previous stage")
        for d in after:
            d.wait()
        return Ticket(self._recv.irecv(buf), ())

    # -- the canonical microbatch chain -----------------------------------

    def run(self, fn: Callable[[np.ndarray], np.ndarray],
            microbatches: Sequence[np.ndarray] | None = None,
            n_micro: int | None = None,
            mb_shape: tuple | None = None) -> list[np.ndarray] | None:
        """Drive a GPipe-style forward chain of microbatches through this
        stage: stage 0 feeds ``microbatches``; later stages receive
        ``n_micro`` batches of ``mb_shape`` f32, apply ``fn`` and forward,
        except the last, which collects and returns the outputs (every
        other stage returns None). Each send is `after=`-chained behind
        the receive it transforms, so the wire order never outruns the
        data flow."""
        outputs: list[np.ndarray] = []
        pending: list[Ticket] = []
        if self.is_first:
            if microbatches is None:
                raise ValueError("stage 0 needs the input microbatches")
            for mb in microbatches:
                pending.append(self.isend(fn(np.asarray(mb, np.float32))))
        else:
            if n_micro is None or mb_shape is None:
                raise ValueError("stages > 0 need n_micro and mb_shape")
            bufs = [np.empty(mb_shape, np.float32)
                    for _ in range(int(n_micro))]
            for buf in bufs:
                t_r = self.irecv(buf)
                t_r.wait()  # the compute below consumes buf
                y = fn(buf)
                if self.is_last:
                    outputs.append(y)
                else:
                    pending.append(self.isend(y, after=(t_r,)))
        for t in pending:
            t.wait()
        return outputs if self.is_last else None

    def close(self) -> None:
        for c in (self._send, self._recv, self._listen):
            if c is not None:
                try:
                    c.close()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
        self._send = self._recv = None
        self.net.close()

    def __enter__(self) -> "PipelineStage":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
