"""The port's pipeline-stage workload (tpunet_torch/workloads/pipeline.py)
against the JAX package's, on the CPU.

`Ticket` against JAX's `Ticket`: the same fake requests give the same
event order (dependencies settle first, once each) and the same done()
answers. `PipelineStage` chains at worlds 2, 3 and 4 on threads, each with
its own loopback Communicator (spawned stages flake under xdist): every
stage applies its own transform, and the last stage's outputs must equal
the composition exactly, as must a chain of the JAX package's stages on
the same inputs, and a chain that mixes the two packages' stages on one
wire. Refusals: the last stage's isend, the first stage's irecv, run()
without its inputs.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from conftest import free_port

from tpunet.collectives import Communicator as JaxCommunicator
from tpunet.workloads.pipeline import PipelineStage as JaxPipelineStage
from tpunet.workloads.pipeline import Ticket as JaxTicket
from tpunet_torch.collectives import Communicator
from tpunet_torch.workloads import PipelineStage, Ticket

N_MICRO, N = 6, 1031
PACKAGES = {"port": (Communicator, PipelineStage),
            "jax": (JaxCommunicator, JaxPipelineStage)}


class _FakeReq:
    def __init__(self, name, events, ready=True):
        self.name, self.events, self.ready = name, events, ready

    def wait(self, timeout=None):
        self.events.append(("wait", self.name))
        return len(self.name)

    def test(self):
        self.events.append(("test", self.name))
        return self.ready, 0


def _ticket_script(ticket_cls) -> list:
    """One script of waits and probes over a dependency graph (a shared
    dependency, a request-less ticket, a request not ready yet)."""
    ev: list = []
    a = ticket_cls(_FakeReq("a", ev))
    b = ticket_cls(_FakeReq("bb", ev), deps=(a,))
    slow = ticket_cls(_FakeReq("slow", ev, ready=False))
    c = ticket_cls(_FakeReq("ccc", ev), deps=(b, a))
    none = ticket_cls(None, deps=(slow,))
    ev.append(("done", none.done()))
    ev.append(("done", c.done()))
    ev.append(("wait->", c.wait()))
    ev.append(("wait->", c.wait()))
    ev.append(("wait->", b.wait()))
    ev.append(("done", a.done() and b.done() and c.done()))
    ev.append(("wait->", none.wait()))
    ev.append(("done", none.done()))
    return ev


def test_ticket_events_match_jax():
    got, want = _ticket_script(Ticket), _ticket_script(JaxTicket)
    assert got == want
    waits = [name for kind, name in got if kind == "wait"]
    assert waits[:3] == ["a", "bb", "ccc"]  # deps first, once each


def _stage_fn(rank):
    return lambda x: x * np.float32(rank + 2) + np.float32(rank)


def _inputs():
    rng = np.random.default_rng(5)
    return [rng.standard_normal(N).astype(np.float32) for _ in range(N_MICRO)]


def _expected(world):
    out = []
    for x in _inputs():
        for r in range(world):
            x = _stage_fn(r)(x)
        out.append(x)
    return out


def _chain(packages: list[str]) -> dict:
    """One pipeline of len(packages) stages on threads, stage r built from
    packages[r]'s Communicator and PipelineStage; {rank: run()'s result or
    the exception}."""
    world = len(packages)
    port, box = free_port(), {}

    def stage(rank):
        comm_cls, stage_cls = PACKAGES[packages[rank]]
        try:
            with comm_cls(f"127.0.0.1:{port}", rank, world) as comm, \
                    stage_cls(comm) as st:
                assert (st.is_first, st.is_last) == (rank == 0,
                                                     rank == world - 1)
                fn = _stage_fn(rank)
                if st.is_first:
                    box[rank] = st.run(fn, microbatches=_inputs())
                else:
                    box[rank] = st.run(fn, n_micro=N_MICRO, mb_shape=(N,))
        except BaseException as e:  # noqa: BLE001 — asserted below
            box[rank] = e

    threads = [threading.Thread(target=stage, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert all(not t.is_alive() for t in threads), "a stage hung"
    for r in range(world):
        if isinstance(box.get(r), BaseException):
            raise box[r]
    return box


@pytest.mark.parametrize("world", [2, 3, 4])
def test_pipeline_chain_matches_jax(world):
    """The last stage returns every microbatch through every stage's
    transform in order, bitwise, as a chain of JAX's stages does; the
    other stages return None."""
    got = _chain(["port"] * world)
    want = _chain(["jax"] * world)
    expected = _expected(world)
    for box in (got, want):
        assert all(box[r] is None for r in range(world - 1))
        assert len(box[world - 1]) == N_MICRO
    for g, w, e in zip(got[world - 1], want[world - 1], expected):
        assert g.dtype == np.float32
        assert g.tobytes() == w.tobytes() == e.tobytes()


def test_pipeline_chain_mixes_the_packages():
    """Port and JAX stages in one chain over the same wire: the port's
    links and rendezvous are the JAX package's."""
    box = _chain(["port", "jax", "port"])
    for g, e in zip(box[2], _expected(3)):
        assert g.tobytes() == e.tobytes()


def test_pipeline_refusals():
    """The last stage has no next stage, the first no previous one (both
    RuntimeError), and run() needs its inputs (ValueError); a stage alone
    is both first and last."""
    port = free_port()
    with Communicator(f"127.0.0.1:{port}", 0, 1) as comm, \
            PipelineStage(comm, traffic_class="latency") as st:
        assert st.is_first and st.is_last and st.world == 1
        assert st.net.traffic_class == "latency"
        with pytest.raises(RuntimeError, match="is last"):
            st.isend(np.zeros(4, np.float32))
        with pytest.raises(RuntimeError, match="is first"):
            st.irecv(np.zeros(4, np.float32))
        with pytest.raises(ValueError, match="input microbatches"):
            st.run(lambda x: x)
    box: dict = {}
    port = free_port()

    def stage(rank):
        with Communicator(f"127.0.0.1:{port}", rank, 2) as comm, \
                PipelineStage(comm) as st:
            try:
                if rank == 1:
                    st.run(lambda x: x, n_micro=1)
            except ValueError as e:
                box[rank] = e
            st.comm.barrier()

    threads = [threading.Thread(target=stage, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert "n_micro and mb_shape" in str(box.get(1))
