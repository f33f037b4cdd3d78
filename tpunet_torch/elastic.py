"""Elastic churn engine: shrink or grow the world mid-run, bounded and
counted. The port of ``tpunet/elastic.py``.

``tpunet_torch.train.elastic`` turns peer death into a generation-based
rebuild; this module is the full churn engine: membership can change
either way mid-run (a dead rank shrinks the world, a join request grows
it), and every rewire builds a brand-new communicator, so the bootstrap
re-derives all wiring-time state (host grouping, subgroups, dispatch
selections, stripe maps, codec/algo/QoS negotiation) at the new shape, as a
fresh job at that shape would.

**Recovery pipeline and its counters.** Every rewire runs four measured
phases, observed into ``tpunet_rewire_duration_us{phase=...}``:

  detect      last good step -> failure classified (or join agreed)
  quiesce     old communicator finalized
  rendezvous  membership sealed + generation published (the grace-window
              protocol of train.elastic: survivors and joiners are
              indistinguishable on purpose)
  rewire      new communicator wired at the new shape

``tpunet_churn_events_total{kind=kill|join|shrink|grow|readmit}`` counts
events and the ``tpunet_world_size`` gauge carries the live world. A whole
rewire exceeding ``TPUNET_REWIRE_TIMEOUT_MS`` raises the typed
``RewireTimeoutError`` (-9): bounded recovery, never a hang.

**Zero corruption is checked.** ``crc_check(params)`` after every rewire
hashes the parameters (numpy arrays or torch tensors on any device, by
their contiguous host bytes) with CRC32C and all-gathers the digest; any
cross-rank inequality raises ``WorldCorruptionError`` on every rank before
another step could fold the divergence into the trajectory.

**Determinism.** Churn is scripted through the chaos grammar
(``TPUNET_FAULT_SPEC="churn:at_step=4:rank=3:action=kill;..."``): ranks
poll ``churn_action(step, member_id)`` at step boundaries. A ``kill``
verdict means SIGKILL yourself now; a ``join`` verdict (polled by the
joiner or supervisor against the job's checkpointed step) means request
entry. A scripted run replays the same way every time.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch

from tpunet_torch import _native, distributed, telemetry, transport
from tpunet_torch.train.elastic import (ExcludedFromMembership,
                                        generation_coordinator,
                                        is_comm_failure,
                                        membership_rendezvous,
                                        read_generation, write_generation)

__all__ = [
    "ElasticWorld", "WorldCorruptionError", "churn_action", "churn_pending",
    "parse_churn_script", "run",
]

_CHURN_ACTIONS = {0: None, 1: "kill", 2: "join"}


class WorldCorruptionError(RuntimeError):
    """The post-rewire CRC32C cross-rank parameter-equality check failed:
    at least one rank's parameters diverged across a churn event. Raised on
    EVERY rank (the digests are all-gathered) before another step could
    fold the divergence into the trajectory. A failed check means restore
    from the checkpoint, not continue."""


def churn_action(step: int, member_id: int) -> str | None:
    """One-shot poll of the armed churn script (TPUNET_FAULT_SPEC /
    tpunet_c_fault_inject): the first un-fired event with at_step <= step
    targeting `member_id` (or rank=*) fires; returns "kill", "join" or
    None. Fired latches survive the engine rebuilds the script causes."""
    lib = _native.load()
    code = int(lib.tpunet_c_churn_poll(int(step), int(member_id)))
    if code < 0:
        raise _native.NativeError(code, "churn_poll")
    return _CHURN_ACTIONS.get(code)


def churn_pending() -> int:
    """Armed churn events not yet fired (a finished scripted run must
    report 0)."""
    lib = _native.load()
    return int(lib.tpunet_c_churn_pending())


def parse_churn_script(spec: str) -> list[dict]:
    """Python mirror of the native churn-segment parser for supervisor-side
    scheduling (the native slot is poll-consuming; a harness that must know
    the join schedule up front parses the same spec non-destructively).
    Returns [{"at_step", "rank", "action"}, ...] for the churn segments;
    classic fault segments are ignored. Raises ValueError on a malformed
    churn segment, naming the offending token (the native parser rejects
    the same specs through tpunet_c_fault_inject)."""
    events: list[dict] = []
    for seg in (spec or "").split(";"):
        if not seg:
            continue
        clauses = seg.split(":")
        if clauses[0] != "churn":
            continue  # classic fault segment — not ours
        ev: dict = {"at_step": 0, "rank": -1, "action": None}
        for clause in clauses[1:]:
            key, eq, val = clause.partition("=")
            if not eq:
                raise ValueError(
                    f"churn spec: clause {clause!r} is not key=value")
            if key == "at_step":
                ev["at_step"] = int(val)
            elif key == "rank":
                ev["rank"] = -1 if val == "*" else int(val)
            elif key == "action":
                if val not in ("kill", "join"):
                    raise ValueError(
                        f"churn spec: unknown action {val!r} (want kill or "
                        f"join)")
                ev["action"] = val
            else:
                raise ValueError(f"churn spec: unknown key {key!r}")
        if ev["action"] is None:
            raise ValueError(f"churn spec: missing action= clause in {seg!r}")
        events.append(ev)
    return events


class ElasticWorld:
    """Membership lifecycle for one process: create/finalize/rebuild with
    per-phase timing, scripted churn polling, and the post-rewire CRC gate.

    ``member_id`` is this process's STABLE identity (it survives rank
    re-assignment across generations; a fresh job uses member_id == rank).
    The live communicator is always ``self.comm``; training code must read
    rank/world from it, never from the constructor arguments.

    Survivor loop shape (see ``run()`` for the driver)::

        world = ElasticWorld(coord, member_id, W, directory=dir)
        comm = world.create()
        for step in ...:
            if world.churn_action(step) == "kill":
                os.kill(os.getpid(), signal.SIGKILL)   # scripted death
            new = world.maybe_rewire(step)             # join requests
            if new is not None:
                comm = new; restore from checkpoint; world.crc_check(params)
            ... train step; checkpoint; world.step_ok() ...

    Joiner shape: ``comm = world.join()`` — deposits a join request, waits
    for the survivors to open the next rendezvous (generation bump), and
    enters it; training re-shards via the checkpoint contract.
    """

    def __init__(self, coordinator: str, member_id: int, world_size: int, *,
                 directory: str | Path, wire_dtype: str | None = None,
                 algo: str | None = None, traffic_class: str | None = None,
                 advertise_host: str | None = None,
                 grace_ms: int | None = None,
                 rewire_timeout_ms: int | None = None,
                 max_rewires: int = 16):
        from tpunet_torch.config import Config

        cfg = Config.from_env()
        self.coordinator = coordinator
        self.member_id = int(member_id)
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.grace_s = (grace_ms if grace_ms is not None
                        else cfg.churn_grace_ms) / 1e3
        self.rewire_timeout_s = (rewire_timeout_ms if rewire_timeout_ms
                                 is not None else cfg.rewire_timeout_ms) / 1e3
        self.max_rewires = max_rewires
        self._kw = {"wire_dtype": wire_dtype, "algo": algo,
                    "traffic_class": traffic_class}
        base_host, base_port = coordinator.rsplit(":", 1)
        self.base_port = int(base_port)
        if advertise_host is None:
            # The run_elastic stance: no safe multi-host default exists —
            # the re-elected coordinator binds on a surviving member's host.
            if base_host in ("127.0.0.1", "localhost", "::1"):
                advertise_host = base_host
            else:
                raise ValueError(
                    "ElasticWorld on a non-loopback coordinator requires "
                    "advertise_host=<this machine's reachable address>")
        self.advertise_host = advertise_host
        self.generation = read_generation(self.directory)
        #: Stable member ids of the live world, in rank order.
        self.members: list[int] = list(range(world_size))
        self.comm = None
        self.stats = {"rewires": 0, "crc_checks": 0, "joins_honored": 0}
        self._last_ok = time.monotonic()

    # -- lifecycle ---------------------------------------------------------

    def create(self):
        """Initial wiring. Generation 0 wires the configured seed shape
        (member ids == ranks); a process (re)entering a job whose
        generation already advanced goes through membership rendezvous
        like everyone else."""
        if self.generation == 0:
            distributed.finalize()
            self.comm = distributed.initialize(
                generation_coordinator(self.coordinator, 0), self.member_id,
                len(self.members), **self._kw)
        else:
            self._rewire(kind=None, detect_s=0.0, generation=self.generation)
        telemetry.world_size(self.comm.world_size)
        self._last_ok = time.monotonic()
        return self.comm

    def step_ok(self) -> None:
        """Stamp 'the world was healthy here' — the detect-phase clock's
        zero point. Call once per successful step."""
        self._last_ok = time.monotonic()

    def churn_action(self, step: int) -> str | None:
        """This member's scripted churn verdict at `step` (one-shot)."""
        return churn_action(step, self.member_id)

    def close(self) -> None:
        distributed.finalize()
        self.comm = None

    # -- failure path (shrink) ---------------------------------------------

    def on_failure(self, exc: BaseException):
        """Classify a training-loop exception and rebuild the world around
        it. Non-comm failures re-raise unchanged (a loss blowup must not be
        laundered into a restart); comm failures trigger the measured
        rewire pipeline — the detect phase is the time since the last
        ``step_ok()``, i.e. how long the failure took to surface (bounded
        by keepalive/watchdog, which is the claim the histogram carries)."""
        if not is_comm_failure(exc):
            raise exc
        if self.stats["rewires"] >= self.max_rewires:
            raise exc
        detect_s = time.monotonic() - self._last_ok
        return self._rewire(kind=None, detect_s=detect_s)

    # -- grow path ----------------------------------------------------------

    def _pending_join_ids(self) -> list[int]:
        ids = []
        for p in self.directory.glob("join_*"):
            try:
                mid = int(p.name.split("_", 1)[1])
            except ValueError:
                continue
            if mid not in self.members:
                ids.append(mid)
        return sorted(ids)

    def maybe_rewire(self, step: int | None = None):
        """Step-boundary join check, agreed COLLECTIVELY: each rank reports
        whether it sees a pending join request and the max is all-reduced,
        so filesystem visibility skew cannot split the world (if any rank
        saw it, every rank rewires). Returns the new communicator when the
        world changed, else None. Costs one 4-byte allreduce per call —
        call it at step boundaries, not inside them."""
        del step  # membership decisions are step-agnostic; kept for symmetry
        if self.comm is None:
            raise RuntimeError("maybe_rewire() needs a live communicator")
        pending = self._pending_join_ids()
        flag = np.array([1 if pending else 0], np.int32)
        agreed = int(self.comm.all_reduce(flag, "max")[0])
        if not agreed:
            self._last_ok = time.monotonic()
            return None
        detect_s = time.monotonic() - self._last_ok
        return self._rewire(kind=None, detect_s=detect_s)

    def request_join(self) -> None:
        """Deposit this member's join request (atomic publish; idempotent).
        Survivors observe it at their next ``maybe_rewire()`` boundary."""
        path = self.directory / f"join_{self.member_id}"
        tmp = path.with_name(f".join_{self.member_id}.{os.getpid()}.tmp")
        tmp.write_text(self.advertise_host)
        os.replace(tmp, path)

    def join(self, timeout_s: float = 180.0):
        """Grow path for the NEW rank: read the published generation,
        request entry, wait for the survivors to open the next rendezvous
        (generation bump) and enter it. A joiner that misses a grace window
        (ExcludedFromMembership) keeps waiting — its request file persists,
        so the survivors open another window. Typed RewireTimeoutError when
        no rendezvous admits it within `timeout_s`."""
        self.request_join()
        t_req = time.monotonic()
        seen = read_generation(self.directory)
        deadline = t_req + timeout_s
        join_file = self.directory / f"join_{self.member_id}"
        while True:
            g = read_generation(self.directory)
            if g > seen:
                try:
                    comm = self._rewire(kind="join",
                                        detect_s=time.monotonic() - t_req,
                                        generation=g)
                    join_file.unlink(missing_ok=True)
                    return comm
                except ExcludedFromMembership:
                    seen = g  # missed the window; wait for the next bump
            if time.monotonic() > deadline:
                join_file.unlink(missing_ok=True)
                telemetry.flightrec_dump_verdict("rewire_deadline")
                raise _native.RewireTimeoutError(
                    _native.TPUNET_ERR_REWIRE,
                    f"join (no membership rendezvous admitted member "
                    f"{self.member_id} within {timeout_s}s)")
            time.sleep(0.05)

    # -- the rewire pipeline -------------------------------------------------

    def _check_deadline(self, deadline: float, phase: str) -> None:
        if time.monotonic() > deadline:
            # Terminal verdict: snapshot the flight recorder at the raise
            # site, as the native watchdog and CRC paths do.
            telemetry.flightrec_dump_verdict("rewire_deadline")
            raise _native.RewireTimeoutError(
                _native.TPUNET_ERR_REWIRE,
                f"rewire ({phase} phase pushed recovery past "
                f"TPUNET_REWIRE_TIMEOUT_MS = {self.rewire_timeout_s * 1e3:.0f})")

    def _rewire(self, kind: str | None, detect_s: float,
                generation: int | None = None):
        """The measured rewire: quiesce -> rendezvous -> rewire, with the
        caller-supplied detect duration. `generation=None` bumps + publishes
        (survivor side); an explicit generation joins one already published
        (joiner side — it must not re-bump past the window it is
        chasing)."""
        deadline = time.monotonic() + self.rewire_timeout_s
        t0 = time.monotonic()
        distributed.finalize()
        self.comm = None
        t1 = time.monotonic()
        self._check_deadline(deadline, "quiesce")
        if generation is None:
            g = max(self.generation + 1, read_generation(self.directory))
            write_generation(self.directory, g)
        else:
            g = generation
        coordinator, rank, world, members = membership_rendezvous(
            self.directory, g, self.member_id, self.advertise_host,
            self.base_port, self.grace_s)
        t2 = time.monotonic()
        self._check_deadline(deadline, "rendezvous")
        old_members = set(self.members)
        comm = distributed.initialize(coordinator, rank, world, **self._kw)
        t3 = time.monotonic()
        self.comm = comm
        self.generation = g
        self.members = members
        self.stats["rewires"] += 1
        telemetry.rewire_observe("detect", int(detect_s * 1e6))
        telemetry.rewire_observe("quiesce", int((t1 - t0) * 1e6))
        telemetry.rewire_observe("rendezvous", int((t2 - t1) * 1e6))
        telemetry.rewire_observe("rewire", int((t3 - t2) * 1e6))
        joined = [m for m in members if m not in old_members]
        if kind is None:
            kind = "grow" if world > len(old_members) else "shrink"
        telemetry.churn_event(kind)
        if kind != "join":  # survivors additionally count each admit
            for _ in joined:
                telemetry.churn_event("join")
                self.stats["joins_honored"] += 1
        telemetry.world_size(world)
        self._check_deadline(deadline, "rewire")
        self._last_ok = time.monotonic()
        return comm

    # -- integrity -----------------------------------------------------------

    def crc_check(self, arrays) -> int:
        """CRC32C cross-rank parameter-equality gate, run after EVERY
        rewire. Hashes `arrays` (one numpy array or torch tensor, or an
        iterable of them, chained in order) by each one's contiguous host
        bytes, wherever it lies, and all-gathers the digest; any inequality
        raises WorldCorruptionError on every rank. Returns the agreed
        digest."""
        if self.comm is None:
            raise RuntimeError("crc_check() needs a live communicator")
        if isinstance(arrays, (np.ndarray, torch.Tensor)):
            arrays = [arrays]
        crc = 0
        for a in arrays:
            crc = transport.crc32c(_host_bytes(a), seed=crc)
        digests = self.comm.all_gather(np.array([crc], np.uint32)).ravel()
        self.stats["crc_checks"] += 1
        if len(set(int(d) for d in digests)) != 1:
            raise WorldCorruptionError(
                f"cross-rank parameter CRC mismatch after rewire at "
                f"generation {self.generation}: "
                f"{[hex(int(d)) for d in digests]} — restore from the "
                f"checkpoint, do not continue")
        return crc


def _host_bytes(a) -> np.ndarray:
    """The contiguous host bytes of a numpy array or a tensor on any
    device, as a flat uint8 array (a tensor's dtype may have no numpy
    counterpart, bfloat16 for one)."""
    if isinstance(a, torch.Tensor):
        return a.detach().contiguous().cpu().reshape(-1).view(
            torch.uint8).numpy()
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def run(train_once, *, coordinator: str, member_id: int, world_size: int,
        directory: str | Path, joiner: bool = False, **world_kwargs):
    """Drive ``train_once(world, comm)`` under the churn engine.

    ``train_once`` owns the step loop (checkpoint cadence, churn polling,
    ``maybe_rewire`` at step boundaries, ``crc_check`` after rewires) and
    is RE-ENTERED from the latest checkpoint after a failure-triggered
    rewire; grow rewires surface inside it via ``maybe_rewire``'s return
    value, so it continues in place. ``joiner=True`` enters through the
    grow path (``join()``) instead of seed wiring. Non-comm exceptions and
    an exhausted rewire budget propagate."""
    world = ElasticWorld(coordinator, member_id, world_size,
                         directory=directory, **world_kwargs)
    comm = world.join() if joiner else world.create()
    while True:
        try:
            return train_once(world, comm)
        except Exception as exc:  # noqa: BLE001 — classified by on_failure
            comm = world.on_failure(exc)
