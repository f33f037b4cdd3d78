"""Live weight updates: version-stamped hot-swap over the transport itself.

The port of ``tpunet/serve/publish.py``. A running fleet adopts a new
checkpoint without dropping a request:

**Control plane on the latency links.** The frontend announces a swap with
a T_SWAP_BEGIN frame per decode rank (version, broadcast shape, chunk
size, wire codec, QoS class, rendezvous coordinator, deadline) on the same
latency-class tier links that carry requests. Receivers answer with
T_SWAP_STATUS (flipped/aborted) and the frontend retires drained versions
with T_SWAP_RETIRE.

**Weight bytes on the bulk class.** The checkpoint is flattened to one f32
vector (``flatten_params``: the JAX package's leaf order and layout, so the
same checkpoint is the same bytes in both packages), encoded once under
the bf16 wire codec, and chunk-streamed through a binomial-tree
``Communicator.broadcast`` wired on the bulk QoS class
(``TPUNET_PUBLISH_CLASS``), which makes one native call a 1 MiB pipeline
piece (``collectives.BCAST_PIECE``). On both sides the transfer runs on a thread
of its own while the serving loop keeps going: the publisher pumps
``Router.poll``, a decode rank polls its receiver once per serve-loop pass.
The collectives and bytes on the wire are the JAX package's.

**Flip only on proof, only at a request boundary.** After the last chunk
every participant CRC32C-hashes the wire bytes it holds and all-gathers
the digests: the verdict is computed locally but identically on every
rank, so one corrupt receiver refuses the flip fleet-wide. Only a verified
rank stages the decoded parameters and flips, between serve-loop passes.
Every failure path (death mid-broadcast, digest disagreement, deadline)
raises the typed retryable ``WeightSwapError`` (-10); the previous version
keeps serving throughout.

**Mixed-version pools are legal.** Each request is pinned at admission to
the version that prefilled it (the T_BLOCK aux word); old versions serve
their pinned sessions until drained, then retire. A rank that rejoins
stale (death mid-swap) is caught up by a world=2 re-publication of the
retained wire.

Scripted chaos composes: ``swap:at_step=N:action=publish|corrupt|die``
segments ride TPUNET_FAULT_SPEC next to ``churn`` ones; ``swap_action`` and
``swap_pending`` poll the native script.
"""

from __future__ import annotations

import contextlib
import os
import socket
import sys
import threading
import time

import numpy as np
import torch

from tpunet_torch import _native, telemetry, transport
from tpunet_torch._native import WeightSwapError
from tpunet_torch.collectives import Communicator
from tpunet_torch.models.serve import refuse_mesh
from tpunet_torch.serve import protocol as proto
from tpunet_torch.serve.prefill import PrefillEngine

__all__ = [
    "WeightPublisher", "WeightReceiver", "WeightSwapError", "flatten_params",
    "parse_swap_script", "roundtrip_params", "swap_action", "swap_pending",
    "unflatten_params",
]

_DEBUG = bool(os.environ.get("TPUNET_SWAP_DEBUG"))


def _dbg(msg: str) -> None:
    if _DEBUG:
        print(f"[swapdbg {time.monotonic():.3f}] {msg}",
              file=sys.stderr, flush=True)


_SWAP_ACTIONS = {0: None, 1: "publish", 2: "corrupt", 3: "die"}

_ERR = _native.TPUNET_ERR_WEIGHT_SWAP

# How long past the swap deadline (or a target's death) the publisher keeps
# pumping after force-closing the comm under a parked broadcast thread
# before it abandons the (daemon) thread and raises typed. A peer SIGKILLed
# at the wrong instant (while the tree wires its mesh) can park the native
# collective in an accept even close() cannot end; that must cost one
# leaked thread, never the serving loop.
_CAST_ABANDON_GRACE_S = 5.0


# -- scripted swap chaos -----------------------------------------------------


def swap_action(step: int) -> str | None:
    """One-shot poll of the armed swap script (TPUNET_FAULT_SPEC /
    ``transport.fault_inject``): the first un-fired ``swap:`` event with
    at_step <= step fires; returns "publish" (frontend: publish the staged
    checkpoint now), "corrupt" (decode: flip a byte of the received wire
    before digesting), "die" (decode: SIGKILL yourself mid-swap) or None.
    Fired latches persist until the script is cleared."""
    lib = _native.load()
    code = int(lib.tpunet_c_swap_poll(int(step)))
    if code < 0:
        raise _native.NativeError(code, "swap_poll")
    return _SWAP_ACTIONS.get(code)


def swap_pending() -> int:
    """Armed swap events not yet fired (a finished scripted run reports 0)."""
    lib = _native.load()
    return int(lib.tpunet_c_swap_pending())


def parse_swap_script(spec: str) -> list[dict]:
    """Non-destructive parse of the swap segments of a fault spec, for a
    harness that must know the publish schedule up front. Returns
    [{"at_step", "action"}, ...]; churn and classic fault segments are
    ignored. Raises ValueError on a malformed swap segment, naming the
    offending token (the native parser rejects the same specs)."""
    events: list[dict] = []
    for seg in (spec or "").split(";"):
        if not seg:
            continue
        clauses = seg.split(":")
        if clauses[0] != "swap":
            continue  # churn / classic fault segment: not ours
        ev: dict = {"at_step": 0, "action": None}
        for clause in clauses[1:]:
            key, eq, val = clause.partition("=")
            if not eq:
                raise ValueError(
                    f"swap spec: clause {clause!r} is not key=value")
            if key == "at_step":
                ev["at_step"] = int(val)
            elif key == "action":
                if val not in ("publish", "corrupt", "die"):
                    raise ValueError(
                        f"swap spec: unknown action {val!r} (want publish, "
                        f"corrupt or die)")
                ev["action"] = val
            else:
                raise ValueError(f"swap spec: unknown key {key!r}")
        if ev["action"] is None:
            raise ValueError(f"swap spec: missing action= clause in {seg!r}")
        events.append(ev)
    return events


# -- parameter <-> wire helpers ----------------------------------------------
#
# The wire is the JAX package's: the leaves in the order
# jax.tree_util.tree_leaves walks the flax tree (dict keys sorted at every
# level), each in flax's layout (a dense kernel (in, out), a conv kernel
# HWIO), as f32. A port state_dict names a leaf "a.b.weight" where flax
# says a/b/kernel, and keeps kernels in torch's layout (models/convert.py).


def _flax_key(name: str) -> tuple:
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return tuple(parts)


def _to_flax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """A view of `t` in flax's layout (no copy)."""
    if not name.endswith(".weight"):
        return t
    if t.dim() == 4:
        return t.permute(2, 3, 1, 0)  # OIHW -> HWIO
    return t.t() if t.dim() == 2 else t


def _flax_shape(name: str, shape: tuple) -> tuple:
    if not name.endswith(".weight"):
        return shape
    if len(shape) == 4:
        o, i, h, w = shape
        return (h, w, i, o)
    return tuple(reversed(shape)) if len(shape) == 2 else shape


def _from_flax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """A view of flax-layout `t` in the port's layout (no copy)."""
    if not name.endswith(".weight"):
        return t
    if t.dim() == 4:
        return t.permute(3, 2, 0, 1)  # HWIO -> OIHW
    return t.t() if t.dim() == 2 else t


def _as_tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.asarray(leaf))


def _leaf_device(params) -> torch.device:
    """Where the flat vector is assembled: the parameters' one device, or
    the host when they are on several or are numpy arrays."""
    devices = {leaf.device for leaf in params.values()
               if isinstance(leaf, torch.Tensor)}
    return devices.pop() if len(devices) == 1 else torch.device("cpu")


@torch.no_grad()
def flatten_params(params) -> np.ndarray:
    """Flatten a state_dict (tensors on any one device, or numpy arrays) to
    ONE C-contiguous f32 vector in the flax tree's leaf order and layout:
    the unit the broadcast ships, and the JAX package's bytes for the same
    checkpoint. Tensors on the card are laid out on the card and cross to
    the host as one buffer."""
    names = sorted(params, key=_flax_key)
    if not names:
        return np.zeros(0, np.float32)
    dev = _leaf_device(params)
    sizes = [_as_tensor(params[n]).numel() for n in names]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    off = 0
    for name, n in zip(names, sizes):
        leaf = _to_flax_layout(name, _as_tensor(params[name]).to(dev))
        flat[off:off + n].view(leaf.shape).copy_(leaf)
        off += n
    return flat.cpu().numpy()


@torch.no_grad()
def unflatten_params(template, flat: np.ndarray):
    """Rebuild a state_dict with `template`'s names, shapes, layout, dtypes
    and devices from the flat f32 vector (the receiver's own parameters are
    the shape authority: the wire carries no structure, the HELLO model
    signature already pinned it). The vector crosses to the card as one
    buffer; the transposes and casts run there."""
    names = sorted(template, key=_flax_key)
    flat = np.asarray(flat)
    need = sum(_as_tensor(template[n]).numel() for n in names)
    if need > flat.size:
        raise WeightSwapError(
            _ERR, f"flat parameter vector has {flat.size} elements; "
            f"template needs more (truncated publication?)")
    if need != flat.size:
        raise WeightSwapError(
            _ERR, f"flat parameter vector has {flat.size} elements; "
            f"template consumes only {need}")
    src = torch.from_numpy(np.ascontiguousarray(flat, np.float32)).to(
        _leaf_device(template))
    out, off = {}, 0
    for name in names:
        leaf = template[name]
        t = _as_tensor(leaf)
        n = t.numel()
        piece = _from_flax_layout(
            name, src[off:off + n].view(_flax_shape(name, tuple(t.shape))))
        if isinstance(leaf, torch.Tensor):
            res = torch.empty_like(leaf)  # keeps the template's strides
            res.copy_(piece)
        else:
            res = piece.cpu().numpy().astype(np.asarray(leaf).dtype)
        out[name] = res
        off += n
    return {name: out[name] for name in template}


def roundtrip_params(params, codec: str = "bf16"):
    """Params as every rank holds them after a publication under `codec`:
    encode once, decode once, rebuild. The frontend's new PrefillEngine is
    built from this, so prefill and decode tiers stay bitwise identical.
    Under "bf16" the round trip of bf16 parameters is the identity."""
    flat = flatten_params(params)
    wire = transport.codec_encode(flat, codec)
    return unflatten_params(
        params, transport.codec_decode(wire, codec, flat.size))


# The clamps in force in this process (publisher and receivers may be
# threads of one process): the user's own knob comes back only when the
# last of them ends, never while another rendezvous still reads it.
_CLAMP_LOCK = threading.Lock()
_clamps: dict = {"count": 0, "saved": None}


@contextlib.contextmanager
def _bounded_bootstrap(deadline: float):
    """Clamp the rendezvous bootstrap to the remaining swap budget.

    The bootstrap's own default (TPUNET_BOOTSTRAP_TIMEOUT_MS, 120 s) is
    sized for training jobs whose rank 0 may start minutes after its peers.
    A swap's coordinator binds milliseconds after the announce, so a member
    that has not joined within the swap deadline is dead (or the attempt
    was abandoned), and a 120 s park here would wedge the serving loop of
    whoever waits. The native layer reads the knob (process-wide) during
    the rendezvous. Clamps that overlap in one process share it, each
    setting its own budget on entry, and the value from before the first
    comes back when the last one ends."""
    remaining_ms = max(1, int((deadline - time.monotonic()) * 1e3))
    with _CLAMP_LOCK:
        if _clamps["count"] == 0:
            _clamps["saved"] = os.environ.get("TPUNET_BOOTSTRAP_TIMEOUT_MS")
        _clamps["count"] += 1
        os.environ["TPUNET_BOOTSTRAP_TIMEOUT_MS"] = str(remaining_ms)
    try:
        yield
    finally:
        with _CLAMP_LOCK:
            _clamps["count"] -= 1
            if _clamps["count"] == 0:
                if _clamps["saved"] is None:
                    os.environ.pop("TPUNET_BOOTSTRAP_TIMEOUT_MS", None)
                else:
                    os.environ["TPUNET_BOOTSTRAP_TIMEOUT_MS"] = _clamps[
                        "saved"]


def _ephemeral_coordinator(host: str = "127.0.0.1") -> str:
    """A fresh rendezvous address per swap attempt (bind :0, read the port,
    release it): a retry never reuses the previous attempt's coordinator, so
    a receiver stuck in an abandoned rendezvous cannot cross-talk with the
    new one."""
    s = socket.socket()
    try:
        s.bind((host, 0))
        return f"{host}:{s.getsockname()[1]}"
    finally:
        s.close()


# -- receiver (decode rank) --------------------------------------------------


class WeightReceiver:
    """Receive half of one publication on a decode rank.

    The receive itself (the bulk-class comm's rendezvous, every broadcast
    chunk into one buffer, the CRC32C digest and its all-gather) runs on a
    thread of its own, so the owning serve loop never parks on the network:
    a peer that dies while the tree wires its mesh can leave a native
    accept waiting for ever, out of reach of the progress watchdog, and
    that must cost one leaked thread, not the serving loop. ``pump()``
    polls it without blocking; it returns True once the received wire
    passed the fleet-wide CRC gate, and ``stage()`` then decodes it into
    parameters like `template` (the caller runs it where the work does not
    hold its loop). It raises ``WeightSwapError`` on any failure
    (deadline, transport death, digest disagreement) with the comm closed
    and nothing staged: the previous version keeps serving. The bytes and
    the collectives on the wire are the JAX package's."""

    def __init__(self, ann: proto.SwapAnnounce, template, *,
                 corrupt: bool = False):
        self.ann = ann
        self.version = ann.version
        #: Chaos hook ("swap:...:action=corrupt"): flip one byte of the
        #: received wire before digesting; every rank must then refuse.
        self.corrupt = corrupt
        self._template = template
        self._comm: Communicator | None = None
        self._nwire = transport.codec_wire_bytes(ann.codec, ann.nelems)
        self._t_phase = time.monotonic()
        self._deadline = self._t_phase + ann.timeout_ms / 1e3
        self._thread: threading.Thread | None = None
        self._box: dict = {}
        self.wire: np.ndarray | None = None  # the verified wire bytes
        self.staged = None
        self.done = False

    def _lap(self) -> int:
        now = time.monotonic()
        us = int((now - self._t_phase) * 1e6)
        self._t_phase = now
        return us

    def abort(self) -> None:
        """Discard everything; the old version keeps serving. Idempotent.
        A receive thread still parked in the native layer is abandoned
        (its comm closed under it)."""
        if self._comm is not None:
            try:
                self._comm.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
            self._comm = None
        if not self.done:
            self.wire = None
            self.staged = None
            telemetry.swap_event("abort")
            self.done = True

    def _fail(self, msg: str, cause: BaseException | None = None):
        self.abort()
        # Terminal verdict: snapshot the flight recorder at the raise site.
        telemetry.flightrec_dump_verdict("swap_abort")
        err = WeightSwapError(
            _ERR, f"weight swap to version {self.ann.version} aborted: "
            f"{msg} — previous version keeps serving; the publisher "
            f"retries or raises")
        raise err from cause

    def stage(self):
        """Decode the verified wire into a state_dict like the template
        (f32 wire -> template dtype, device and layout); frees the wire."""
        if self.wire is None:
            raise WeightSwapError(
                _ERR, f"weight swap to version {self.ann.version}: nothing "
                f"verified to stage")
        flat = transport.codec_decode(self.wire, self.ann.codec,
                                      self.ann.nelems)
        self.wire = None
        self.staged = unflatten_params(self._template, flat)
        return self.staged

    def _receive(self) -> None:
        """The receive thread: rendezvous, chunks, digest, verdict; the
        outcome lands in self._box."""
        ann, box = self.ann, self._box
        try:
            # Bulk-class comm, explicit exact wire + pinned tree: the
            # broadcast ships pre-encoded bytes, so the comm codec must be
            # the identity whatever TPUNET_WIRE_DTYPE says.
            with _bounded_bootstrap(self._deadline):
                comm = Communicator(ann.coordinator, ann.rank, ann.world,
                                    wire_dtype="f32", algo="tree",
                                    traffic_class=ann.traffic_class)
            self._comm = comm
            if self.done:  # aborted during the rendezvous
                comm.close()
                return
            telemetry.swap_observe("announce", self._lap())
            wire = np.empty(self._nwire, np.uint8)
            step = max(1, ann.chunk_bytes)
            for lo in range(0, max(1, self._nwire), step):
                part = wire[lo:lo + step]
                comm.broadcast(part, root=0, out=part)
            telemetry.swap_observe("broadcast", self._lap())
            if self.corrupt:
                wire[0] ^= 0xFF
            digests = comm.all_gather(
                np.array([transport.crc32c(wire)], np.uint32))
            telemetry.swap_observe("verify", self._lap())
            box["digests"] = [int(d) for d in digests.ravel()]
            box["wire"] = wire
        except BaseException as e:  # noqa: BLE001 — surfaced by pump()
            box["err"] = e

    def pump(self) -> bool:
        """Poll the receive without blocking; True once the wire is
        verified."""
        if self.done:
            return self.wire is not None or self.staged is not None
        if time.monotonic() > self._deadline:
            self._fail(f"deadline exceeded (TPUNET_SWAP_TIMEOUT_MS="
                       f"{self.ann.timeout_ms})")
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._receive, daemon=True,
                name=f"tpunet-receive-v{self.version}")
            self._thread.start()
            return False
        if self._thread.is_alive():
            return False
        box = self._box
        if "err" in box:
            e = box["err"]
            if isinstance(e, WeightSwapError):
                self.abort()
                raise e
            self._fail(f"transport failure mid-broadcast ({e})", e)
        if len(set(box["digests"])) != 1:
            telemetry.swap_event("mismatch")
            self._fail(
                "cross-rank CRC32C digest disagreement "
                f"({[hex(d) for d in box['digests']]}) — flip refused "
                "FLEET-WIDE (every rank computed this same verdict locally)")
        self.wire = box.pop("wire")
        self.done = True
        comm, self._comm = self._comm, None
        comm.close()
        return True


# -- publisher (frontend) ----------------------------------------------------


class WeightPublisher:
    """Frontend half: announce, broadcast, verify, await flips, install.

    Drives one publication at a time against the owning ``Router``'s live
    rank pool. ``publish()`` blocks until the whole fleet flipped, calling
    `pump` (default ``router.poll``) while the broadcast runs and while it
    awaits the flips, so the latency tier keeps draining; it retries up to
    `retries` times on a typed abort, and retains the encoded wire so
    ``catch_up()`` can re-publish to a rank that rejoins stale."""

    def __init__(self, router, *, codec: str = "bf16",
                 timeout_ms: int | None = None,
                 chunk_bytes: int | None = None,
                 publish_class: str | None = None,
                 coordinator_host: str = "127.0.0.1"):
        from tpunet_torch.config import Config

        cfg = Config.from_env()
        if codec not in ("f32", "bf16"):
            raise ValueError(
                f"weight wire codec must be f32 or bf16, got {codec!r} "
                f"(int8 KV blocks carry per-block scales; whole-checkpoint "
                f"int8 does not)")
        refuse_mesh(getattr(getattr(router, "prefill", None), "model", None),
                    "WeightPublisher")
        self.router = router
        self.codec = codec
        self.timeout_ms = int(timeout_ms or cfg.swap_timeout_ms)
        self.chunk_bytes = int(chunk_bytes or cfg.swap_chunk_bytes)
        self.publish_class = publish_class or cfg.publish_class
        self._host = coordinator_host
        self._retained: tuple[int, np.ndarray, int] | None = None
        # Attempt sequence: BEGIN/STATUS frames carry (seq << 32) | version
        # as their req_id, so a late aborted-status from an abandoned
        # attempt can never poison the retry that superseded it.
        self._seq = 0
        #: The live attempt's phase: None when idle, else "announce" ->
        #: "broadcast" -> "verify" -> "flip". Written by the publishing
        #: threads, safe to read from anywhere (harnesses schedule chaos
        #: by it).
        self.phase: str | None = None
        self.stats = {"publishes": 0, "commits": 0, "aborts": 0,
                      "retries": 0, "catch_ups": 0}

    # -- one attempt ---------------------------------------------------------

    def _settle(self, pump, window_s: float = 0.1) -> None:
        """Pump long enough for the transport engine to surface a dead
        peer's EOF on its tier link (~10 ms on loopback; the window is 10x
        that), so the next attempt's target set excludes ranks that died
        during the failed one. Re-announcing to a corpse would park the
        rendezvous on the bootstrap timeout."""
        t_end = time.monotonic() + window_s
        while time.monotonic() < t_end:
            pump()
            time.sleep(0.002)

    def _broadcast_to(self, targets, version: int, token: int,
                      wire: np.ndarray, nelems: int, deadline: float,
                      pump, comm_box: dict | None = None) -> None:
        """Announce + bulk-class tree broadcast + CRC all-gather against
        `targets` (live ranks). Raises WeightSwapError on any failure.
        `comm_box`, when given, exposes the live comm under "comm" so a
        supervising thread can force-close it past the deadline."""
        self.phase = "announce"
        t_phase = time.monotonic()
        world = len(targets) + 1
        coord = _ephemeral_coordinator(self._host)
        _dbg(f"announce targets={[r.index for r in targets]} coord={coord} "
             f"version={version}")
        for i, rank in enumerate(targets):
            ann = proto.SwapAnnounce(
                version, world, i + 1, nelems, self.chunk_bytes, self.codec,
                self.timeout_ms, coord, traffic_class=self.publish_class)
            try:
                rank.link.send_frame(proto.T_SWAP_BEGIN, token,
                                     proto.pack_swap_begin(ann))
            except (_native.NativeError, TimeoutError, OSError) as e:
                self.router._fail_rank(rank, e)
                raise WeightSwapError(
                    _ERR, f"swap announce to decode rank {rank.index} "
                    f"failed ({e}) — rank reaped, publication aborted"
                ) from e
        comm = None
        try:
            with _bounded_bootstrap(deadline):
                comm = Communicator(coord, 0, world, wire_dtype="f32",
                                    algo="tree",
                                    traffic_class=self.publish_class)
            if comm_box is not None:
                comm_box["comm"] = comm
            self.phase = "broadcast"
            telemetry.swap_observe(
                "announce", int((time.monotonic() - t_phase) * 1e6))
            t_phase = time.monotonic()
            nwire = int(wire.size)
            nchunks = max(1, -(-nwire // max(1, self.chunk_bytes)))
            for c in range(nchunks):
                if time.monotonic() > deadline:
                    raise WeightSwapError(
                        _ERR, f"weight broadcast exceeded "
                        f"TPUNET_SWAP_TIMEOUT_MS={self.timeout_ms} at chunk "
                        f"{c}/{nchunks}")
                lo = c * self.chunk_bytes
                comm.broadcast(wire[lo:lo + self.chunk_bytes], root=0)
                _dbg(f"chunk {c}/{nchunks} sent")
                pump()  # the latency tier keeps draining between chunks
            self.phase = "verify"
            telemetry.swap_observe(
                "broadcast", int((time.monotonic() - t_phase) * 1e6))
            t_phase = time.monotonic()
            digests = comm.all_gather(
                np.array([transport.crc32c(wire)], np.uint32))
            telemetry.swap_observe(
                "verify", int((time.monotonic() - t_phase) * 1e6))
            if len({int(d) for d in digests.ravel()}) != 1:
                telemetry.swap_event("mismatch")
                raise WeightSwapError(
                    _ERR, "cross-rank CRC32C digest disagreement "
                    f"({[hex(int(d)) for d in digests.ravel()]}) — flip "
                    "refused FLEET-WIDE; no rank staged these bytes")
        except _native.NativeError as e:
            if isinstance(e, WeightSwapError):
                raise
            raise WeightSwapError(
                _ERR, f"weight broadcast to version {version} failed "
                f"mid-flight ({e}) — receivers abort and keep serving the "
                f"previous version") from e
        finally:
            if comm is not None:
                comm.close()

    def _supervised_cast(self, targets, version: int, token: int,
                         wire: np.ndarray, nelems: int, deadline: float,
                         pump) -> None:
        """Run ``_broadcast_to`` on a background thread while this thread
        keeps pumping the serve loop. Past the deadline, or once a target
        rank has died (the router reaped its link: the attempt cannot
        verify any more), the live comm is force-closed under the thread;
        if the native layer still has not surfaced an error a grace window
        later, the daemon thread is abandoned and the attempt raises typed.
        The abandoned attempt's token is superseded by the retry's, so a
        zombie that reports late cannot poison a later attempt."""
        cast_box: dict = {}

        def _run_broadcast() -> None:
            try:
                self._broadcast_to(targets, version, token, wire, nelems,
                                   deadline, pump=lambda: None,
                                   comm_box=cast_box)
                cast_box["ok"] = True
            except BaseException as e:  # noqa: BLE001 — re-raised below
                cast_box["err"] = e

        caster = threading.Thread(
            target=_run_broadcast,
            name=f"tpunet-publish-v{version}", daemon=True)
        caster.start()
        closed = False
        stop_at, why = deadline, (f"past TPUNET_SWAP_TIMEOUT_MS="
                                  f"{self.timeout_ms}")
        while caster.is_alive():
            now = time.monotonic()
            dead = sorted(r.index for r in targets if not r.alive)
            if dead and stop_at > now:
                stop_at, why = now, f"after decode rank(s) {dead} died"
            if now > stop_at and not closed:
                # The thread checks the deadline between chunks but can park
                # inside a blocking collective; closing the comm under it
                # fails that op fast.
                comm = cast_box.get("comm")
                if comm is not None:
                    closed = True
                    try:
                        comm.close()
                    except Exception:  # noqa: BLE001 — teardown
                        pass
            if now > stop_at + _CAST_ABANDON_GRACE_S:
                _dbg(f"abandoning parked broadcast thread for v{version}")
                raise WeightSwapError(
                    _ERR, f"weight broadcast to version {version} still "
                    f"parked {_CAST_ABANDON_GRACE_S:.0f}s {why} with its "
                    f"comm closed — native collective wedged (peer died "
                    f"mid-operation); thread abandoned, attempt aborted")
            pump()
            time.sleep(0.001)
        caster.join()
        if "err" in cast_box:
            raise cast_box["err"]

    def _await_flips(self, targets, version: int, token: int,
                     deadline: float, pump) -> None:
        """Poll the router until every surviving target reported FLIPPED
        for this attempt's token. An ABORTED verdict or a fully dead target
        set raises; a target that dies after the broadcast is dropped from
        the wait (it is caught up on re-admission)."""
        want = {rank.index: rank for rank in targets}
        while True:
            pump()
            status = self.router._swap_status
            aborted = sorted(
                i for i in want if status.get((i, token)) == "aborted")
            if aborted:
                raise WeightSwapError(
                    _ERR, f"decode rank(s) {aborted} aborted the swap to "
                    f"version {version} — flip refused fleet-wide")
            alive = {i for i, rank in want.items() if rank.alive}
            if not alive:
                raise WeightSwapError(
                    _ERR, f"every announced decode rank died during the "
                    f"swap to version {version}")
            if all(status.get((i, token)) == "flipped" for i in alive):
                return
            if time.monotonic() > deadline:
                missing = sorted(
                    i for i in alive
                    if status.get((i, token)) != "flipped")
                raise WeightSwapError(
                    _ERR, f"decode rank(s) {missing} did not flip to "
                    f"version {version} within TPUNET_SWAP_TIMEOUT_MS="
                    f"{self.timeout_ms}")
            time.sleep(0.001)

    # -- public surface ------------------------------------------------------

    def publish(self, version: int, params, *, retries: int = 2,
                pump=None, warm_lengths=()) -> None:
        """Publish checkpoint `version` (a state_dict shaped like the
        serving model's) to every live decode rank and install the matching
        roundtripped PrefillEngine frontend-side. Blocks until the fleet
        flipped; on a typed abort the whole attempt retries (fresh
        coordinator, reaped ranks dropped) up to `retries` times. The old
        version keeps serving throughout and drains under session pinning
        before it retires. `warm_lengths` runs the new prefill at those
        prompt lengths before it goes live."""
        if version <= self.router.version:
            raise ValueError(
                f"published version must increase: {version} <= current "
                f"{self.router.version}")
        pump = pump or self.router.poll
        # This thread never stops pumping: the flatten and encode (the whole
        # checkpoint copied off the card), the bulk transfer and the
        # frontend engine's build (the wire decoded back, the parameters
        # rebuilt on the card, the warm-up prefills) run on background
        # threads. The builder starts once, outside the retry loop: the
        # engine depends only on the verified bytes, not on which attempt
        # delivered them.
        enc: dict = {}

        def _encode() -> None:
            try:
                flat = flatten_params(params)
                enc["nelems"] = int(flat.size)
                enc["wire"] = transport.codec_encode(flat, self.codec)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                enc["err"] = e

        encoder = threading.Thread(target=_encode, daemon=True,
                                   name=f"tpunet-encode-v{version}")
        encoder.start()
        while encoder.is_alive():
            pump()
            time.sleep(0.001)
        encoder.join()
        if "err" in enc:
            raise enc["err"]
        wire, nelems = enc["wire"], enc["nelems"]
        t_flip = time.monotonic()
        old = self.router.prefill
        box: dict = {}

        def _build_and_warm() -> None:
            try:
                rt = unflatten_params(params, transport.codec_decode(
                    wire, self.codec, nelems))
                engine = PrefillEngine(
                    old.model, rt, max_len=old.max_len,
                    prefill_chunk=getattr(old, "_chunk", None),
                    device=getattr(old, "device", None))
                for plen in warm_lengths:
                    engine.prefill(np.zeros(int(plen), np.int32))
                box["engine"] = engine
            except BaseException as e:  # noqa: BLE001 — typed below
                box["err"] = e

        builder = threading.Thread(
            target=_build_and_warm,
            name=f"tpunet-prefill-v{version}", daemon=True)
        builder.start()
        attempt = 0
        while True:
            self.stats["publishes"] += 1
            telemetry.swap_event("publish")
            self._seq += 1
            token = (self._seq << 32) | version
            deadline = time.monotonic() + self.timeout_ms / 1e3
            try:
                targets = [r for r in self.router._ranks if r.alive]
                if not targets:
                    raise WeightSwapError(
                        _ERR, "no live decode rank to publish to")
                self._supervised_cast(targets, version, token, wire,
                                      nelems, deadline, pump)
                self._await_flips(targets, version, token, deadline, pump)
                self.phase = "flip"
                while builder.is_alive():
                    if time.monotonic() > deadline:
                        raise WeightSwapError(
                            _ERR, f"prefill build/warm for version "
                            f"{version} exceeded TPUNET_SWAP_TIMEOUT_MS="
                            f"{self.timeout_ms}")
                    pump()
                    time.sleep(0.001)
                builder.join()
                if "err" in box:
                    raise WeightSwapError(
                        _ERR, f"prefill build/warm for version {version} "
                        f"failed ({box['err']})") from box["err"]
                self.router.install_version(version, box["engine"])
                telemetry.swap_observe(
                    "flip", int((time.monotonic() - t_flip) * 1e6))
                telemetry.swap_event("commit")
                self.stats["commits"] += 1
                self._retained = (version, wire, nelems)
                self.phase = None
                return
            except WeightSwapError as e:
                _dbg(f"attempt {attempt} failed: {e}")
                self.phase = None
                self.stats["aborts"] += 1
                attempt += 1
                if attempt > retries:
                    # Terminal (retries exhausted): snapshot the flight
                    # recorder at the raise site.
                    telemetry.flightrec_dump_verdict("swap_deadline")
                    raise
                telemetry.swap_event("retry")
                self.stats["retries"] += 1
                self._settle(pump)  # reap dead links before re-announcing

    def catch_up(self, *, pump=None) -> int:
        """Re-publish the retained current checkpoint to every live rank
        that serves an older version (a host re-admitted after dying
        mid-swap announces its stale version in the HELLO). Each stale rank
        gets its own world=2 broadcast of the same retained wire, so the
        catch-up flip passes the same CRC gate. The stale versions it held
        are then retired like any drained version. Returns the number of
        ranks caught up; raises WeightSwapError if a catch-up aborts."""
        if self._retained is None:
            return 0
        version, wire, nelems = self._retained
        pump = pump or self.router.poll
        self._settle(pump)  # catch-up usually follows churn: reap first
        try:
            return self._catch_up_inner(version, wire, nelems, pump, 0)
        finally:
            self.phase = None

    def _catch_up_inner(self, version, wire, nelems, pump,
                        caught: int) -> int:
        for rank in list(self.router._ranks):
            if not rank.alive or version in rank.versions:
                continue
            deadline = time.monotonic() + self.timeout_ms / 1e3
            telemetry.swap_event("publish")
            self._seq += 1
            token = (self._seq << 32) | version
            self._supervised_cast([rank], version, token, wire, nelems,
                                  deadline, pump)
            self._await_flips([rank], version, token, deadline, pump)
            # The stale versions pin no admitted request (the router
            # admits under its current version only): retire them there.
            self.router._retire_pending.update(rank.versions - {version})
            telemetry.swap_event("commit")
            self.stats["catch_ups"] += 1
            caught += 1
        return caught
