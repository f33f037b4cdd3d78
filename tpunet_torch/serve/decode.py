"""Decode tier: the BatchServer slot machine fed by shipped KV blocks.

A DecodeWorker owns one BatchServer per resident checkpoint version and one
FrameLink to the frontend. Its serve loop is single-threaded and
non-blocking: drain arriving BLOCK frames (decode the KV wire,
``submit_kv``; never a re-prefill), advance every live slot one window,
then report: a FIRST frame the moment a request's first token commits (the
router's TTFT stamp) and a RESULT frame with the whole token array and the
measured TPOT when it retires. Requests are never streamed token by token,
so a decode rank that dies cannot truncate or corrupt a stream: the router
replays it elsewhere.

**Live weight updates** ride the same loop: a T_SWAP_BEGIN frame arms a
``WeightReceiver``, which receives on a thread of its own and is polled
once per pass (the bulk-class broadcast never parks the loop). Once the
received bytes pass the fleet-wide CRC gate, a background thread decodes
them into parameters on the card, builds the new version's BatchServer
(its own bound copy of the model) and drives one throwaway request through
it while the old version keeps serving; the flip lands between loop
passes, a request boundary by construction. Each in-flight request stays pinned to the version that
prefilled it (the T_BLOCK aux word); old versions serve their pinned
sessions until the frontend's T_SWAP_RETIRE and the local drain both say
they are done. Any swap failure reports SWAP_ABORTED and the previous
version keeps serving.

**On a mesh model** the worker is a tp group of ranks (``serve.group``):
the leader owns the link and, on every pass that does work, broadcasts a
header (blocks, step or not, stop, the KV codec) and the raw BLOCK
payloads it ingested; each follower (``follow``, ``follow_decode``) runs
the same ``unpack_block`` -> ``decode_kv_block`` -> ``submit_kv`` and the
same steps, so every rank's BatchServer admits the same requests in the
same order. Only the leader reports; an idle pass broadcasts nothing. The
leader's ``close()`` releases its followers, and a leader that fails
releases them with the error. Not ported (ROADMAP A.12b): a live swap
into a group (a SWAP_BEGIN raises), and a follower's death, which ends
the group at its next collective.
"""

from __future__ import annotations

import contextlib
import os
import signal
import struct
import threading
import time
from functools import partial

import numpy as np

from tpunet_torch import telemetry, transport
from tpunet_torch.models.serve import BatchServer, refuse_mesh
from tpunet_torch.serve import kv as kv_mod
from tpunet_torch.serve import protocol as proto
from tpunet_torch.serve import publish as publish_mod
from tpunet_torch.serve.group import tier_group
from tpunet_torch.serve.publish import WeightReceiver, WeightSwapError

# The stop word of a decode group's pass header: the leader closed, or it
# failed (its followers raise).
_STOP_CLOSE, _STOP_FAILED = 1, 2


class DecodeWorker:
    """Serve loop around per-version BatchServers for one decode rank."""

    def __init__(self, model, params, link: proto.FrameLink, *,
                 slots: int, max_len: int, kv_codec: str = "int8",
                 weight_version: int = 0, **server_kwargs):
        if kv_codec not in kv_mod.KV_CODECS:
            raise ValueError(f"unknown KV wire codec {kv_codec!r}")
        self.group = tier_group(model)
        if self.group is not None and (link is None) == self.group.leader:
            raise ValueError("the leader of a decode group owns its link; "
                             "its followers have none")
        self._net = None  # set by connect(): the engine this worker owns
        self.link = link
        self.kv_codec = kv_codec
        self._model = model
        self._slots = slots
        self._max_len = max_len
        self._server_kwargs = server_kwargs
        self.version = int(weight_version)
        self._params = {self.version: params}
        self._servers = {
            self.version: self._build_server(self.version, params)}
        # (version, local id) -> router req id: BatchServer local ids
        # restart at 0 per instance, so the version is part of the key.
        self._router_id: dict[tuple[int, int], int] = {}
        self._t_first: dict[tuple[int, int], float] = {}
        self._first_pending: list[tuple[int, int]] = []
        # Live-swap state: the pumped receiver, the background build/warm
        # of the next server, versions the frontend says may retire, and
        # the scripted-chaos step counter.
        self._receiver: WeightReceiver | None = None
        self._receiver_token = 0
        self._flip = None  # (version, token, thread, result box, t0)
        self._retiring: set[int] = set()
        self._corrupt_next = False
        self._swap_step = 0
        self.stats = {"blocks": 0, "results": 0, "swaps": 0,
                      "swap_aborts": 0}
        self._released = False
        if self.group is not None:
            # A running CRC32C of every finished request (local id, tokens)
            # in finish order: the ranks of a group must agree on it.
            self.stats["tokens_crc"] = 0
            shapes = self.group.gather(np.array([slots, max_len], np.int64))
            if (shapes != shapes[0]).any():
                raise ValueError(f"the ranks of a decode group disagree on "
                                 f"(slots, max_len): {shapes.tolist()}")
        telemetry.weight_version(self.version)

    @property
    def srv(self) -> BatchServer:
        """The current version's server (pinned traffic may still run on
        older resident versions)."""
        return self._servers[self.version]

    def _build_server(self, version: int, params) -> BatchServer:
        return BatchServer(self._model, params, slots=self._slots,
                           max_len=self._max_len,
                           on_first_token=partial(self._on_first, version),
                           **self._server_kwargs)

    def _on_first(self, version: int, local_id: int) -> None:
        self._t_first[(version, local_id)] = time.monotonic()
        self._first_pending.append((version, local_id))

    # -- frame ingestion -----------------------------------------------------

    def _admit(self, payload: bytes, ver: int, rid: int = 0) -> int:
        """One BLOCK payload into version `ver`'s server; its local id."""
        prompt, max_new, n_kv, logits, wire = proto.unpack_block(
            payload, self.kv_codec)
        srv = self._servers[ver]
        shapes = srv.kv_leaf_shapes(len(prompt))
        if kv_mod.kv_block_elems(shapes) != n_kv:
            raise proto.TierProtocolError(
                f"BLOCK for request {rid} carries {n_kv} KV "
                f"elements; this model/prompt-length expects "
                f"{kv_mod.kv_block_elems(shapes)}")
        rows = kv_mod.decode_kv_block(wire, self.kv_codec, shapes)
        self.stats["blocks"] += 1
        return srv.submit_kv(prompt, max_new, rows, logits)

    def _ingest(self) -> tuple[bool, bool, list[bytes]]:
        """Drain available frames; returns (progressed, shutdown_seen, the
        BLOCK payloads admitted, kept for a group's followers)."""
        progressed = shutdown = False
        blocks = []
        while True:
            frame = self.link.poll()
            if frame is None:
                return progressed, shutdown, blocks
            progressed = True
            ftype, rid, payload, aux = frame
            if ftype == proto.T_BLOCK:
                # aux pins the request to the version that prefilled it;
                # fall back to current if that version already retired here
                # (the router places onto resident versions; this keeps a
                # request from being dropped when none holds it).
                ver = aux if aux in self._servers else self.version
                self._router_id[(ver, self._admit(payload, ver, rid))] = rid
                if self.group is not None:
                    blocks.append(payload)
            elif ftype == proto.T_SWAP_BEGIN:
                refuse_mesh(self._model, "a live weight swap (SWAP_BEGIN)")
                self._begin_swap(rid, payload)
            elif ftype == proto.T_SWAP_RETIRE:
                self._retiring.add(aux)
            elif ftype == proto.T_SHUTDOWN:
                shutdown = True
            else:
                raise proto.TierProtocolError(
                    f"decode tier got unexpected frame type {ftype}")

    def _digest(self, finished: list[dict]) -> None:
        if self.group is not None:
            for rec in finished:
                self.stats["tokens_crc"] = transport.crc32c(
                    struct.pack("<q", rec["id"]) + rec["tokens"].tobytes(),
                    self.stats["tokens_crc"])

    def _step(self) -> list[tuple[int, list[dict]]]:
        """One window of every resident version with work, as (version,
        finished) pairs."""
        guard = (self.group.tp_only() if self.group is not None
                 else contextlib.nullcontext())
        out = []
        with guard:
            for ver, srv in list(self._servers.items()):
                if srv._live or srv._pending:
                    out.append((ver, srv.step()))
                    self._digest(out[-1][1])
        return out

    def _has_work(self) -> bool:
        return any(s._live or s._pending for s in self._servers.values())

    # -- a decode group ------------------------------------------------------

    def _send_pass(self, blocks: list[bytes], step: bool) -> None:
        """The leader's pass over its group: the header, then the payloads'
        lengths and bytes."""
        self.group.bcast(np.array(
            [len(blocks), int(step), 0, kv_mod.KV_CODECS.index(self.kv_codec)],
            np.int64))
        if blocks:
            self.group.bcast(np.array([len(b) for b in blocks], np.int64))
            self.group.bcast(np.frombuffer(b"".join(blocks), np.uint8))

    def _release(self, stop: int) -> None:
        """Stop the group's followers (once)."""
        if self.group is None or not self.group.leader or self._released:
            return
        self._released = True
        self.group.bcast(np.array([0, 0, stop, 0], np.int64))

    def follow(self) -> None:
        """A follower's loop: repeat each pass of the leader (its blocks,
        then its step) until it closes; raises ServeError when the leader
        failed."""
        if self.group is None or self.group.leader:
            raise RuntimeError("follow() runs on the followers of a mesh "
                               "model's tp group")
        while True:
            n, step, stop, codec = (int(x) for x in self.group.bcast(
                np.zeros(4, np.int64)))
            if stop:
                self._released = True
                if stop == _STOP_FAILED:
                    raise proto.ServeError(
                        "the leader of this decode group failed")
                return
            self.kv_codec = kv_mod.KV_CODECS[codec]
            if n:
                lens = self.group.bcast(np.zeros(n, np.int64))
                data = self.group.bcast(np.zeros(int(lens.sum()), np.uint8))
                off = 0
                for m in lens.tolist():
                    self._admit(data[off:off + m].tobytes(), self.version)
                    off += m
            if step:
                self._step()
            self._first_pending.clear()  # only the leader reports
            self._t_first.clear()

    def _report(self, finished_by_ver: list[tuple[int, list[dict]]]) -> None:
        # FIRST frames go out before any RESULT so the router's TTFT stamp
        # for a request always precedes its completion.
        for key in self._first_pending:
            rid = self._router_id.get(key)
            if rid is not None:
                self.link.send_frame(proto.T_FIRST, rid)
        self._first_pending.clear()
        for ver, finished in finished_by_ver:
            for rec in finished:
                rid = self._router_id.pop((ver, rec["id"]), None)
                if rid is None:
                    continue  # the warm-up request, or a replayed one
                t_first = self._t_first.pop((ver, rec["id"]), None)
                ntok = len(rec["tokens"])
                tpot_us = 0
                if t_first is not None and ntok > 1:
                    tpot_us = int(
                        (time.monotonic() - t_first) / (ntok - 1) * 1e6)
                self.link.send_frame(
                    proto.T_RESULT, rid,
                    proto.pack_result(rec["tokens"], 0, tpot_us))
                self.stats["results"] += 1

    # -- live weight updates -------------------------------------------------

    def _begin_swap(self, token: int, payload: bytes) -> None:
        ann = proto.unpack_swap_begin(payload)
        if self._receiver is not None:
            # A retry superseded the in-flight attempt: drop it silently
            # (the publisher already abandoned its token).
            self._receiver.abort()
            self.stats["swap_aborts"] += 1
        self._receiver = WeightReceiver(
            ann, self._params[self.version], corrupt=self._corrupt_next)
        self._receiver_token = token
        self._corrupt_next = False

    def _status(self, token: int, verdict: int) -> None:
        try:
            self.link.send_frame(proto.T_SWAP_STATUS, token, aux=verdict)
        except Exception:  # noqa: BLE001 — a dead frontend ends us anyway
            pass

    def _pump_swap(self) -> bool:
        """One poll of the live swap per loop pass (the receive and the
        build run on threads of their own); True when it moved on. Never
        raises: a failed swap reports ABORTED and the old version keeps
        serving."""
        progressed = False
        if self._receiver is not None:
            recv, token = self._receiver, self._receiver_token
            try:
                ready = recv.pump()
            except WeightSwapError:
                self._receiver = None
                self.stats["swap_aborts"] += 1
                self._status(token, proto.SWAP_ABORTED)
                return True
            progressed = ready
            if ready:
                # Verified bytes: stage, build and warm the new server on a
                # background thread so the old version keeps serving. The
                # flip itself lands in _pump_swap on a later pass: a
                # request boundary.
                self._receiver = None
                box: dict = {}
                thread = threading.Thread(
                    target=self._build_and_warm,
                    args=(recv.version, recv, box),
                    name=f"tpunet-flip-v{recv.version}", daemon=True)
                thread.start()
                self._flip = (recv.version, token, thread, box,
                              time.monotonic())
        if self._flip is not None and not self._flip[2].is_alive():
            version, token, thread, box, t0 = self._flip
            thread.join()
            self._flip = None
            progressed = True
            if "err" in box:
                self.stats["swap_aborts"] += 1
                telemetry.swap_event("abort")
                self._status(token, proto.SWAP_ABORTED)
            else:
                self._servers[version] = box["srv"]
                self._params[version] = box["params"]
                self.version = version
                telemetry.weight_version(version)
                telemetry.swap_observe(
                    "flip", int((time.monotonic() - t0) * 1e6))
                telemetry.swap_event("commit")
                self.stats["swaps"] += 1
                self._status(token, proto.SWAP_FLIPPED)
        return progressed

    def _build_and_warm(self, version: int, recv: WeightReceiver,
                        box: dict) -> None:
        """Background thread: decode the verified wire into parameters on
        the card, build the next version's BatchServer and drive one
        throwaway request through it, so its adopt and decode paths have
        run (kernels loaded, allocator warm) before the flip."""
        try:
            params = recv.stage()
            srv = self._build_server(version, params)
            plen = 1
            rows = [np.zeros(s, np.float32)
                    for s in srv.kv_leaf_shapes(plen)]
            logits = np.zeros(self._model.vocab, np.float32)
            srv.submit_kv(np.zeros(plen, np.int32), 4, rows, logits)
            while srv._live or srv._pending:
                srv.step()  # the finished dummy has no router id: dropped
            box["srv"] = srv
            box["params"] = params
        except BaseException as e:  # noqa: BLE001 — surfaced as ABORTED
            box["err"] = e

    def _poll_chaos(self) -> None:
        """Scripted swap chaos (swap:at_step=N:action=...): the decode side
        answers "die" (SIGKILL mid-swap: the router replays, the publisher
        aborts and retries) and "corrupt" (flip a received byte: the CRC
        gate must refuse fleet-wide). "publish" verdicts belong to the
        frontend and are ignored here."""
        self._swap_step += 1
        action = publish_mod.swap_action(self._swap_step)
        if action == "die":
            os.kill(os.getpid(), signal.SIGKILL)
        elif action == "corrupt":
            if self._receiver is not None and not self._receiver.done:
                self._receiver.corrupt = True
            else:
                self._corrupt_next = True

    def _retire_drained(self) -> None:
        """Drop retired versions once both the frontend said retire and no
        local request is still pinned to them."""
        for ver in list(self._retiring):
            if ver == self.version:
                self._retiring.discard(ver)  # never retire the live one
                continue
            srv = self._servers.get(ver)
            if srv is None:
                self._retiring.discard(ver)
                continue
            if (srv._live or srv._pending
                    or any(k[0] == ver for k in self._router_id)):
                continue  # still draining its pinned sessions
            self._servers.pop(ver)
            self._params.pop(ver, None)
            self._retiring.discard(ver)

    # -- the loop ------------------------------------------------------------

    def serve(self, *, idle_timeout: float | None = None,
              poll_interval: float = 0.001,
              max_blocks: int | None = None) -> None:
        """Run until a SHUTDOWN frame arrives and every live request has
        reported (or `idle_timeout` seconds pass with no traffic).
        `max_blocks` returns after ingesting that many KV blocks without
        draining (a chaos control). Each pass: scripted chaos, ingest, one
        window of every resident version, report, a poll of the live swap,
        retire drained versions. Transport errors propagate; the leader
        of a decode group releases its followers before it raises."""
        try:
            self._serve(idle_timeout, poll_interval, max_blocks)
        except BaseException:
            if self.group is not None:
                with contextlib.suppress(Exception):
                    self._release(_STOP_FAILED)
            raise

    def _serve(self, idle_timeout, poll_interval, max_blocks) -> None:
        draining = False
        idle_since = time.monotonic()
        while True:
            self._poll_chaos()
            progressed, shutdown, blocks = self._ingest()
            draining = draining or shutdown
            done = (max_blocks is not None
                    and self.stats["blocks"] >= max_blocks)
            step = not done and self._has_work()
            if self.group is not None and (blocks or step):
                self._send_pass(blocks, step)
            if done:
                return
            finished_by_ver = self._step() if step else []
            progressed |= step
            if finished_by_ver or self._first_pending:
                self._report(finished_by_ver)
            progressed |= self._pump_swap()
            self._retire_drained()
            telemetry.serve_queue_depth(
                "decode", sum(len(s._live) + len(s._pending)
                              for s in self._servers.values()))
            if draining and not self._has_work():
                return
            if (progressed or self._receiver is not None
                    or self._flip is not None):
                idle_since = time.monotonic()  # a live swap is not idle
            elif (idle_timeout is not None
                    and time.monotonic() - idle_since > idle_timeout):
                return
            if not progressed:
                time.sleep(poll_interval)

    def close(self) -> None:
        """Release a group's followers, abort a live weight receiver, then
        tear down the link (and the engine, when this worker owns it)."""
        self._release(_STOP_CLOSE)
        if self._receiver is not None:
            self._receiver.abort()
            self._receiver = None
        if self.link is not None:
            self.link.close()
        if self._net is not None:
            self._net.close()
            self._net = None


def connect(addr, model, params, *, slots: int, max_len: int,
            kv_codec: str | None = None, timeout: float = 60.0,
            net: transport.Net | None = None, weight_version: int = 0,
            **server_kwargs) -> DecodeWorker:
    """Wire this process to a frontend at `addr` ("host:port" or tuple) as
    a decode rank and return the ready DecodeWorker. `kv_codec` None
    defers to TPUNET_KV_WIRE_DTYPE (default int8). `weight_version` rides
    the HELLO: a stale value (re-admission after dying mid-swap) is not a
    mismatch; the publisher catches the rank up. `server_kwargs` go to
    every BatchServer (`device=` among them). On a mesh model only the
    leader of the tp group connects; its followers call
    ``follow_decode``."""
    from tpunet_torch.config import Config

    group = tier_group(model)
    if group is not None and not group.leader:
        raise ValueError("connect_decode runs on the leader of a decode "
                         "group (tp index 0); its followers call "
                         "follow_decode")
    if kv_codec is None:
        kv_codec = Config.from_env().kv_wire_dtype
    owns_net = net is None
    # Latency-class link: FIRST/RESULT frames are the router's TTFT signal.
    net = net or transport.Net(traffic_class="latency")
    hello = proto.Hello(proto.ROLE_DECODE, kv_codec, slots, max_len,
                        model.vocab, kv_mod.model_signature(model),
                        weight_version=weight_version)
    link = proto.wire_decode(addr, net, hello, timeout=timeout)
    worker = DecodeWorker(model, params, link, slots=slots, max_len=max_len,
                          kv_codec=kv_codec, weight_version=weight_version,
                          **server_kwargs)
    if owns_net:
        worker._net = net
    return worker


def follow_decode(model, params, *, slots: int, max_len: int,
                  **server_kwargs) -> DecodeWorker:
    """A follower of a mesh model's decode group: build its worker (the
    same `slots`, `max_len` and server options as the leader's ``connect``)
    and repeat the leader's passes until it closes; returns the worker."""
    group = tier_group(model)
    if group is None or group.leader:
        raise ValueError("follow_decode runs on the followers of a mesh "
                         "model's tp group; the leader calls connect_decode")
    worker = DecodeWorker(model, params, None, slots=slots, max_len=max_len,
                          **server_kwargs)
    worker.follow()
    return worker
