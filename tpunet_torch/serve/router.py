"""Frontend tier: request admission, placement, and failure containment.

The Router owns the PrefillEngine and one FrameLink per decode rank:

**Admission + backpressure.** ``submit()`` raises RouterBusyError when
every decode slot is occupied AND the admission queue is at its limit: a
typed, retryable signal instead of unbounded queue growth.

**Placement.** Dispatch picks the decode rank with the most free slots
("least_loaded", default) or cycles ("round_robin", TPUNET_ROUTER_POLICY).
Prefill runs at dispatch, the KV block is encoded once, and the encoded
frame is what ships.

**Failure containment.** A decode rank that errors is marked dead and every
request in flight on it is re-queued at the front and replayed on a
surviving rank: from the retained encoded KV block when ``retain_kv=True``
(no second prefill), else by re-prefilling. Results are released only as
whole token arrays, so a rank death delays a response but never truncates
it.

**SLO observability.** TTFT (admission -> FIRST frame) feeds
``tpunet_req_ttft_us``, the decode-measured TPOT of each RESULT frame
``tpunet_req_tpot_us``, and the router/prefill queue depths
``tpunet_serve_queue_depth``.

**Re-admission.** ``enable_readmission`` keeps the wiring port open: a
recovered decode host reconnects through the full hello handshake and
re-enters the placement pool (``poll_admissions``, which ``run()`` calls
every ``TPUNET_READMIT_PROBE_MS``), counted in ``stats["readmissions"]``
and ``tpunet_churn_events_total{kind="readmit"}``; a host whose model
signature or codec drifted is refused with a typed TierMismatchError. With
re-admission armed, losing every decode rank parks the queue until a host
comes back instead of raising.

**Live weight updates.** Each request is pinned at admission to the
checkpoint version current then: it prefills on that version's engine,
ships with the version in the BLOCK frame's aux word, and is placed (and
replayed) on a rank where that version is resident. ``install_version``
(called by the WeightPublisher once the fleet flipped) makes a new version
current for new sessions; a drained old version is retired on both tiers
(``_retire_sweep``, T_SWAP_RETIRE).

**A mesh prefill group.** With a PrefillEngine over a mesh model the
router runs on the group's leader; ``shutdown()`` and ``close()`` release
the engine's followers. A live swap into such a group is not ported
(ROADMAP A.12b): ``install_version`` raises.
"""

from __future__ import annotations

import socket
import time
from collections import deque

import numpy as np

from tpunet_torch import _native, telemetry, transport
from tpunet_torch.models.serve import refuse_mesh
from tpunet_torch.serve import kv as kv_mod
from tpunet_torch.serve import protocol as proto
from tpunet_torch.serve.prefill import PrefillEngine

POLICIES = ("least_loaded", "round_robin")


class _Rank:
    def __init__(self, link: proto.FrameLink, index: int):
        self.link = link
        self.index = index
        self.slots = max(1, link.peer.slots)
        self.inflight: set[int] = set()
        self.alive = True
        # Checkpoint versions resident on this rank: seeded from the HELLO
        # (a re-admitted host announces the version it still serves; stale
        # is legal, the publisher catches it up), grown by SWAP_STATUS
        # flips, shrunk by the retire sweep.
        self.versions: set[int] = {link.peer.weight_version}
        # The version the rank serves new work on (the HELLO's, then each
        # flip's): a rank never retires it, so neither does the sweep.
        self.live_version = link.peer.weight_version

    def free(self) -> int:
        return self.slots - len(self.inflight)


class Router:
    """Admission + placement + failover frontend over N decode ranks."""

    def __init__(self, prefill: PrefillEngine, *, kv_codec: str | None = None,
                 policy: str | None = None, queue_limit: int | None = None,
                 retain_kv: bool = True, net: transport.Net | None = None):
        from tpunet_torch.config import Config

        cfg = Config.from_env()
        kv_codec = kv_codec or cfg.kv_wire_dtype
        policy = policy or cfg.router_policy
        if kv_codec not in kv_mod.KV_CODECS:
            raise ValueError(f"unknown KV wire codec {kv_codec!r}")
        if policy not in POLICIES:
            raise ValueError(
                f"router policy must be one of {POLICIES}, got {policy!r}")
        self.prefill = prefill
        self.kv_codec = kv_codec
        self.policy = policy
        self.retain_kv = retain_kv
        self._queue_limit = queue_limit
        # Live weight updates: the version new sessions are admitted under,
        # one PrefillEngine per still-draining version (a request prefilled
        # under v1 decodes and replays under v1), swap verdicts keyed by
        # (rank index, attempt token), and versions awaiting drain-retire.
        self.version = 0
        self._prefills: dict[int, PrefillEngine] = {0: prefill}
        self._swap_status: dict[tuple[int, int], str] = {}
        self._retire_pending: set[int] = set()
        # KV BLOCK and FIRST/RESULT frames ship on a latency-class link, so
        # TTFT-bound traffic never queues behind a co-tenant's bulk traffic
        # in the transport's QoS scheduler.
        self._net = net or transport.Net(traffic_class="latency")
        self._ranks: list[_Rank] = []
        self._rr_next = 0
        self._queue: deque[dict] = deque()
        self._recs: dict[int, dict] = {}
        self._results: dict[int, np.ndarray] = {}
        self._next_id = 0
        # Re-admission probing, armed by enable_readmission(): run() polls
        # the wiring port at this cadence.
        self._listen_sock: socket.socket | None = None
        self._probe_interval = max(1, cfg.readmit_probe_ms) / 1e3
        self._last_probe = 0.0
        self.stats = {"submitted": 0, "completed": 0, "rank_failures": 0,
                      "replays_kv": 0, "replays_prefill": 0, "rejected": 0,
                      "qos_backpressure": 0, "readmissions": 0,
                      "readmit_rejected": 0, "swaps": 0, "swap_aborts": 0}
        # Every TTFT/TPOT sample (us) fed to the histograms, for exact
        # percentiles over a run.
        self.samples: dict[str, list[int]] = {"ttft": [], "tpot": []}

    # -- wiring ------------------------------------------------------------

    @staticmethod
    def listen(addr: str = "127.0.0.1:0") -> socket.socket:
        """Bind the tier wiring port; returns the listening socket (query
        ``.getsockname()`` for the chosen port when addr ends in :0)."""
        host, _, port = addr.rpartition(":")
        sock = socket.socket()
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((host or "127.0.0.1", int(port)))
        sock.listen(16)
        return sock

    def _hello(self) -> proto.Hello:
        return proto.Hello(proto.ROLE_FRONTEND, self.kv_codec, 0,
                           self.prefill.max_len, self.prefill.model.vocab,
                           kv_mod.model_signature(self.prefill.model),
                           weight_version=self.version)

    def accept_ranks(self, listen_sock: socket.socket, n: int,
                     timeout: float = 60.0) -> None:
        """Accept `n` decode ranks on the wiring socket, running the hello
        handshake (typed mismatch on every rank) and comm bring-up."""
        listen_sock.settimeout(timeout)
        for _ in range(n):
            conn, _ = listen_sock.accept()
            try:
                link = proto.wire_frontend(
                    conn, self._net, self._hello(),
                    name=f"decode-{len(self._ranks)}")
            finally:
                conn.close()
            self._ranks.append(_Rank(link, len(self._ranks)))

    # -- re-admission ------------------------------------------------------

    def enable_readmission(self, listen_sock: socket.socket) -> None:
        """Keep the wiring port open for recovered decode hosts: run() (and
        explicit poll_admissions() calls) accepts reconnects, re-runs the
        hello handshake and re-enters the host into the placement pool.
        The socket stays the caller's."""
        listen_sock.setblocking(False)
        self._listen_sock = listen_sock

    def poll_admissions(self, raise_on_mismatch: bool = True) -> int:
        """Non-blocking accept pass over the wiring port (a recovered host
        proves it is alive by reconnecting). Each pending connection runs
        the full hello re-handshake; a model-signature or codec drift is a
        typed TierMismatchError, re-raised when `raise_on_mismatch`, else
        counted in stats["readmit_rejected"] and contained (the serving loop
        must not die because a stale host knocked). Returns the number of
        ranks re-admitted."""
        if self._listen_sock is None:
            return 0
        admitted = 0
        while True:
            try:
                conn, _ = self._listen_sock.accept()
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                break  # the listener was closed: probing stops
            try:
                conn.setblocking(True)
                link = proto.wire_frontend(
                    conn, self._net, self._hello(),
                    name=f"decode-{len(self._ranks)}")
            except proto.TierMismatchError:
                self.stats["readmit_rejected"] += 1
                if raise_on_mismatch:
                    raise
                continue
            except (proto.ServeError, _native.NativeError, OSError):
                # A half-open reconnect (the host died again mid-handshake)
                # is no pool event: drop it.
                continue
            finally:
                conn.close()
            self._ranks.append(_Rank(link, len(self._ranks)))
            self.stats["readmissions"] += 1
            telemetry.churn_event("readmit")
            admitted += 1
        if admitted:
            self._pump()  # queued work flows onto the recovered capacity
        return admitted

    # -- admission ---------------------------------------------------------

    def _capacity(self) -> int:
        return sum(r.slots for r in self._ranks if r.alive)

    def submit(self, prompt, max_new_tokens: int) -> int:
        """Admit one request; returns its id. Raises RouterBusyError when
        every decode slot is occupied and the queue is at its limit."""
        limit = (self._queue_limit if self._queue_limit is not None
                 else 2 * max(1, self._capacity()))
        free = sum(r.free() for r in self._ranks if r.alive)
        if free <= 0 and len(self._queue) >= limit:
            self.stats["rejected"] += 1
            raise proto.RouterBusyError(
                f"all decode slots busy and admission queue at its limit "
                f"({limit}); retry later")
        rid = self._next_id
        self._next_id += 1
        rec = {"id": rid, "prompt": np.asarray(prompt, np.int32),
               "max_new": int(max_new_tokens), "payload": None,
               "t_submit": time.monotonic(), "t_first": None, "rank": None,
               # Pinned at admission: this request prefills, decodes and
               # replays under the version current now, even if a swap
               # lands while it is in flight.
               "version": self.version}
        self._recs[rid] = rec
        self._queue.append(rec)
        self.stats["submitted"] += 1
        self._gauges()
        self._pump()
        return rid

    def _gauges(self) -> None:
        telemetry.serve_queue_depth("router", len(self._queue))
        telemetry.serve_queue_depth(
            "prefill", sum(1 for r in self._queue if r["payload"] is None))

    # -- placement + dispatch ----------------------------------------------

    def _pick_rank(self, version: int) -> _Rank | None:
        live = [r for r in self._ranks if r.alive and r.free() > 0]
        if not live:
            return None
        # Version-pinned placement: prefer ranks where the request's version
        # is resident (a mixed-version pool mid-swap, a stale re-admitted
        # host). Fall through to the whole pool only when no rank holds it:
        # the decode side then serves on its current version rather than
        # drop the request.
        resident = [r for r in live if version in r.versions]
        if resident:
            live = resident
        if self.policy == "round_robin":
            live.sort(key=lambda r: (r.index < self._rr_next, r.index))
            rank = live[0]
            self._rr_next = rank.index + 1
            return rank
        return max(live, key=lambda r: r.free())  # least loaded

    def _build_payload(self, rec: dict) -> bytes:
        # Prefill under the request's pinned version (the engine of a
        # draining version stays resident until it retires).
        eng = self._prefills[rec["version"]]
        kv_rows, logits = eng.prefill(rec["prompt"])
        wire = kv_mod.encode_kv_block(kv_rows, self.kv_codec)
        n_kv = kv_mod.kv_block_elems(
            eng.kv_leaf_shapes(len(rec["prompt"])))
        return proto.pack_block(rec["prompt"], rec["max_new"], wire, n_kv,
                                logits, self.kv_codec)

    def _pump(self) -> None:
        """Dispatch queued requests while live capacity exists."""
        while self._queue:
            rank = self._pick_rank(self._queue[0]["version"])
            if rank is None:
                if not any(r.alive for r in self._ranks):
                    if self._listen_sock is not None:
                        break  # re-admission armed: wait for a rejoin
                    raise proto.NoLiveDecodeRankError(
                        "every decode rank has failed; "
                        f"{len(self._queue)} request(s) cannot be placed")
                break  # saturated: wait for retirements
            rec = self._queue.popleft()
            payload = rec["payload"]
            if payload is None:
                payload = self._build_payload(rec)
                if self.retain_kv:
                    # Keep the ENCODED block: a decode death re-ships these
                    # bytes instead of re-prefilling.
                    rec["payload"] = payload
            try:
                rank.link.send_frame(proto.T_BLOCK, rec["id"], payload,
                                     aux=rec["version"])
            except _native.QosAdmissionError:
                # The header send is the admission point and nothing reached
                # the wire: requeue front-of-queue and retry next poll.
                self.stats["qos_backpressure"] += 1
                self._queue.appendleft(rec)
                break
            except (_native.NativeError, TimeoutError, OSError) as e:
                self._queue.appendleft(rec)
                self._fail_rank(rank, e)
                continue
            rec["rank"] = rank.index
            rank.inflight.add(rec["id"])
        self._gauges()

    # -- completion + failover ---------------------------------------------

    def _fail_rank(self, rank: _Rank, exc: Exception) -> None:
        """Mark a decode rank dead and replay every request it held, from
        the retained KV block when present, requeued at the front."""
        if not rank.alive:
            return
        rank.alive = False
        self.stats["rank_failures"] += 1
        rank.link.close()
        for rid in sorted(rank.inflight, reverse=True):
            if rid in self._results:
                continue
            rec = self._recs[rid]
            rec["rank"] = None
            if rec["payload"] is not None:
                self.stats["replays_kv"] += 1
            else:
                self.stats["replays_prefill"] += 1
            self._queue.appendleft(rec)
        rank.inflight.clear()
        self._gauges()

    def poll(self) -> None:
        """Drain every live rank's frames; contain failures."""
        for rank in self._ranks:
            if not rank.alive:
                continue
            while True:
                try:
                    frame = rank.link.poll()
                except (_native.NativeError, proto.KVIntegrityError,
                        proto.TierProtocolError, OSError) as e:
                    self._fail_rank(rank, e)
                    break
                if frame is None:
                    break
                ftype, rid, payload, aux = frame
                if ftype == proto.T_SWAP_STATUS:
                    # rid is the publisher's attempt token
                    # ((seq << 32) | version): echoing it back makes a late
                    # aborted-status from an abandoned attempt inert.
                    version = rid & 0xFFFFFFFF
                    if aux == proto.SWAP_FLIPPED:
                        rank.versions.add(version)
                        rank.live_version = version
                        self._swap_status[(rank.index, rid)] = "flipped"
                        self.stats["swaps"] += 1
                    else:
                        self._swap_status[(rank.index, rid)] = "aborted"
                        self.stats["swap_aborts"] += 1
                    continue
                rec = self._recs.get(rid)
                if rec is None or rid in self._results:
                    continue  # duplicate after a replay
                if ftype == proto.T_FIRST:
                    if rec["t_first"] is None:
                        rec["t_first"] = time.monotonic()
                        self._observe(
                            "ttft",
                            int((rec["t_first"] - rec["t_submit"]) * 1e6))
                elif ftype == proto.T_RESULT:
                    tokens, status, tpot_us = proto.unpack_result(payload)
                    if status != 0:
                        self._fail_rank(
                            rank, proto.ServeError(f"decode status {status}"))
                        break
                    self._results[rid] = np.asarray(tokens, np.int32)
                    rec["payload"] = None
                    rank.inflight.discard(rid)
                    self.stats["completed"] += 1
                    if tpot_us > 0:
                        self._observe("tpot", tpot_us)
        self._retire_sweep()
        self._pump()

    def _observe(self, kind: str, us: int) -> None:
        self.samples[kind].append(us)
        telemetry.serve_observe(kind, us)

    # -- live weight updates -------------------------------------------------

    def install_version(self, version: int, engine: PrefillEngine) -> None:
        """Adopt `engine` as the prefill for checkpoint `version` and make
        it current for new sessions. The previous version's engine stays
        resident for its pinned in-flight sessions and retires once they
        drain; called by WeightPublisher after the fleet flipped."""
        for eng in (self.prefill, engine):
            refuse_mesh(eng.model, "Router.install_version")
        old = self.version
        self._prefills[version] = engine
        self.prefill = engine
        self.version = version
        telemetry.weight_version(version)
        if old != version:
            self._retire_pending.add(old)

    def _retire_sweep(self) -> None:
        """Retire drained versions: once no admitted request still pins an
        old version, tell every rank holding it to drop it after its own
        local drain, and drop the frontend engine. A rank that still serves
        the version live (a stale host re-admitted before this sweep ran)
        keeps it until the publisher catches it up, which queues the
        version for retirement again."""
        for ver in list(self._retire_pending):
            if ver == self.version:
                self._retire_pending.discard(ver)
                continue
            if any(rec["version"] == ver and rec["id"] not in self._results
                   for rec in self._recs.values()):
                continue  # the version still has pinned sessions in flight
            for rank in self._ranks:
                if rank.live_version == ver:
                    continue
                if rank.alive and ver in rank.versions:
                    try:
                        rank.link.send_frame(proto.T_SWAP_RETIRE, ver,
                                             aux=ver)
                    except Exception:  # noqa: BLE001 — failure poll reaps
                        pass
                rank.versions.discard(ver)
            self._prefills.pop(ver, None)
            self._retire_pending.discard(ver)

    # -- driving -----------------------------------------------------------

    def outstanding(self) -> int:
        return len(self._recs) - len(self._results)

    def run(self, timeout: float = 300.0,
            poll_interval: float = 0.001) -> dict[int, np.ndarray]:
        """Drive until every admitted request has a result (or raise on
        timeout / total rank loss, unless re-admission is armed); returns
        {request_id: tokens} for every request admitted since the last
        run() and clears the slate."""
        deadline = time.monotonic() + timeout
        while self.outstanding() > 0:
            now = time.monotonic()
            if (self._listen_sock is not None
                    and now - self._last_probe >= self._probe_interval):
                self._last_probe = now
                # Drift rejections are contained here; poll_admissions()
                # raises them only when called directly.
                self.poll_admissions(raise_on_mismatch=False)
            self.poll()
            if self.outstanding() == 0:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{self.outstanding()} request(s) unfinished after "
                    f"{timeout}s")
            time.sleep(poll_interval)
        results, self._results = self._results, {}
        self._recs.clear()
        self._gauges()
        return results

    def shutdown(self) -> None:
        """Ask every live decode rank to drain and exit (best effort), and
        release a mesh prefill engine's followers."""
        for rank in self._ranks:
            if not rank.alive:
                continue
            try:
                rank.link.send_frame(proto.T_SHUTDOWN, 0, timeout=5.0)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        self._close_prefills()

    def _close_prefills(self) -> None:
        for eng in self._prefills.values():
            eng.close()

    def close(self) -> None:
        self._close_prefills()
        for rank in self._ranks:
            rank.link.close()
        self._net.close()
