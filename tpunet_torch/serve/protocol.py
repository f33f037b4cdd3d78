"""Tier wiring + KV shipping protocol for the disaggregated serving tier.

The port's copy of ``tpunet/serve/protocol.py``: the byte layout of every
hello and frame is identical. Two layers:

**Tier wiring (out-of-band TCP).** The frontend (router + prefill) listens
on a plain TCP port; each decode rank connects. Both sides exchange a
fixed-size HELLO — protocol version, role, KV wire codec, slots, max_len,
vocab, model-config signature — and EACH side validates the peer's before
touching any payload: a disagreement raises a typed error on EVERY rank
(``KVCodecMismatchError`` for the codec, ``TierMismatchError`` for the
rest), exactly like the collective codec/algo handshake. Only then do the
sides swap transport listen handles and bring up a full-duplex pair of
tpunet P2P comms (frontend->decode for KV blocks, decode->frontend for
first-token/result frames), so the bulk path rides the multi-stream
engine — CRC trailers, fault injection, failover, telemetry and all.

**Frames (over the transport).** Every frame is two messages: a fixed
24-byte header (magic, version, type, request id, body length, aux) and a
body of ``body_len`` payload bytes plus a CRC32C trailer covering
header + payload. A corrupt frame raises ``KVIntegrityError``; an alien or
wrong-version header raises ``TierProtocolError``. Block frames carry the
codec id redundantly and the receiver cross-checks it against the wiring
negotiation — belt over suspenders, typed either way.
"""

from __future__ import annotations

import socket
import struct
import time

import numpy as np

from tpunet_torch import transport
from tpunet_torch._native import QosAdmissionError

MAGIC = b"TPKV"
VERSION = 1

# Frame types.
T_BLOCK = 1      # frontend -> decode: one request's prompt + logits + KV
T_FIRST = 2      # decode -> frontend: request's first token committed
T_RESULT = 3     # decode -> frontend: request finished (tokens + timing)
T_SHUTDOWN = 4   # frontend -> decode: drain live requests, then exit
# Live weight updates: the swap control plane rides the same latency-class
# tier links as requests; only the weight bytes themselves go over the
# bulk-class broadcast comm (serve/publish.py).
T_SWAP_BEGIN = 5   # frontend -> decode: announce a publication (SwapAnnounce)
T_SWAP_STATUS = 6  # decode -> frontend: aux=1 flipped / aux=2 aborted, id=token
T_SWAP_RETIRE = 7  # frontend -> decode: drop version `aux` once locally drained

# Hello roles.
ROLE_FRONTEND = 0
ROLE_DECODE = 1

_HEADER = struct.Struct("<4sHHQII")     # magic, version, type, req_id, body_len, aux
_HELLO = struct.Struct("<4sHBBIIIIQ")   # magic, version, role, codec, slots,
                                        # max_len, vocab, traffic class (low
                                        # byte; rest reserved), model_sig
_BLOCK_HDR = struct.Struct("<IIIIB3x")  # plen, max_new, n_kv, vocab, codec
_RESULT_HDR = struct.Struct("<IIQ")     # ntok, status, tpot_us

_CODEC_IDS = {"f32": 0, "bf16": 1, "int8": 2}
_CODEC_NAMES = {v: k for k, v in _CODEC_IDS.items()}

# QoS traffic classes (transport.TRAFFIC_CLASSES order — the native
# TrafficClass ints). KV BLOCK and FIRST/RESULT frames ship on a
# latency-class link by default so TTFT-bound traffic never queues behind a
# co-tenant's bulk gradient AllReduce (docs/DESIGN.md "Transport QoS").
_CLASS_IDS = {"latency": 0, "bulk": 1, "control": 2}
_CLASS_NAMES = {v: k for k, v in _CLASS_IDS.items()}


class ServeError(RuntimeError):
    """Base class for disaggregated-serving tier errors."""


class TierMismatchError(ServeError):
    """The two sides of a tier link disagree on the wiring contract
    (protocol version, role pairing, model signature, slots/max_len
    sanity). Raised on EVERY rank at wiring time — before any KV byte
    could be misinterpreted."""


class KVCodecMismatchError(TierMismatchError):
    """The tiers disagree on the KV wire codec (TPUNET_KV_WIRE_DTYPE /
    kv_codec=). Raised on every rank at tier wiring, naming both codecs —
    the serving-tier twin of the collective CodecMismatchError."""


class KVIntegrityError(ServeError):
    """A KV/result frame failed its CRC32C check. The link survives; the
    router treats the request like a decode-rank failure (replay or
    re-prefill) rather than ever emitting bytes from a corrupt frame."""


class TierProtocolError(ServeError):
    """A frame that is not tpunet serve protocol (bad magic / version /
    inconsistent sizes) arrived on a tier link."""


class RouterBusyError(ServeError):
    """Admission rejected: every decode slot is occupied and the router
    queue is at its backpressure limit. Retry later — nothing was
    enqueued."""


class NoLiveDecodeRankError(ServeError):
    """Every decode rank has failed; in-flight requests cannot be placed."""


def _crc_frame(header: bytes, payload) -> int:
    crc = transport.crc32c(header)
    if len(payload):
        crc = transport.crc32c(payload, seed=crc)
    return crc


class Hello:
    """One side's wiring contract (see module docstring)."""

    def __init__(self, role: int, kv_codec: str, slots: int, max_len: int,
                 vocab: int, model_sig: int, traffic_class: str = "latency",
                 weight_version: int = 0):
        if kv_codec not in _CODEC_IDS:
            raise ValueError(f"unknown KV wire codec {kv_codec!r}")
        if traffic_class not in _CLASS_IDS:
            raise ValueError(f"unknown traffic class {traffic_class!r}")
        if not 0 <= weight_version < (1 << 24):
            raise ValueError(
                f"weight_version must fit 24 bits, got {weight_version}")
        self.role = role
        self.kv_codec = kv_codec
        self.slots = slots
        self.max_len = max_len
        self.vocab = vocab
        self.model_sig = model_sig
        self.traffic_class = traffic_class
        # Checkpoint version this side serves. Rides the reserved upper
        # bytes of the traffic-class word, so old and new builds interop:
        # a pre-swap peer reads class-only (it masked the low byte all
        # along) and reports version 0 — which the router treats as "needs
        # catch-up", never a mismatch (mixed-version pools are LEGAL;
        # version skew is resolved by re-publication, not rejection).
        self.weight_version = weight_version

    def pack(self) -> bytes:
        return _HELLO.pack(MAGIC, VERSION, self.role,
                           _CODEC_IDS[self.kv_codec], self.slots,
                           self.max_len, self.vocab,
                           _CLASS_IDS[self.traffic_class]
                           | (self.weight_version << 8),
                           self.model_sig & 0xFFFFFFFFFFFFFFFF)

    @staticmethod
    def unpack(raw: bytes) -> "Hello":
        if len(raw) != _HELLO.size:
            raise TierProtocolError(
                f"tier hello is {len(raw)}B, want {_HELLO.size}B")
        magic, ver, role, codec, slots, max_len, vocab, cls, sig = \
            _HELLO.unpack(raw)
        if magic != MAGIC:
            raise TierProtocolError(
                f"tier hello has magic {magic!r}, want {MAGIC!r} — peer is "
                f"not a tpunet serving tier")
        if ver != VERSION:
            raise TierMismatchError(
                f"tier hello version {ver} != local {VERSION}")
        if codec not in _CODEC_NAMES:
            raise TierProtocolError(f"tier hello carries unknown codec id {codec}")
        if (cls & 0xFF) not in _CLASS_NAMES:
            raise TierProtocolError(
                f"tier hello carries unknown traffic class id {cls & 0xFF}")
        return Hello(role, _CODEC_NAMES[codec], slots, max_len, vocab, sig,
                     _CLASS_NAMES[cls & 0xFF], weight_version=cls >> 8)


def _check_peer(mine: Hello, peer: Hello, want_role: int) -> None:
    """Validate the peer's hello against ours — the typed-mismatch half of
    the wiring handshake. BOTH sides send before either reads, so a
    disagreement raises on every rank."""
    if peer.role != want_role:
        raise TierMismatchError(
            f"peer tier role is {peer.role}, want {want_role} (two "
            f"frontends or two decode ranks wired together)")
    if peer.kv_codec != mine.kv_codec:
        raise KVCodecMismatchError(
            f"KV wire codec mismatch: local {mine.kv_codec!r} vs peer "
            f"{peer.kv_codec!r} — set TPUNET_KV_WIRE_DTYPE (or kv_codec=) "
            f"identically on both tiers")
    if peer.traffic_class != mine.traffic_class:
        raise TierMismatchError(
            f"QoS traffic-class mismatch: local {mine.traffic_class!r} vs "
            f"peer {peer.traffic_class!r} — both tiers must wire the link "
            f"on the same lane (traffic_class= / TPUNET_TRAFFIC_CLASS)")
    if peer.model_sig != mine.model_sig:
        raise TierMismatchError(
            f"model-config signature mismatch: local {mine.model_sig:#x} "
            f"vs peer {peer.model_sig:#x} — the tiers are serving "
            f"different model configurations")
    if peer.vocab != mine.vocab:
        raise TierMismatchError(
            f"vocab mismatch: local {mine.vocab} vs peer {peer.vocab}")
    if peer.max_len != mine.max_len:
        raise TierMismatchError(
            f"max_len mismatch: local {mine.max_len} vs peer {peer.max_len}")


def _role_guard(my_role: int) -> None:
    """TPUNET_SERVE_ROLE cross-check: a box pinned to one tier role must
    not come up as the other (catches copy-pasted launch commands)."""
    from tpunet_torch.config import Config

    configured = Config.from_env().serve_role
    want = {ROLE_FRONTEND: "frontend", ROLE_DECODE: "decode"}[my_role]
    if configured and configured != want:
        raise TierMismatchError(
            f"TPUNET_SERVE_ROLE={configured} but this process is wiring as "
            f"the {want} tier")


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        got = sock.recv(n - len(buf))
        if not got:
            raise TierProtocolError("tier peer closed during wiring handshake")
        buf += got
    return buf


class FrameLink:
    """Full-duplex framed channel over a pair of tpunet P2P comms."""

    def __init__(self, send_comm, recv_comm, peer: Hello, name: str = ""):
        self.send_comm = send_comm
        self.recv_comm = recv_comm
        self.peer = peer
        self.name = name
        self._hdr_buf = None
        self._hdr_req = None
        self._body_buf = None
        self._body_req = None
        self._hdr = None

    # -- sending -----------------------------------------------------------

    def send_frame(self, ftype: int, req_id: int, payload: bytes = b"",
                   aux: int = 0, timeout: float | None = 60.0) -> None:
        header = _HEADER.pack(MAGIC, VERSION, ftype, req_id, len(payload), aux)
        trailer = struct.pack("<I", _crc_frame(header, payload))
        # QoS admission backpressure (QosAdmissionError, -8): the HEADER
        # send is the atomic admission point — it fails with NOTHING on the
        # wire, so the caller (router) can safely requeue the whole frame.
        # Once the header is out, the body MUST follow or the link would
        # desync, so a body-side rejection retries in place: the class has
        # bytes in flight (at least our header), and an idle class always
        # admits, so this converges as the link drains.
        self.send_comm.send(header, timeout=timeout)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                self.send_comm.send(payload + trailer, timeout=timeout)
                return
            except QosAdmissionError:
                if deadline is not None and time.monotonic() > deadline:
                    raise
                time.sleep(0.001)

    # -- receiving ---------------------------------------------------------

    def poll(self):
        """Non-blocking receive: returns (ftype, req_id, payload, aux) when
        a whole frame has arrived, else None. Raises typed errors on
        protocol violations / CRC failure; transport errors (peer death,
        watchdog) surface as NativeError from the underlying comm."""
        if self._hdr_req is None:
            self._hdr_buf = bytearray(_HEADER.size)
            self._hdr_req = self.recv_comm.irecv(self._hdr_buf)
        if self._hdr is None:
            done, nbytes = self._hdr_req.test()
            if not done:
                return None
            if nbytes != _HEADER.size:
                raise TierProtocolError(
                    f"tier frame header is {nbytes}B, want {_HEADER.size}B")
            magic, ver, ftype, req_id, body_len, aux = _HEADER.unpack(
                bytes(self._hdr_buf))
            if magic != MAGIC:
                raise TierProtocolError(
                    f"tier frame magic {magic!r}, want {MAGIC!r}")
            if ver != VERSION:
                raise TierProtocolError(
                    f"tier frame version {ver} != local {VERSION}")
            self._hdr = (ftype, req_id, body_len, aux)
            self._body_buf = bytearray(body_len + 4)
            self._body_req = self.recv_comm.irecv(self._body_buf)
        done, nbytes = self._body_req.test()
        if not done:
            return None
        ftype, req_id, body_len, aux = self._hdr
        if nbytes != body_len + 4:
            raise TierProtocolError(
                f"tier frame body is {nbytes}B, header promised "
                f"{body_len + 4}B")
        body = bytes(self._body_buf)
        payload, (got_crc,) = body[:-4], struct.unpack("<I", body[-4:])
        want_crc = _crc_frame(bytes(self._hdr_buf), payload)
        # Consume the frame state BEFORE the CRC verdict so a corrupt frame
        # doesn't wedge the link for its successors.
        self._hdr = self._hdr_req = self._hdr_buf = None
        self._body_req = self._body_buf = None
        if got_crc != want_crc:
            raise KVIntegrityError(
                f"tier frame CRC mismatch (type {ftype}, request {req_id}): "
                f"got {got_crc:#010x}, want {want_crc:#010x}")
        return ftype, req_id, payload, aux

    def recv_frame(self, timeout: float = 60.0):
        """Blocking poll() with a deadline; raises TimeoutError."""
        deadline = time.monotonic() + timeout
        while True:
            frame = self.poll()
            if frame is not None:
                return frame
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"no tier frame within {timeout}s on {self.name or 'link'}")
            time.sleep(0.0005)

    def close(self) -> None:
        for comm in (self.send_comm, self.recv_comm):
            try:
                comm.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass


# -- block/result payload packing -------------------------------------------


def pack_block(prompt: np.ndarray, max_new: int, kv_wire: np.ndarray,
               n_kv: int, logits: np.ndarray, codec: str) -> bytes:
    """BLOCK payload: sub-header | prompt int32 | logits f32 (raw — the
    first token stays exact under every KV codec) | encoded KV bytes."""
    head = _BLOCK_HDR.pack(len(prompt), max_new, n_kv, len(logits),
                           _CODEC_IDS[codec])
    return (head + np.ascontiguousarray(prompt, np.int32).tobytes()
            + np.ascontiguousarray(logits, np.float32).tobytes()
            + bytes(kv_wire))


def unpack_block(payload: bytes, codec: str):
    """Parse a BLOCK payload -> (prompt, max_new, n_kv, logits, kv_wire).
    Cross-checks the frame's codec id against the wiring-negotiated one."""
    if len(payload) < _BLOCK_HDR.size:
        raise TierProtocolError("BLOCK payload shorter than its sub-header")
    plen, max_new, n_kv, vocab, codec_id = _BLOCK_HDR.unpack(
        payload[:_BLOCK_HDR.size])
    if _CODEC_NAMES.get(codec_id) != codec:
        raise TierProtocolError(
            f"BLOCK frame codec {_CODEC_NAMES.get(codec_id, codec_id)!r} != "
            f"wiring-negotiated {codec!r}")
    off = _BLOCK_HDR.size
    # Counts come off the wire: bound them against the actual payload BEFORE
    # np.frombuffer, whose "buffer is smaller than requested size" ValueError
    # is not a typed protocol error (found by tests/test_fuzz.py).
    if len(payload) - off < 4 * (plen + vocab):
        raise TierProtocolError(
            f"BLOCK sub-header claims {plen} prompt + {vocab} logit words "
            f"but only {len(payload) - off}B of payload follow")
    prompt = np.frombuffer(payload, np.int32, plen, off)
    off += 4 * plen
    logits = np.frombuffer(payload, np.float32, vocab, off)
    off += 4 * vocab
    wire = np.frombuffer(payload, np.uint8, offset=off)
    want = transport.codec_wire_bytes(codec, n_kv)
    if wire.size != want:
        raise TierProtocolError(
            f"BLOCK KV wire is {wire.size}B, {codec} x {n_kv} elements "
            f"encodes to {want}B")
    return prompt, max_new, n_kv, logits, wire


def pack_result(tokens: np.ndarray, status: int, tpot_us: int) -> bytes:
    return (_RESULT_HDR.pack(len(tokens), status, tpot_us)
            + np.ascontiguousarray(tokens, np.int32).tobytes())


def unpack_result(payload: bytes):
    if len(payload) < _RESULT_HDR.size:
        raise TierProtocolError("RESULT payload shorter than its sub-header")
    ntok, status, tpot_us = _RESULT_HDR.unpack(payload[:_RESULT_HDR.size])
    if len(payload) - _RESULT_HDR.size < 4 * ntok:
        raise TierProtocolError(
            f"RESULT sub-header claims {ntok} tokens but only "
            f"{len(payload) - _RESULT_HDR.size}B of payload follow")
    tokens = np.frombuffer(payload, np.int32, ntok, _RESULT_HDR.size)
    return tokens, status, tpot_us


# -- weight-swap announce payload --------------------------------------------

# SWAP_BEGIN sub-header: version, broadcast world size, the receiver's rank
# in it, total f32 elements across the flat parameter leaves, broadcast
# chunk size (bytes of encoded wire per tree broadcast), wire codec id,
# the QoS class the broadcast comm must wire on (the PUBLISHER is
# authoritative — receivers must not read their own env, or a half-fleet
# TPUNET_PUBLISH_CLASS drift would fail the comm negotiation), and the
# whole-swap deadline (ms). The rendezvous coordinator ("host:port")
# follows as UTF-8 — variable length, hence last.
_SWAP_HDR = struct.Struct("<IIIQIBBI")

# STATUS verdicts (the aux word of a T_SWAP_STATUS frame).
SWAP_FLIPPED = 1
SWAP_ABORTED = 2


class SwapAnnounce:
    """Parsed T_SWAP_BEGIN payload (see pack_swap_begin)."""

    def __init__(self, version: int, world: int, rank: int, nelems: int,
                 chunk_bytes: int, codec: str, timeout_ms: int,
                 coordinator: str, traffic_class: str = "bulk"):
        self.version = version
        self.world = world
        self.rank = rank
        self.nelems = nelems
        self.chunk_bytes = chunk_bytes
        self.codec = codec
        self.timeout_ms = timeout_ms
        self.coordinator = coordinator
        self.traffic_class = traffic_class


def pack_swap_begin(ann: SwapAnnounce) -> bytes:
    if ann.codec not in _CODEC_IDS:
        raise ValueError(f"unknown weight wire codec {ann.codec!r}")
    if ann.traffic_class not in _CLASS_IDS:
        raise ValueError(f"unknown traffic class {ann.traffic_class!r}")
    return (_SWAP_HDR.pack(ann.version, ann.world, ann.rank, ann.nelems,
                           ann.chunk_bytes, _CODEC_IDS[ann.codec],
                           _CLASS_IDS[ann.traffic_class], ann.timeout_ms)
            + ann.coordinator.encode())


def unpack_swap_begin(payload: bytes) -> SwapAnnounce:
    if len(payload) < _SWAP_HDR.size:
        raise TierProtocolError("SWAP_BEGIN payload shorter than its sub-header")
    version, world, rank, nelems, chunk_bytes, codec_id, cls_id, timeout_ms \
        = _SWAP_HDR.unpack(payload[:_SWAP_HDR.size])
    if codec_id not in _CODEC_NAMES:
        raise TierProtocolError(
            f"SWAP_BEGIN carries unknown codec id {codec_id}")
    if cls_id not in _CLASS_NAMES:
        raise TierProtocolError(
            f"SWAP_BEGIN carries unknown traffic class id {cls_id}")
    if not (0 < rank < world):
        raise TierProtocolError(
            f"SWAP_BEGIN rank {rank} outside broadcast world {world} "
            f"(rank 0 is the publisher — never a receiver)")
    coordinator = payload[_SWAP_HDR.size:].decode("utf-8", "replace")
    if ":" not in coordinator:
        raise TierProtocolError(
            f"SWAP_BEGIN coordinator {coordinator!r} is not host:port")
    return SwapAnnounce(version, world, rank, nelems, chunk_bytes,
                        _CODEC_NAMES[codec_id], timeout_ms, coordinator,
                        _CLASS_NAMES[cls_id])


# -- tier wiring -------------------------------------------------------------


def _swap_handles_and_connect(sock: socket.socket, net, accept_first: bool):
    """Exchange transport listen handles over the wiring socket and bring
    up the full-duplex comm pair. `accept_first` breaks the connect/accept
    symmetry (decode accepts before connecting; frontend the reverse)."""
    lc = net.listen()
    sock.sendall(lc.handle)
    peer_handle = _recv_exact(sock, len(lc.handle))
    if accept_first:
        rc = lc.accept()
        sc = net.connect(peer_handle)
    else:
        sc = net.connect(peer_handle)
        rc = lc.accept()
    lc.close()
    return sc, rc


def wire_frontend(conn: socket.socket, net, hello: Hello,
                  name: str = "") -> FrameLink:
    """Frontend half of the tier handshake over an ACCEPTED wiring socket:
    hello exchange (typed mismatch on every rank), handle swap, comm pair.
    Returns the decode rank's FrameLink."""
    _role_guard(ROLE_FRONTEND)
    conn.sendall(hello.pack())            # send BEFORE reading: both sides
    peer = Hello.unpack(_recv_exact(conn, _HELLO.size))  # get to validate
    _check_peer(hello, peer, ROLE_DECODE)
    sc, rc = _swap_handles_and_connect(conn, net, accept_first=False)
    return FrameLink(sc, rc, peer, name=name or "decode-link")


def wire_decode(addr: tuple[str, int] | str, net, hello: Hello,
                timeout: float = 60.0) -> FrameLink:
    """Decode-rank half: connect to the frontend's wiring port (retrying
    within `timeout` — the frontend may still be coming up), run the hello
    handshake, swap handles. Returns the frontend's FrameLink."""
    _role_guard(ROLE_DECODE)
    if isinstance(addr, str):
        host, _, port = addr.rpartition(":")
        addr = (host or "127.0.0.1", int(port))
    deadline = time.monotonic() + timeout
    while True:
        try:
            sock = socket.create_connection(addr, timeout=timeout)
            break
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)
    try:
        sock.sendall(hello.pack())
        peer = Hello.unpack(_recv_exact(sock, _HELLO.size))
        _check_peer(hello, peer, ROLE_FRONTEND)
        sc, rc = _swap_handles_and_connect(sock, net, accept_first=True)
    finally:
        sock.close()
    return FrameLink(sc, rc, peer, name="frontend-link")
