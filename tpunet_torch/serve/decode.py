"""Decode tier: the BatchServer slot machine fed by shipped KV blocks.

A DecodeWorker owns one BatchServer and one FrameLink to the frontend. Its
serve loop is single-threaded and non-blocking: drain arriving BLOCK frames
(decode the KV wire, ``submit_kv``; never a re-prefill), advance every live
slot one window, then report: a FIRST frame the moment a request's first
token commits (the router's TTFT stamp) and a RESULT frame with the whole
token array and the measured TPOT when it retires. Requests are never
streamed token by token, so a decode rank that dies cannot truncate or
corrupt a stream: the router replays it elsewhere.

Live weight updates (the JAX package's swap frames) are a later slice of
the port; their frame types raise TierProtocolError here.
"""

from __future__ import annotations

import time

from tpunet_torch import telemetry, transport
from tpunet_torch.models.serve import BatchServer
from tpunet_torch.serve import kv as kv_mod
from tpunet_torch.serve import protocol as proto


class DecodeWorker:
    """Serve loop around a BatchServer for one decode rank."""

    def __init__(self, model, params, link: proto.FrameLink, *,
                 slots: int, max_len: int, kv_codec: str = "int8",
                 weight_version: int = 0, **server_kwargs):
        if kv_codec not in kv_mod.KV_CODECS:
            raise ValueError(f"unknown KV wire codec {kv_codec!r}")
        self._net = None  # set by connect(): the engine this worker owns
        self.link = link
        self.kv_codec = kv_codec
        self.version = int(weight_version)
        self.srv = BatchServer(model, params, slots=slots, max_len=max_len,
                               on_first_token=self._on_first,
                               **server_kwargs)
        # BatchServer local id -> router request id.
        self._router_id: dict[int, int] = {}
        self._t_first: dict[int, float] = {}
        self._first_pending: list[int] = []
        self.stats = {"blocks": 0, "results": 0}
        telemetry.weight_version(self.version)

    def _on_first(self, local_id: int) -> None:
        self._t_first[local_id] = time.monotonic()
        self._first_pending.append(local_id)

    def _ingest(self) -> tuple[bool, bool]:
        """Drain available frames; returns (progressed, shutdown_seen)."""
        progressed = shutdown = False
        while True:
            frame = self.link.poll()
            if frame is None:
                return progressed, shutdown
            progressed = True
            ftype, rid, payload, _aux = frame
            if ftype == proto.T_BLOCK:
                prompt, max_new, n_kv, logits, wire = proto.unpack_block(
                    payload, self.kv_codec)
                shapes = self.srv.kv_leaf_shapes(len(prompt))
                if kv_mod.kv_block_elems(shapes) != n_kv:
                    raise proto.TierProtocolError(
                        f"BLOCK for request {rid} carries {n_kv} KV "
                        f"elements; this model/prompt-length expects "
                        f"{kv_mod.kv_block_elems(shapes)}")
                rows = kv_mod.decode_kv_block(wire, self.kv_codec, shapes)
                local = self.srv.submit_kv(prompt, max_new, rows, logits)
                self._router_id[local] = rid
                self.stats["blocks"] += 1
            elif ftype == proto.T_SHUTDOWN:
                shutdown = True
            else:
                raise proto.TierProtocolError(
                    f"decode tier got unexpected frame type {ftype}")

    def _report(self, finished: list[dict]) -> None:
        # FIRST frames go out before any RESULT so the router's TTFT stamp
        # for a request always precedes its completion.
        for local in self._first_pending:
            rid = self._router_id.get(local)
            if rid is not None:
                self.link.send_frame(proto.T_FIRST, rid)
        self._first_pending.clear()
        for rec in finished:
            rid = self._router_id.pop(rec["id"], None)
            if rid is None:
                continue
            t_first = self._t_first.pop(rec["id"], None)
            ntok = len(rec["tokens"])
            tpot_us = 0
            if t_first is not None and ntok > 1:
                tpot_us = int((time.monotonic() - t_first) / (ntok - 1) * 1e6)
            self.link.send_frame(proto.T_RESULT, rid,
                                 proto.pack_result(rec["tokens"], 0, tpot_us))
            self.stats["results"] += 1

    def serve(self, *, idle_timeout: float | None = None,
              poll_interval: float = 0.001,
              max_blocks: int | None = None) -> None:
        """Run until a SHUTDOWN frame arrives and every live request has
        reported (or `idle_timeout` seconds pass with no traffic).
        `max_blocks` returns after ingesting that many KV blocks without
        draining (a chaos control). Transport errors propagate."""
        srv = self.srv
        draining = False
        idle_since = time.monotonic()
        while True:
            progressed, shutdown = self._ingest()
            draining = draining or shutdown
            if max_blocks is not None and self.stats["blocks"] >= max_blocks:
                return
            finished = []
            if srv._live or srv._pending:
                finished = srv.step()
                progressed = True
            if finished or self._first_pending:
                self._report(finished)
            telemetry.serve_queue_depth("decode",
                                        len(srv._live) + len(srv._pending))
            if draining and not (srv._live or srv._pending):
                return
            if progressed:
                idle_since = time.monotonic()
            else:
                if (idle_timeout is not None
                        and time.monotonic() - idle_since > idle_timeout):
                    return
                time.sleep(poll_interval)

    def close(self) -> None:
        """Tear down the link (and the engine, when this worker owns it)."""
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
    defers to TPUNET_KV_WIRE_DTYPE (default int8). `server_kwargs` go to
    the BatchServer (`device=` among them)."""
    from tpunet_torch.config import Config

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
