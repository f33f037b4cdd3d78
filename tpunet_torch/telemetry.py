"""Observability over the native metrics registry, tracer and flight
recorder: the port of ``tpunet/telemetry.py``.

The native layer keeps the counters, gauges and histograms (transport,
codec, QoS, serving SLOs, churn, weight swaps), Chrome-trace spans of every
request and of each collective's phases (tagged ``comm_id``, ``coll_seq``,
``host``) when tracing is on, and a ring of recent events (the flight
recorder). This module reads and feeds them:

  metrics_text()      -> Prometheus exposition text
  metrics()           -> parsed {metric_name: {labels_tuple: value}}
  labels(key)         -> a metrics() label tuple as an ordered dict
  histogram_buckets() -> [(upper_bound, cumulative_count)], +Inf last
  reset()             -> zero every counter/histogram/gauge
  flush_trace()       -> write buffered spans (the file is valid JSON after)
  profile()           -> context manager that turns tracing on for a block
  merge_traces()      -> join per-rank trace files into one Perfetto
                         timeline, aligned on the collective tags
  scrape()            -> GET the native /metrics listener
  metrics_port()      -> bound port of the /metrics listener (0 = none)
  serve_observe()     -> one TTFT/TPOT sample (tpunet_req_{ttft,tpot}_us)
  serve_queue_depth() -> a tier's queue-depth gauge
  rewire_observe()    -> one elastic rewire-phase duration sample
  churn_event()       -> count one membership-churn event by kind
  world_size()        -> set the live world-size gauge
  swap_observe()      -> one weight-swap phase duration sample
  swap_event()        -> count one weight-swap event by kind
  weight_version()    -> set the serving checkpoint-version gauge
  flightrec_dump()    -> write this rank's flight-recorder ring to disk
  flightrec_stats()   -> (events_recorded, ring_capacity) of the recorder

The registry, tracer and recorder are process-wide: a process that loads
both bindings of libtpunet.so reads one set of counters. A trace file is
named ``tpunet-trace-rank<R>.json`` after TPUNET_RANK (or RANK) as it was
when the library loaded, so ranks that share a directory set it first.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import json
import os
import re
import tempfile
import urllib.request

from tpunet_torch import _native


def metrics_text() -> str:
    lib = _native.load()
    # Counters move concurrently, so the text can grow between the sizing
    # call and the copy; retry until the copy fits its own length.
    cap = 16384
    while True:
        buf = ctypes.create_string_buffer(cap)
        n = lib.tpunet_c_metrics_text(buf, cap)
        if n < 0:
            raise _native.NativeError(n, "metrics_text")
        if n < cap:
            return buf.value.decode()
        cap = n + 256


_LINE = re.compile(r"^(\w+)(?:\{([^}]*)\})?\s+([0-9.eE+-]+|[+-]?Inf|NaN)$")
_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def metrics() -> dict:
    """Parse the Prometheus text into {name: {(label="v", ...): float}};
    label tuples keep the exposition's order, unlabeled lines key ()."""
    out: dict = {}
    for line in metrics_text().splitlines():
        if line.startswith("#"):
            continue
        m = _LINE.match(line)
        if not m:
            continue
        name, labels_, value = m.groups()
        key = tuple(labels_.split(",")) if labels_ else ()
        out.setdefault(name, {})[key] = float(value)
    return out


def labels(key: tuple) -> dict:
    """A metrics() label tuple as an insertion-ordered {name: value} dict."""
    out = {}
    for part in key:
        m = _LABEL.match(part)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def histogram_buckets(name: str, parsed: dict | None = None
                      ) -> list[tuple[float, int]]:
    """[(upper_bound, cumulative_count)] of a histogram family, sorted with
    +Inf last; counts sharing an `le` across label sets are summed."""
    if parsed is None:
        parsed = metrics()
    by_bound: dict[float, int] = {}
    for key, value in parsed.get(name + "_bucket", {}).items():
        le = labels(key).get("le")
        if le is None:
            continue
        bound = float("inf") if le in ("+Inf", "Inf") else float(le)
        by_bound[bound] = by_bound.get(bound, 0) + int(value)
    return sorted(by_bound.items())


def reset() -> None:
    """Zero every metric so a warmup does not bleed into a measurement."""
    _native.check(_native.load().tpunet_c_metrics_reset(), "metrics_reset")


def metrics_port() -> int:
    """Bound port of the on-demand /metrics listener, or 0 when none is
    up. With ``TPUNET_METRICS_PORT=0`` the native layer binds an ephemeral
    port and this is the only way to learn it."""
    return int(_native.load().tpunet_c_metrics_port())


_SERVE_KINDS = {"ttft": 0, "tpot": 1}
_SERVE_TIERS = {"router": 0, "prefill": 1, "decode": 2}
_REWIRE_PHASES = {"detect": 0, "quiesce": 1, "rendezvous": 2, "rewire": 3}
_CHURN_KINDS = {"kill": 0, "join": 1, "shrink": 2, "grow": 3, "readmit": 4}
_SWAP_PHASES = {"announce": 0, "broadcast": 1, "verify": 2, "flip": 3}
_SWAP_KINDS = {"publish": 0, "commit": 1, "abort": 2, "retry": 3,
               "mismatch": 4}


def serve_observe(kind: str, us: int) -> None:
    """Record one serving latency sample (microseconds) into
    ``tpunet_req_ttft_us`` (kind="ttft") or ``tpunet_req_tpot_us``."""
    if kind not in _SERVE_KINDS:
        raise ValueError(
            f"kind must be one of {sorted(_SERVE_KINDS)}, got {kind!r}")
    _native.check(
        _native.load().tpunet_c_serve_observe(_SERVE_KINDS[kind],
                                              max(0, int(us))),
        "serve_observe")


def serve_queue_depth(tier: str, depth: int) -> None:
    """Set ``tpunet_serve_queue_depth{tier=...}`` ("router", "prefill" or
    "decode")."""
    if tier not in _SERVE_TIERS:
        raise ValueError(
            f"tier must be one of {sorted(_SERVE_TIERS)}, got {tier!r}")
    _native.check(
        _native.load().tpunet_c_serve_queue_depth(_SERVE_TIERS[tier],
                                                  max(0, int(depth))),
        "serve_queue_depth")


def rewire_observe(phase: str, us: int) -> None:
    """Record one elastic rewire-phase duration (microseconds) into
    ``tpunet_rewire_duration_us{phase=...}``: "detect" (last good step ->
    failure classified or join agreed), "quiesce" (old communicator
    finalized), "rendezvous" (membership sealed), "rewire" (new
    communicator wired)."""
    if phase not in _REWIRE_PHASES:
        raise ValueError(
            f"phase must be one of {sorted(_REWIRE_PHASES)}, got {phase!r}")
    _native.check(
        _native.load().tpunet_c_rewire_observe(_REWIRE_PHASES[phase],
                                               max(0, int(us))),
        "rewire_observe")


def churn_event(kind: str) -> None:
    """Count one event into ``tpunet_churn_events_total{kind=...}``."""
    if kind not in _CHURN_KINDS:
        raise ValueError(
            f"kind must be one of {sorted(_CHURN_KINDS)}, got {kind!r}")
    _native.check(_native.load().tpunet_c_churn_event(_CHURN_KINDS[kind]),
                  "churn_event")


def world_size(world: int) -> None:
    """Set the ``tpunet_world_size`` gauge: the live communicator's world
    as this rank last saw it."""
    _native.check(_native.load().tpunet_c_world_size(max(0, int(world))),
                  "world_size")


def swap_observe(phase: str, us: int) -> None:
    """Record one weight-swap phase duration (microseconds) into
    ``tpunet_weight_swap_duration_us{phase=...}`` ("announce",
    "broadcast", "verify" or "flip")."""
    if phase not in _SWAP_PHASES:
        raise ValueError(
            f"phase must be one of {sorted(_SWAP_PHASES)}, got {phase!r}")
    _native.check(
        _native.load().tpunet_c_swap_observe(_SWAP_PHASES[phase],
                                             max(0, int(us))),
        "swap_observe")


def swap_event(kind: str) -> None:
    """Count one event into ``tpunet_swap_events_total{kind=...}``
    ("publish", "commit", "abort", "retry" or "mismatch")."""
    if kind not in _SWAP_KINDS:
        raise ValueError(
            f"kind must be one of {sorted(_SWAP_KINDS)}, got {kind!r}")
    _native.check(_native.load().tpunet_c_swap_event(_SWAP_KINDS[kind]),
                  "swap_event")


def weight_version(version: int) -> None:
    """Set the ``tpunet_weight_version`` gauge."""
    _native.check(
        _native.load().tpunet_c_weight_version(max(0, int(version))),
        "weight_version")


def flush_trace() -> None:
    lib = _native.load()
    _native.check(lib.tpunet_c_trace_flush(), "trace_flush")


def flightrec_dump(dir: str | None = None, reason: str = "api") -> str:
    """Write this rank's flight-recorder ring to
    ``<dir>/tpunet-flightrec-rank<R>.json`` and return the path. ``dir=None``
    uses the directory resolved when the recorder initialized
    (TPUNET_TRACE_DIR when set, else "."). ``reason`` lands in the dump
    header so a postmortem can tell an on-demand snapshot from a watchdog
    verdict. Raises NativeError when the recorder is disabled
    (TPUNET_FLIGHTREC_EVENTS=0) or the target is unwritable."""
    lib = _native.load()
    buf = ctypes.create_string_buffer(1024)
    n = lib.tpunet_c_flightrec_dump(
        dir.encode() if dir else None, reason.encode(), buf, len(buf))
    if n < 0:
        _native.check(n, "flightrec_dump")
    return buf.value.decode()


def flightrec_dump_verdict(reason: str) -> str | None:
    """Best-effort flight-recorder dump for Python-side terminal verdicts
    (rewire / weight-swap deadline raise sites — the native layer dumps its
    own watchdog/CRC verdicts). Never raises: the typed error being raised
    is the story, a failed dump must not replace it. Returns the dump path,
    or None when the recorder is disabled or the dump failed."""
    try:
        return flightrec_dump(reason=reason)
    except Exception:
        return None


def flightrec_stats() -> tuple[int, int]:
    """(events_ever_recorded, ring_capacity) of the flight recorder. The
    first is the monotonic claim cursor (NOT clamped to capacity — subtract
    to learn how many events the ring has dropped); both are 0 when the
    recorder is disabled or has never recorded."""
    lib = _native.load()
    rec = ctypes.c_uint64()
    cap = ctypes.c_uint64()
    _native.check(
        lib.tpunet_c_flightrec_stats(ctypes.byref(rec), ctypes.byref(cap)),
        "flightrec_stats")
    return int(rec.value), int(cap.value)


class _Profile:
    """Handle yielded by profile(): where the trace files land."""

    def __init__(self, trace_dir: str):
        self.trace_dir = trace_dir
        self.merged_path: str | None = None

    def rank_files(self) -> list[str]:
        return sorted(glob.glob(os.path.join(self.trace_dir, "tpunet-trace-rank*.json")))


@contextlib.contextmanager
def profile(trace_dir: str | None = None, merge: bool = False):
    """Enable tracing at runtime for the duration of the block.

    Unlike TPUNET_TRACE_DIR (read once at library load), this retargets the
    native tracer on entry and flushes + disables on exit, so a profile can
    bracket exactly one measurement window::

        with telemetry.profile("traces") as prof:
            comm.all_reduce(x)
        telemetry.merge_traces(prof.trace_dir)

    With merge=True the per-rank files present in trace_dir are merged into
    one Perfetto timeline on exit (single-host convenience; multi-host jobs
    collect the rank files first and call merge_traces() themselves)."""
    lib = _native.load()
    trace_dir = (trace_dir or os.environ.get("TPUNET_TRACE_DIR")
                 or os.path.join(tempfile.gettempdir(), "tpunet-traces"))
    os.makedirs(trace_dir, exist_ok=True)
    _native.check(lib.tpunet_c_trace_set_dir(trace_dir.encode()), "trace_set_dir")
    prof = _Profile(trace_dir)
    try:
        yield prof
    finally:
        _native.check(lib.tpunet_c_trace_flush(), "trace_flush")
        _native.check(lib.tpunet_c_trace_set_dir(b""), "trace_set_dir")
        if merge:
            prof.merged_path = merge_traces(trace_dir)


def _coll_tags(events: list[dict]) -> dict[tuple, int]:
    """(comm_id, coll_seq, name) -> start ts for collective phase spans."""
    tags = {}
    for ev in events:
        args = ev.get("args") or {}
        if "comm_id" in args and "coll_seq" in args and "ts" in ev:
            key = (args["comm_id"], args["coll_seq"], ev.get("name", ""))
            # Keep the earliest occurrence (phases are unique per rank anyway).
            if key not in tags:
                tags[key] = ev["ts"]
    return tags


def _rank_host(events: list[dict]) -> str | None:
    """Host id of a rank file: the ``host`` tag the native tracer stamps on
    collective phase spans (a hex string of utils.h HostId())."""
    for ev in events:
        h = (ev.get("args") or {}).get("host")
        if h:
            return str(h)
    return None


def merge_traces(trace_dir: str, out_path: str | None = None) -> str:
    """Join every per-rank Chrome-trace JSON in `trace_dir` into ONE
    Perfetto-loadable timeline and return its path.

    Ranks on one host already share the monotonic clock; across hosts the
    clocks are unrelated, so per-rank timelines are aligned on the collective
    phase tags ``(comm_id, coll_seq, phase)``: the earliest tag common to all
    ranks becomes the anchor, and every rank is shifted so its anchor span
    starts at the same instant (the straggler-analysis convention — skew
    WITHIN a collective is preserved, clock offset is not mistaken for it).
    Files without common tags (point-to-point-only traces) merge unshifted.

    Track grouping: phase spans carry a ``host`` tag (HostId()), so ranks
    sharing a host group under ONE Perfetto process track ("host <id>") with
    per-rank thread tracks inside it, instead of interleaving W top-level
    groups — the view that makes an intra-host SHM stage vs inter-host DCN
    stage split readable. Traces from builds without the tag keep the old
    per-rank pid layout.

    Flight-recorder dumps (``tpunet-flightrec-rank*.json``) present in the directory merge too: each rank's events render as
    instant events on a dedicated "flightrec" thread track inside that
    rank's host group, shifted by the same per-rank offset as its trace
    spans (the recorder stamps the same monotonic clock the tracer uses).
    A directory holding ONLY flightrec dumps — the post-hang case, where
    tracing was never on — still merges (unshifted)."""
    files = sorted(glob.glob(os.path.join(trace_dir, "tpunet-trace-rank*.json")))
    fr_files = sorted(
        glob.glob(os.path.join(trace_dir, "tpunet-flightrec-rank*.json")))
    if not files and not fr_files:
        raise FileNotFoundError(
            f"no tpunet-trace-rank*.json or tpunet-flightrec-rank*.json "
            f"files in {trace_dir}")
    per_rank: list[list[dict]] = []
    ranks: list[int] = []
    for fi, path in enumerate(files):
        with open(path) as f:
            per_rank.append(json.load(f))
        m = re.search(r"rank(\d+)\.json$", path)
        ranks.append(int(m.group(1)) if m else fi)
    # Alignment: anchor on the earliest (comm_id, coll_seq, phase) present in
    # EVERY rank's file; shift each rank so anchors coincide at the max.
    tag_maps = [_coll_tags(events) for events in per_rank]
    common = set(tag_maps[0]) if tag_maps else set()
    for tm in tag_maps[1:]:
        common &= set(tm)
    offsets = [0] * len(per_rank)
    if common and len(per_rank) > 1:
        anchor = min(common, key=lambda k: (k[1], k[2]))  # lowest coll_seq
        target = max(tm[anchor] for tm in tag_maps)
        offsets = [target - tm[anchor] for tm in tag_maps]
    # Flight-recorder dumps are loaded up front so their host ids take part
    # in the host-grouping decision (post-hang merges often have ONLY dumps).
    fr_dumps: list[tuple[int, dict]] = []
    for path in fr_files:
        with open(path) as f:
            dump = json.load(f)
        m = re.search(r"rank(\d+)\.json$", path)
        fr_dumps.append((int(m.group(1)) if m else int(dump.get("rank", 0)),
                         dump))
    hosts = [_rank_host(events) for events in per_rank]
    group_by_host = any(h is not None for h in hosts) or \
        any(d.get("host") for _, d in fr_dumps)
    host_order: list[str] = []
    if group_by_host:
        for h in hosts:
            key = h if h is not None else "?"
            if key not in host_order:
                host_order.append(key)
    merged: list[dict] = []
    if group_by_host:
        for pid, host in enumerate(host_order, start=1):
            merged.append({"name": "process_name", "ph": "M", "pid": pid,
                           "args": {"name": f"host {host}"}})
    for events, off, host, rank in zip(per_rank, offsets, hosts, ranks):
        pid = host_order.index(host if host is not None else "?") + 1 \
            if group_by_host else None
        for ev in events:
            if group_by_host and ev.get("ph") == "M" and \
                    ev.get("name") == "process_name":
                continue  # replaced by the per-host group metadata above
            if off and "ts" in ev or group_by_host:
                ev = dict(ev)
            if off and "ts" in ev:
                ev["ts"] = ev["ts"] + off
            if group_by_host:
                # One process group per host; rank-disambiguated thread ids
                # inside it (native tids are small: comm ids / stream idx).
                ev["pid"] = pid
                ev["tid"] = rank * 1_000_000 + int(ev.get("tid", 0))
            merged.append(ev)
    # Flight-recorder dumps ride the same timeline: instant events on a
    # per-rank "flightrec" thread track, reusing the offset computed from
    # that rank's trace file (same monotonic clock on the same host).
    rank_offsets = dict(zip(ranks, offsets))
    for rank, dump in fr_dumps:
        off = rank_offsets.get(rank, 0)
        host = dump.get("host")
        if group_by_host:
            key = str(host) if host else "?"
            if key not in host_order:
                host_order.append(key)
                merged.append({"name": "process_name", "ph": "M",
                               "pid": len(host_order),
                               "args": {"name": f"host {key}"}})
            pid = host_order.index(key) + 1
            tid = rank * 1_000_000 + 999_999
        else:
            pid, tid = rank, 999_999
        merged.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": f"flightrec rank {rank}"}})
        for ev in dump.get("events", []):
            label = ev.get("kind", "?")
            if ev.get("name"):
                label = f"{label}:{ev['name']}"
            merged.append({
                "name": label, "ph": "i", "s": "t",
                "ts": ev.get("t", 0) + off, "pid": pid, "tid": tid,
                "args": {k: ev[k] for k in ("a", "b", "c", "d") if k in ev},
            })
    out_path = out_path or os.path.join(trace_dir, "tpunet-trace-merged.json")
    with open(out_path, "w") as f:
        json.dump(merged, f)
    return out_path


def scrape(port: int | None = None, host: str = "127.0.0.1", timeout: float = 5.0) -> str:
    """GET the native on-demand /metrics listener (TPUNET_METRICS_PORT) and
    return the exposition text — what a Prometheus scraper would see. With
    no explicit port, falls back to the env var and then to the natively
    bound port (metrics_port()) — which covers the ephemeral-port case
    (TPUNET_METRICS_PORT=0)."""
    if port is None:
        port = int(os.environ.get("TPUNET_METRICS_PORT", "0") or "0")
    if not port:
        port = metrics_port()
    if not port:
        raise ValueError("no port given, TPUNET_METRICS_PORT unset, and no "
                         "native /metrics listener is bound")
    with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=timeout) as r:
        return r.read().decode()
