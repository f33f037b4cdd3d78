"""tpunet_torch configuration: the complete env-var inventory in one place.

The port of ``tpunet/config.py`` with the same ``Config``: every field,
default, env name (aliases included) and validation message, so both
packages read one environment the same way and the native layer, which
reads the same variables, never disagrees with either. ``TPUNET_*`` names
are canonical; the ``BAGUA_NET_*`` / ``NCCL_*`` spellings are honored as
fallbacks where noted. Serving reads ``kv_wire_dtype``, ``router_policy``,
``serve_role`` and ``readmit_probe_ms``; the churn engine
(``tpunet_torch.elastic``) ``churn_grace_ms`` and ``rewire_timeout_ms``.
``ffi_collectives`` names the JAX package's XLA custom-call route, which
the port does not have; it is read for parity only.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass


def _env_int(name: str, fallback: int) -> int:
    v = os.environ.get(name, "")
    try:
        n = int(v)
        return n if n >= 0 else fallback
    except ValueError:
        return fallback


def _env_int_checked(names: tuple[str, ...], fallback: int, minimum: int,
                     what: str, maximum: int | None = None) -> int:
    """Read the first set env var in `names`; a NUMERIC value below `minimum`
    (or above `maximum`, when given) raises ValueError naming the offending
    var.

    The silent-fallback behavior of _env_int let ``TPUNET_NSTREAMS=0`` or a
    negative keepalive window flow into the native layer (which clamps or
    ignores them) without the operator ever learning their config was
    nonsense. Out-of-range numbers now fail loudly at Config.from_env();
    non-numeric garbage still falls back, matching the native GetEnvU64
    reader so the two layers never disagree on the effective value."""
    for name in names:
        v = os.environ.get(name)
        if v is None or v == "":
            continue
        try:
            n = int(v)
        except ValueError:
            return fallback  # native GetEnvU64 semantics: garbage -> default
        if n < minimum:
            raise ValueError(
                f"{name}={v} is invalid: {what} must be >= {minimum}"
            )
        if maximum is not None and n > maximum:
            raise ValueError(
                f"{name}={v} is invalid: {what} must be <= {maximum}"
            )
        return n
    return fallback


def _env_choice(name: str, fallback: str, choices: tuple[str, ...],
                what: str) -> str:
    """Read an enumerated env var; any value outside `choices` raises
    ValueError naming the var. Unlike the numeric readers there is no
    silent-garbage fallback: a typo'd codec name ("bf-16") silently running
    uncompressed would fake the perf it was set to buy, and the native layer
    rejects the same values loudly (tpunet_comm_create_ex)."""
    v = os.environ.get(name)
    if v is None or v == "":
        return fallback
    if v not in choices:
        raise ValueError(
            f"{name}={v} is invalid: {what} must be one of {', '.join(choices)}"
        )
    return v


def _env_float_checked(name: str, fallback: float, minimum: float,
                       what: str) -> float:
    """Read a float env var; a NUMERIC value below `minimum` raises
    ValueError naming the var; non-numeric garbage falls back (the
    GetEnvU64 stance, matching the numeric readers above)."""
    v = os.environ.get(name)
    if v is None or v == "":
        return fallback
    try:
        f = float(v)
    except ValueError:
        return fallback
    if f < minimum:
        raise ValueError(f"{name}={v} is invalid: {what} must be >= {minimum}")
    return f


_QOS_CLASSES = ("latency", "bulk", "control")


def _parse_qos_size(val: str) -> int | None:
    """'123' / '64K' / '8M' / '1G' -> bytes (the native ParseSizeSuffix
    grammar); None on garbage."""
    mult = 1
    if val and val[-1] in "kKmMgG":
        mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}[val[-1].lower()]
        val = val[:-1]
    if not val.isdigit():
        return None
    return int(val) * mult


def _env_qos_spec(name: str, keys: tuple[str, ...], what: str,
                  minimum: int = 0) -> str:
    """Validate a comma-separated key=value QoS spec env var against the
    native grammar (qos.cc): keys restricted to `keys`, values sized ints
    with optional K/M/G suffix, each >= `minimum`. Malformed specs raise
    ValueError naming the var — the native side only WARNS and keeps its
    defaults, so this is the loud gate (the TPUNET_DISPATCH_TABLE stance).
    Returns the raw string (the native layer re-parses it)."""
    v = os.environ.get(name)
    if v is None or v == "":
        return ""
    for tok in v.split(","):
        if not tok:
            continue
        key, eq, val = tok.partition("=")
        if not eq:
            raise ValueError(
                f"{name}={v} is invalid: token {tok!r} is not key=value")
        if key not in keys:
            raise ValueError(
                f"{name}={v} is invalid: unknown key {key!r} ({what} keys "
                f"are {', '.join(keys)})")
        n = _parse_qos_size(val)
        if n is None or n < minimum:
            raise ValueError(
                f"{name}={v} is invalid: value {val!r} for {key} must be an "
                f"integer >= {minimum} (optional K/M/G suffix)")
    return v


def _env_lanes(name: str) -> str:
    """Validate a TPUNET_LANES spec against the native grammar (wire.cc
    ParseLaneSpec): comma-separated lanes of colon-separated key=value
    clauses, keys ``addr`` (IPv4/IPv6 literal) and ``w`` (1..255), either
    optional per lane. Malformed specs raise ValueError naming the var —
    the native side only WARNS and runs single-path, so this is the loud
    gate (the QoS-spec validator stance). Returns the raw string (the
    native layer re-parses it)."""
    v = os.environ.get(name)
    if v is None or v == "":
        return ""
    def _clauses(lane: str) -> list[str]:
        # ':' separates clauses only at bracket depth 0 — IPv6 literals ride
        # in brackets ("addr=[fe80::1]:w=2"), matching the native tokenizer.
        out, cur, depth = [], "", 0
        for ch in lane:
            if ch == "[":
                depth += 1
            elif ch == "]":
                depth -= 1
            if ch == ":" and depth == 0:
                out.append(cur)
                cur = ""
            else:
                cur += ch
        out.append(cur)
        return out

    for lane in v.split(","):
        if not lane:
            raise ValueError(f"{name}={v} is invalid: empty lane entry")
        for clause in _clauses(lane):
            key, eq, val = clause.partition("=")
            if not eq:
                raise ValueError(
                    f"{name}={v} is invalid: clause {clause!r} is not key=value")
            if key == "addr":
                import ipaddress
                try:
                    ipaddress.ip_address(val.strip("[]"))
                except ValueError as e:
                    raise ValueError(
                        f"{name}={v} is invalid: {val!r} is not an IPv4/IPv6 "
                        f"address") from e
            elif key == "w":
                if not val.isdigit() or not 1 <= int(val) <= 255:
                    raise ValueError(
                        f"{name}={v} is invalid: weight {val!r} must be 1..255")
            else:
                raise ValueError(
                    f"{name}={v} is invalid: unknown key {key!r} (lane keys "
                    f"are addr, w)")
    if len(v.split(",")) > 256:
        raise ValueError(f"{name}={v} is invalid: more than 256 lanes")
    return v


def _env_dispatch_table(name: str) -> str:
    """Read a dispatch-table path env var; when set, the file must exist and
    parse as a JSON object with an "entries" list, else ValueError naming
    the var. The native loader enforces the full schema (and the cross-rank
    CRC handshake) at communicator creation; this pre-check catches a typo'd
    path at Config.from_env() instead of deep inside wiring."""
    v = os.environ.get(name)
    if v is None or v == "":
        return ""
    try:
        with open(v, encoding="utf-8") as f:
            table = json.load(f)
    except OSError as e:
        raise ValueError(f"{name}={v} is invalid: cannot read the dispatch "
                         f"table ({e})") from e
    except ValueError as e:
        raise ValueError(f"{name}={v} is invalid: dispatch table is not "
                         f"valid JSON ({e})") from e
    if not isinstance(table, dict) or not isinstance(table.get("entries"), list):
        raise ValueError(f"{name}={v} is invalid: dispatch table must be a "
                         f"JSON object with an \"entries\" list")
    return v


@dataclass(frozen=True)
class Config:
    """Snapshot of tpunet env configuration at construction time."""

    # Engine selection (reference: src/lib.rs:20-29 BAGUA_NET_IMPLEMENT).
    implement: str = "BASIC"
    # Parallel TCP data streams per comm (reference default 2,
    # nthread_per_socket_backend.rs:228-231).
    nstreams: int = 2
    # Minimum chunk size in bytes (reference default 1 MiB, nthread:232-235).
    min_chunksize: int = 1 << 20
    # Busy-poll IO instead of blocking IO (reference's only mode).
    spin: bool = False
    # NIC selection, NCCL syntax: "^a,b" exclude, "=a,b" exact, "a,b" prefix
    # (reference: utils.rs:37-49).
    socket_ifname: str = "^docker,lo"
    # AF_INET / AF_INET6 restriction (reference: utils.rs:33-36).
    socket_family: str = ""
    # Bootstrap coordinator "host:port" for collectives rendezvous (the role
    # NCCL's OOB bootstrap played for the reference).
    coordinator: str = "127.0.0.1:29500"
    # This process's rank and the world size (reference read RANK for
    # telemetry gating only, nthread:104-107; here they drive the group).
    rank: int = 0
    world_size: int = 1
    # Observability (reference: BAGUA_NET_JAEGER_ADDRESS nthread:113,
    # BAGUA_NET_PROMETHEUS_ADDRESS nthread:184-185). Empty = disabled.
    trace_dir: str = ""
    # Flight-recorder dump directory override (empty = TPUNET_TRACE_DIR,
    # then the CWD). Dump routing ONLY — unlike trace_dir it does not enable
    # span tracing, so test harnesses point verdict dumps at a tmp dir
    # without changing telemetry behavior.
    flightrec_dir: str = ""
    metrics_addr: str = ""
    # On-demand /metrics scrape listener port (0 = disabled). Each rank needs
    # its own port; first binder wins on a shared one.
    metrics_port: int = 0
    # SO_SNDBUF/SO_RCVBUF override in bytes; 0 = kernel autotuning.
    socket_bufsize: int = 0
    # Collectives pipeline granularity: ring steps stream their slice in
    # chunks this size so reduction overlaps transfer.
    ring_chunksize: int = 8 << 20
    # Total fork-join reduce shards, caller included (0 = auto: min(4,
    # cores/2)); the native pool clamps at 16.
    reduce_threads: int = 0
    # TCP keepalive dead-peer detection: first probe after idle_s (0 =
    # disabled), then every intvl_s, dead after cnt misses.
    keepalive_idle_s: int = 30
    keepalive_intvl_s: int = 10
    keepalive_cnt: int = 3
    # Transient connect failures retry with exponential backoff inside this
    # window (ms; 0 = fail fast). Covers a peer restarting its listener.
    connect_retry_ms: int = 10_000
    # Independent ring channels for nonblocking collectives: ticket t runs on
    # channel (t-1) % async_channels, so consecutive gradient buckets overlap
    # on the wire. Must agree across ranks.
    async_channels: int = 2
    # AllToAll algorithm: "pairwise" (direct per-peer comms — the
    # minimum wire bytes, measured (W-1)/W x S per rank) or "ring"
    # (store-and-forward relay: no extra comms, but each block travels
    # multiple hops — 2x the bytes at W=4).
    a2a: str = "pairwise"
    # AllToAll schedule override superseding the legacy TPUNET_A2A switch:
    # "auto" (pairwise, upgraded to the two-stage hierarchical transpose on
    # a profitable >= 2-host uniform topology), "pairwise", "ring" (relay),
    # or "hier" (pin the two-stage transpose; degrades to pairwise on a
    # flat topology). Negotiated at communicator wiring like TPUNET_ALGO —
    # half a world on the mesh and half on the transpose deadlocks, so a
    # disagreement fails every rank typed. docs/DESIGN.md "Hierarchical
    # AllToAll".
    a2a_algo: str = "auto"
    # Worlds larger than this fall back to the ring relay rather than paying
    # 2*(W-1) comm bundles of fds/threads per rank for the pairwise mesh.
    a2a_mesh_max_world: int = 32
    # BASIC-engine caller-thread fast paths (1 = on): inline isend dispatch
    # on an idle comm, and lazily-parked irecv whose wait() runs inline.
    inline_send: bool = True
    lazy_recv: bool = True
    # EPOLL engine: event-loop threads per engine, and the caller-thread
    # inline dispatch + immediate-IO fast path (0 = pure event loop).
    epoll_threads: int = 2
    epoll_inline: bool = True
    # ---- Failure model (docs/DESIGN.md "Failure model") ------------------
    # Per-chunk CRC32C trailers on data streams; negotiated in the connect
    # preamble (the sender's setting wins on the receiving side). Detected
    # corruption fails the REQUEST with a typed error — not a disconnect.
    crc: bool = False
    # Progress watchdog: a blocking wait whose request moves zero bytes for
    # this many ms raises a typed timeout (0 = off). Catches live-but-stuck
    # peers that TCP keepalive never flags; elastic recovery treats the
    # timeout like a dead peer.
    progress_timeout_ms: int = 0
    # Deterministic fault to arm at engine creation (chaos testing), e.g.
    # "stream=1:after_bytes=1M:action=close". Empty = none.
    fault_spec: str = ""
    # ---- Observability sampling/push cadence (docs/DESIGN.md §6c) --------
    # TCP_INFO sample period per stream slot (0 = sampler off).
    tcpinfo_interval_ms: int = 100
    # Jain's-fairness byte-delta window.
    fairness_window_ms: int = 1000
    # Straggler threshold k over the median smoothed RTT (0 = detector off),
    # and the RTT noise floor below which nothing counts as straggling.
    straggler_factor: int = 3
    straggler_min_rtt_us: int = 1000
    # Pushgateway PUT period when TPUNET_METRICS_ADDR is set.
    metrics_interval_ms: int = 1000
    # Flight-recorder ring capacity in events (docs/DESIGN.md §6c), rounded
    # up to a power of two by the native layer (0 = recorder off entirely).
    flightrec_events: int = 16384
    # Counter-timeseries sample period (ms): a background sampler appends
    # full metric snapshots as JSONL to TPUNET_TRACE_DIR (0 = sampler off).
    ts_interval_ms: int = 0
    # ---- Wire/bootstrap deadlines (docs/DESIGN.md §1) --------------------
    # Whole-preamble read deadline on accept (slow-loris defense); partial
    # bundles expire after 2x this.
    handshake_timeout_ms: int = 10_000
    # Rendezvous connect/collect deadline at Communicator creation.
    bootstrap_timeout_ms: int = 120_000
    # ---- Debug / dispatch toggles ----------------------------------------
    # Per-engine stderr event log (TPUNET_DEBUG=1).
    debug: bool = False
    # Runtime SIMD dispatch for the reduction kernels (0 forces scalar —
    # bisection aid; the two paths are bitwise identical).
    reduce_simd: bool = True
    # XLA custom-call collectives (0 falls back to the io_callback bridge).
    ffi_collectives: bool = True
    # Collective wire compression codec for f32 payloads ("f32" = off,
    # "bf16" = RNE truncation halves ring DCN bytes, "int8" = block-scaled
    # quarters them; accumulate stays f32 either way). Negotiated at
    # communicator wiring — all ranks must agree or creation fails with
    # CodecMismatchError. docs/DESIGN.md "Compressed collectives".
    wire_dtype: str = "f32"
    # Collective schedule ("auto" = per-(collective, size, world) selection;
    # "ring"/"rhd"/"tree"/"hier" pin one schedule — "hier" is the two-level
    # intra-host + inter-host AllReduce and needs a hierarchical topology,
    # else it runs the ring). Negotiated at communicator
    # wiring like the codec — ranks on different schedules would deadlock,
    # so a disagreement fails creation on every rank. docs/DESIGN.md
    # "Schedules & algorithm selection".
    algo: str = "auto"
    # Path to the dispatch-table JSON written by `busbw_sweep
    # --emit-dispatch` (empty = built-in thresholds). Loaded per
    # communicator; the file's CRC rides the wiring handshake so every rank
    # must see identical contents. A missing or malformed file is a loud
    # config error here AND at communicator creation.
    dispatch_table: str = ""
    # ---- Disaggregated serving tier (docs/DESIGN.md "Serving tier") ------
    # KV-block wire codec for prefill->decode shipping ("int8" block-scaled
    # by default — the EQuARX-bound codec; "f32" makes the wire exact and
    # greedy outputs bitwise-equal to single-host serving). Negotiated at
    # tier wiring: a mismatch raises KVCodecMismatchError on every rank.
    kv_wire_dtype: str = "int8"
    # Decode-rank placement policy at the router ("least_loaded" picks the
    # rank with the most free slots; "round_robin" cycles).
    router_policy: str = "least_loaded"
    # Pin this process's serving-tier role ("" = unpinned). Wiring as the
    # OTHER role then fails loudly — catches copy-pasted launch commands.
    serve_role: str = ""
    # ---- Lane striping (docs/DESIGN.md "Lanes & adaptive striping") ------
    # Multi-path lane spec, "addr=10.0.0.1:w=4,addr=10.0.1.1:w=1": one lane
    # == one data stream (the spec's lane count overrides TPUNET_NSTREAMS),
    # addr pins the lane's local bind (egress path; omit for the default
    # route), w its base stripe weight. Empty = single-path uniform striping,
    # byte-identical on the wire to pre-lane builds.
    lanes: str = ""
    # Sender-side adaptive re-striping (lane mode only): per-lane service-
    # rate EWMAs + the TCP_INFO straggler detector drive weight demotion
    # (floor 1) and recovery, published as epoch-stamped ctrl frames. 0
    # pins the configured base weights (the uniform-striping control).
    lane_adapt: bool = True
    # Adaptation tick cadence in ms.
    lane_adapt_ms: int = 100
    # ---- Intra-host shared memory (docs/DESIGN.md "Intra-host shared
    # memory") -------------------------------------------------------------
    # Front the TCP engine with the SHM engine: same-host peers (HostId()
    # equality, verified in the segment handshake) move payloads through
    # mmap'd per-pair ring segments; cross-host peers pass through to TCP
    # untouched. Must be set identically on every rank (like the engine
    # choice itself — a mixed config fails the handshake loudly).
    shm: bool = False
    # Per-pair ring segment capacity in bytes (clamped to [64K, 1G] by the
    # native layer). A chunk plus its CRC trailer must fit in half of it.
    shm_ring_bytes: int = 8 << 20
    # Host-identity override (the fake-host knob): any string, hashed into
    # the host id the SHM handshake and the hierarchical schedule's host
    # grouping compare. Unset = boot-id/hostname hash — every process on a
    # physical host agrees. Setting DIFFERENT values on same-box ranks
    # splits them into testable fake "hosts" (forced TCP between them).
    host_id: str = ""
    # ---- Transport QoS (docs/DESIGN.md "Transport QoS") ------------------
    # Default traffic class for every comm this process connects (and the
    # class a Communicator negotiates when traffic_class= is not passed).
    # "latency" | "bulk" | "control"; carried in the connect preamble and
    # the collective bootstrap handshake (mismatch fails every rank typed).
    traffic_class: str = "bulk"
    # DRR weights for the wire-credit scheduler, "latency=8,bulk=1"
    # (control is strict-priority; empty = built-in 8:1). One weight point
    # buys 64KiB of wire credit per scheduling turn.
    qos_weights: str = ""
    # Per-class in-flight budgets, "latency=64M,bulk=256M,control=0,wire=4M"
    # (sizes take K/M/G). latency/bulk/control bound ADMISSION (posted-send
    # bytes; over-budget isends fail typed QosAdmissionError, -8; 0 =
    # unlimited). wire= sets the shared WIRE WINDOW that arms the DRR chunk
    # scheduler (0 = gate off, the default — dispatch is then unchanged).
    qos_inflight_bytes: str = ""
    # ---- Elastic churn (docs/DESIGN.md "Elastic churn") ------------------
    # Membership grace window for churn rendezvous (ms): how long the
    # sealing leader waits for survivors/joiners to deposit member files
    # before sealing the new world. Short = fast recovery but a slow rank
    # may be excluded; long = inclusive but recovery pays the window.
    churn_grace_ms: int = 10_000
    # Whole-rewire deadline (ms): a mid-run membership rewire (quiesce +
    # rendezvous + re-wiring at the new shape) exceeding it raises the
    # typed RewireTimeoutError (-9) — bounded recovery, never a hang.
    rewire_timeout_ms: int = 120_000
    # Serving-tier re-admission probe cadence (ms): how often the router
    # polls its wiring port for recovered decode hosts once
    # enable_readmission() armed it.
    readmit_probe_ms: int = 500
    # ---- Live weight updates (docs/DESIGN.md "Live weight updates") ------
    # Whole-swap deadline (ms): a weight publication (announce + broadcast
    # + verify + flip) exceeding it aborts typed (WeightSwapError, -10) on
    # every rank — the old version keeps serving, never a hang.
    swap_timeout_ms: int = 30_000
    # Broadcast chunk size (bytes of bf16 wire per tree broadcast): small
    # enough that the decode serve loop's per-iteration swap work stays
    # bounded (the latency p99 protection), large enough to amortize the
    # per-collective rounds.
    swap_chunk_bytes: int = 1 << 20
    # QoS traffic class the publication broadcast rides ("bulk" by default:
    # gigabytes of weights must not queue ahead of latency-class decode/KV
    # traffic in the DRR scheduler).
    publish_class: str = "bulk"
    # ---- MoE / pipeline workloads (docs/DESIGN.md "Workloads") -----------
    # Default Zipf skew exponent for the MoE workload's expert routing:
    # 0 = uniform expert popularity, larger = more
    # skewed (the 100k+-GPU paper's hot-expert shape). Must be >= 0.
    moe_skew: float = 1.0

    @staticmethod
    def from_env() -> "Config":
        """Snapshot env config, validating range-sensitive knobs: zero/negative
        nstreams, non-positive min_chunksize, negative keepalive/retry/
        watchdog windows, an out-of-range metrics port (0-65535), and a
        negative reduce-thread count raise ValueError naming the offending
        env var instead of flowing into the native layer unchecked."""
        env = os.environ
        return Config(
            implement=env.get("TPUNET_IMPLEMENT", env.get("BAGUA_NET_IMPLEMENT", "BASIC")),
            nstreams=_env_int_checked(
                ("TPUNET_NSTREAMS", "BAGUA_NET_NSTREAMS"), 2, 1, "data-stream count"
            ),
            min_chunksize=_env_int_checked(
                ("TPUNET_MIN_CHUNKSIZE", "BAGUA_NET_MIN_CHUNKSIZE"), 1 << 20, 1,
                "minimum chunk size",
            ),
            # GetEnvU64 semantics like the native reader: non-numeric -> 0.
            spin=_env_int("TPUNET_SPIN", 0) != 0,
            socket_ifname=env.get(
                "TPUNET_SOCKET_IFNAME", env.get("NCCL_SOCKET_IFNAME", "^docker,lo")
            ),
            socket_family=env.get("TPUNET_SOCKET_FAMILY", env.get("NCCL_SOCKET_FAMILY", "")),
            coordinator=env.get("TPUNET_COORDINATOR", "127.0.0.1:29500"),
            rank=_env_int("TPUNET_RANK", _env_int("RANK", 0)),
            world_size=_env_int("TPUNET_WORLD_SIZE", _env_int("WORLD_SIZE", 1)),
            trace_dir=env.get("TPUNET_TRACE_DIR", ""),
            flightrec_dir=env.get("TPUNET_FLIGHTREC_DIR", ""),
            metrics_addr=env.get("TPUNET_METRICS_ADDR", os.environ.get("TPUNET_PROMETHEUS_ADDRESS", "")),
            # The native listener ignores ports >= 65536 silently; the config
            # layer names the bad var instead.
            metrics_port=_env_int_checked(
                ("TPUNET_METRICS_PORT",), 0, 0, "metrics scrape port",
                maximum=65535,
            ),
            socket_bufsize=_env_int("TPUNET_SOCKET_BUFSIZE", 0),
            # The native reader treats 0 as "use the default" silently; the
            # config layer names the bad var instead.
            ring_chunksize=_env_int_checked(
                ("TPUNET_RING_CHUNKSIZE",), 8 << 20, 1, "ring pipeline chunk size"
            ),
            reduce_threads=_env_int_checked(
                ("TPUNET_REDUCE_THREADS",), 0, 0, "reduce thread count"
            ),
            keepalive_idle_s=_env_int_checked(
                ("TPUNET_KEEPALIVE_IDLE_S",), 30, 0, "keepalive idle window"
            ),
            keepalive_intvl_s=_env_int_checked(
                ("TPUNET_KEEPALIVE_INTVL_S",), 10, 0, "keepalive probe interval"
            ),
            keepalive_cnt=_env_int_checked(
                ("TPUNET_KEEPALIVE_CNT",), 3, 0, "keepalive probe count"
            ),
            connect_retry_ms=_env_int_checked(
                ("TPUNET_CONNECT_RETRY_MS",), 10_000, 0, "connect retry window"
            ),
            # Native clamps to [1, 8]; numeric 0 is a config error here.
            async_channels=_env_int_checked(
                ("TPUNET_ASYNC_CHANNELS",), 2, 1, "async ring channel count", maximum=8
            ),
            a2a=env.get("TPUNET_A2A", "pairwise"),
            a2a_algo=_env_choice(
                "TPUNET_A2A_ALGO", "auto",
                ("auto", "pairwise", "ring", "hier", "hier_a2a"),
                "AllToAll schedule",
            ),
            a2a_mesh_max_world=_env_int("TPUNET_A2A_MESH_MAX_WORLD", 32),
            # Parsed to match the native consumer (GetEnvU64, default 1):
            # only a numeric 0 disables; "false"/"" fall back to on.
            inline_send=_env_int("TPUNET_INLINE_SEND", 1) != 0,
            lazy_recv=_env_int("TPUNET_LAZY_RECV", 1) != 0,
            # The native engine clamps 0 -> 1 loop thread; mirror it so
            # the inventory reports the thread count that actually runs.
            epoll_threads=max(1, _env_int("TPUNET_EPOLL_THREADS", 2)),
            epoll_inline=_env_int("TPUNET_EPOLL_INLINE", 1) != 0,
            crc=_env_int("TPUNET_CRC", 0) != 0,
            progress_timeout_ms=_env_int_checked(
                ("TPUNET_PROGRESS_TIMEOUT_MS",), 0, 0, "progress watchdog window"
            ),
            fault_spec=env.get("TPUNET_FAULT_SPEC", ""),
            # Observability cadence knobs (0 legitimately disables the
            # sampler/detector; only negatives are config errors).
            tcpinfo_interval_ms=_env_int_checked(
                ("TPUNET_TCPINFO_INTERVAL_MS",), 100, 0, "TCP_INFO sample period"
            ),
            fairness_window_ms=_env_int_checked(
                ("TPUNET_FAIRNESS_WINDOW_MS",), 1000, 0, "fairness byte window"
            ),
            straggler_factor=_env_int_checked(
                ("TPUNET_STRAGGLER_FACTOR",), 3, 0, "straggler threshold factor"
            ),
            straggler_min_rtt_us=_env_int_checked(
                ("TPUNET_STRAGGLER_MIN_RTT_US",), 1000, 0, "straggler RTT floor"
            ),
            metrics_interval_ms=_env_int_checked(
                ("TPUNET_METRICS_INTERVAL_MS",), 1000, 1, "metrics push period"
            ),
            # 0 legitimately disables the recorder / timeseries sampler;
            # only negatives are config errors.
            flightrec_events=_env_int_checked(
                ("TPUNET_FLIGHTREC_EVENTS",), 16384, 0,
                "flight-recorder ring capacity",
            ),
            ts_interval_ms=_env_int_checked(
                ("TPUNET_TS_INTERVAL_MS",), 0, 0,
                "counter-timeseries sample period",
            ),
            # Deadlines: 0 would make every handshake/bootstrap time out
            # instantly — loud config error, not a silent wedge.
            handshake_timeout_ms=_env_int_checked(
                ("TPUNET_HANDSHAKE_TIMEOUT_MS",), 10_000, 1, "handshake deadline"
            ),
            bootstrap_timeout_ms=_env_int_checked(
                ("TPUNET_BOOTSTRAP_TIMEOUT_MS",), 120_000, 1, "bootstrap deadline"
            ),
            debug=_env_int("TPUNET_DEBUG", 0) != 0,
            # GetEnvU64 semantics (default 1): only a numeric 0 disables.
            reduce_simd=_env_int("TPUNET_REDUCE_SIMD", 1) != 0,
            # Matches the interop.py consumer: enabled iff the var is unset
            # or exactly "1".
            ffi_collectives=env.get("TPUNET_FFI_COLLECTIVES", "1") == "1",
            wire_dtype=_env_choice(
                "TPUNET_WIRE_DTYPE", "f32", ("f32", "bf16", "int8"),
                "collective wire codec",
            ),
            algo=_env_choice(
                "TPUNET_ALGO", "auto", ("auto", "ring", "rhd", "tree", "hier"),
                "collective schedule",
            ),
            dispatch_table=_env_dispatch_table("TPUNET_DISPATCH_TABLE"),
            kv_wire_dtype=_env_choice(
                "TPUNET_KV_WIRE_DTYPE", "int8", ("f32", "bf16", "int8"),
                "KV-block wire codec",
            ),
            router_policy=_env_choice(
                "TPUNET_ROUTER_POLICY", "least_loaded",
                ("least_loaded", "round_robin"), "router placement policy",
            ),
            serve_role=_env_choice(
                "TPUNET_SERVE_ROLE", "", ("", "frontend", "decode"),
                "serving-tier role",
            ),
            # GetEnvU64 semantics (default 0): only a numeric nonzero enables.
            shm=_env_int("TPUNET_SHM", 0) != 0,
            shm_ring_bytes=_env_int_checked(
                ("TPUNET_SHM_RING_BYTES",), 8 << 20, 64 << 10,
                "shared-memory ring size", maximum=1 << 30,
            ),
            host_id=env.get("TPUNET_HOST_ID", ""),
            lanes=_env_lanes("TPUNET_LANES"),
            # GetEnvU64 semantics (default 1): only a numeric 0 disables.
            lane_adapt=_env_int("TPUNET_LANE_ADAPT", 1) != 0,
            lane_adapt_ms=_env_int_checked(
                ("TPUNET_LANE_ADAPT_MS",), 100, 1, "lane adaptation tick"
            ),
            traffic_class=_env_choice(
                "TPUNET_TRAFFIC_CLASS", "bulk", _QOS_CLASSES,
                "QoS traffic class",
            ),
            # Weights must be >= 1 (a zero-weight class would never earn
            # wire credit); budgets accept 0 = unlimited / gate off.
            qos_weights=_env_qos_spec(
                "TPUNET_QOS_WEIGHTS", _QOS_CLASSES, "DRR weight", minimum=1,
            ),
            qos_inflight_bytes=_env_qos_spec(
                "TPUNET_QOS_INFLIGHT_BYTES", _QOS_CLASSES + ("wire",),
                "in-flight budget",
            ),
            moe_skew=_env_float_checked(
                "TPUNET_MOE_SKEW", 1.0, 0.0, "MoE Zipf skew exponent",
            ),
            # Churn deadlines/cadences: 0 would seal empty memberships,
            # expire every rewire instantly, or spin the readmission probe
            # — loud config errors, not silent wedges.
            churn_grace_ms=_env_int_checked(
                ("TPUNET_CHURN_GRACE_MS",), 10_000, 1,
                "churn membership grace window",
            ),
            rewire_timeout_ms=_env_int_checked(
                ("TPUNET_REWIRE_TIMEOUT_MS",), 120_000, 1, "rewire deadline"
            ),
            readmit_probe_ms=_env_int_checked(
                ("TPUNET_READMIT_PROBE_MS",), 500, 1,
                "re-admission probe interval",
            ),
            # Swap knobs: a zero deadline would abort every publication on
            # arrival and a zero chunk would never move a byte — loud
            # config errors, not silent wedges.
            swap_timeout_ms=_env_int_checked(
                ("TPUNET_SWAP_TIMEOUT_MS",), 30_000, 1, "weight-swap deadline"
            ),
            swap_chunk_bytes=_env_int_checked(
                ("TPUNET_SWAP_CHUNK_BYTES",), 1 << 20, 4 << 10,
                "weight-broadcast chunk size", maximum=1 << 30,
            ),
            publish_class=_env_choice(
                "TPUNET_PUBLISH_CLASS", "bulk", _QOS_CLASSES,
                "weight-publication QoS class",
            ),
        )
