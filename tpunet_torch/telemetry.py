"""Serving-tier observability over the native metrics registry.

The native layer keeps the counters, gauges and histograms (transport,
codec, QoS, serving SLOs); this module reads them as Prometheus text or a
parsed dict, zeroes them between a warmup and a measurement window, and
feeds the serving tier's own samples:

  metrics_text()      -> Prometheus exposition text
  metrics()           -> parsed {metric_name: {labels_tuple: value}}
  labels(key)         -> a metrics() label tuple as an ordered dict
  histogram_buckets() -> [(upper_bound, cumulative_count)], +Inf last
  reset()             -> zero every counter/histogram/gauge
  serve_observe()     -> one TTFT/TPOT sample (tpunet_req_{ttft,tpot}_us)
  serve_queue_depth() -> a tier's queue-depth gauge
  churn_event()       -> count one membership-churn event by kind
  weight_version()    -> set the serving checkpoint-version gauge

The registry is process-wide: a process that loads both bindings of
libtpunet.so reads one set of counters.
"""

from __future__ import annotations

import ctypes
import re

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


_SERVE_KINDS = {"ttft": 0, "tpot": 1}
_SERVE_TIERS = {"router": 0, "prefill": 1, "decode": 2}
_CHURN_KINDS = {"kill": 0, "join": 1, "shrink": 2, "grow": 3, "readmit": 4}


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


def churn_event(kind: str) -> None:
    """Count one event into ``tpunet_churn_events_total{kind=...}``."""
    if kind not in _CHURN_KINDS:
        raise ValueError(
            f"kind must be one of {sorted(_CHURN_KINDS)}, got {kind!r}")
    _native.check(_native.load().tpunet_c_churn_event(_CHURN_KINDS[kind]),
                  "churn_event")


def weight_version(version: int) -> None:
    """Set the ``tpunet_weight_version`` gauge."""
    _native.check(
        _native.load().tpunet_c_weight_version(max(0, int(version))),
        "weight_version")
