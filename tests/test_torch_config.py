"""The port's Config against the JAX package's, on the CPU.

``Config.from_env()`` reads only the environment, so both packages read the
same settings in this process: every field must come out equal
(``dataclasses.asdict``) over a table of env settings (defaults, aliases
and their precedence, every QoS, lane, dispatch-table and churn knob), and
every invalid value must raise the same exception type with the same
message.
"""

from __future__ import annotations

import dataclasses
import json
import os

import pytest

from tpunet import config as jax_config
from tpunet_torch import config

_PREFIXES = ("TPUNET_", "BAGUA_NET_", "NCCL_SOCKET_")
_PLAIN = ("RANK", "WORLD_SIZE")


@pytest.fixture
def env(monkeypatch, tmp_path):
    """A clean tpunet environment; returns a setter."""
    for k in list(os.environ):
        if k.startswith(_PREFIXES) or k in _PLAIN:
            monkeypatch.delenv(k)

    def put(settings: dict) -> None:
        for k, v in settings.items():
            monkeypatch.setenv(k, v.replace("{tmp}", str(tmp_path)))
    return put


def _both():
    return (dataclasses.asdict(config.Config.from_env()),
            dataclasses.asdict(jax_config.Config.from_env()))


def test_fields_and_defaults_match_jax(env):
    ours, theirs = _both()
    assert ours == theirs
    assert [f.name for f in dataclasses.fields(config.Config)] == \
        [f.name for f in dataclasses.fields(jax_config.Config)]
    assert len(ours) == 65
    assert (ours["kv_wire_dtype"], ours["router_policy"], ours["serve_role"],
            ours["readmit_probe_ms"]) == ("int8", "least_loaded", "", 500)


VALID = {
    "aliases": {"BAGUA_NET_IMPLEMENT": "EPOLL", "BAGUA_NET_NSTREAMS": "4",
                "BAGUA_NET_MIN_CHUNKSIZE": "65536",
                "NCCL_SOCKET_IFNAME": "=eth0", "NCCL_SOCKET_FAMILY":
                "AF_INET6", "RANK": "3", "WORLD_SIZE": "8",
                "TPUNET_PROMETHEUS_ADDRESS": "u:p@host:9091"},
    "precedence": {"TPUNET_NSTREAMS": "3", "BAGUA_NET_NSTREAMS": "5",
                   "TPUNET_IMPLEMENT": "BASIC", "BAGUA_NET_IMPLEMENT":
                   "EPOLL", "TPUNET_RANK": "1", "RANK": "6",
                   "TPUNET_SOCKET_IFNAME": "^lo", "NCCL_SOCKET_IFNAME":
                   "eth"},
    "garbage-falls-back": {"TPUNET_NSTREAMS": "abc", "TPUNET_SPIN": "yes",
                           "TPUNET_RANK": "-2", "TPUNET_MOE_SKEW": "hot",
                           "TPUNET_METRICS_PORT": "x", "TPUNET_CRC": "on",
                           "TPUNET_EPOLL_THREADS": "0"},
    "transport": {"TPUNET_NSTREAMS": "8", "TPUNET_MIN_CHUNKSIZE": "1",
                  "TPUNET_SPIN": "1", "TPUNET_SOCKET_BUFSIZE": "4194304",
                  "TPUNET_RING_CHUNKSIZE": "1048576",
                  "TPUNET_REDUCE_THREADS": "0", "TPUNET_KEEPALIVE_IDLE_S":
                  "0", "TPUNET_KEEPALIVE_INTVL_S": "2",
                  "TPUNET_KEEPALIVE_CNT": "9", "TPUNET_CONNECT_RETRY_MS":
                  "0", "TPUNET_ASYNC_CHANNELS": "8", "TPUNET_A2A": "ring",
                  "TPUNET_A2A_ALGO": "hier_a2a",
                  "TPUNET_A2A_MESH_MAX_WORLD": "4",
                  "TPUNET_INLINE_SEND": "0", "TPUNET_LAZY_RECV": "0",
                  "TPUNET_EPOLL_INLINE": "0", "TPUNET_DEBUG": "1",
                  "TPUNET_REDUCE_SIMD": "0", "TPUNET_FFI_COLLECTIVES": "0",
                  "TPUNET_WIRE_DTYPE": "int8", "TPUNET_ALGO": "hier",
                  "TPUNET_SHM": "1", "TPUNET_SHM_RING_BYTES": "65536",
                  "TPUNET_HOST_ID": "fake-a", "TPUNET_COORDINATOR":
                  "10.0.0.1:7000", "TPUNET_WORLD_SIZE": "4"},
    "failure-model": {"TPUNET_CRC": "1", "TPUNET_PROGRESS_TIMEOUT_MS":
                      "2500", "TPUNET_FAULT_SPEC":
                      "churn:at_step=3:rank=1:action=kill",
                      "TPUNET_HANDSHAKE_TIMEOUT_MS": "1",
                      "TPUNET_BOOTSTRAP_TIMEOUT_MS": "30000"},
    "observability": {"TPUNET_TRACE_DIR": "{tmp}/t", "TPUNET_FLIGHTREC_DIR":
                      "{tmp}/f", "TPUNET_METRICS_ADDR": "h:9091",
                      "TPUNET_METRICS_PORT": "65535",
                      "TPUNET_TCPINFO_INTERVAL_MS": "0",
                      "TPUNET_FAIRNESS_WINDOW_MS": "0",
                      "TPUNET_STRAGGLER_FACTOR": "0",
                      "TPUNET_STRAGGLER_MIN_RTT_US": "7",
                      "TPUNET_METRICS_INTERVAL_MS": "1",
                      "TPUNET_FLIGHTREC_EVENTS": "0",
                      "TPUNET_TS_INTERVAL_MS": "250"},
    "qos": {"TPUNET_TRAFFIC_CLASS": "latency", "TPUNET_QOS_WEIGHTS":
            "latency=4,bulk=2,control=1", "TPUNET_QOS_INFLIGHT_BYTES":
            "latency=64M,bulk=1G,control=0,wire=4k"},
    "qos-empty-tokens": {"TPUNET_QOS_WEIGHTS": ",latency=2,,",
                         "TPUNET_QOS_INFLIGHT_BYTES": "wire=0"},
    "lanes": {"TPUNET_LANES": "addr=127.0.0.1:w=4,addr=[::1]:w=1,w=255",
              "TPUNET_LANE_ADAPT": "0", "TPUNET_LANE_ADAPT_MS": "1"},
    "lanes-bare": {"TPUNET_LANES": "addr=10.0.0.1,w=2"},
    "dispatch-table": {"TPUNET_DISPATCH_TABLE": "{tmp}/table.json"},
    "serving": {"TPUNET_KV_WIRE_DTYPE": "f32", "TPUNET_ROUTER_POLICY":
                "round_robin", "TPUNET_SERVE_ROLE": "decode"},
    "churn": {"TPUNET_CHURN_GRACE_MS": "1", "TPUNET_REWIRE_TIMEOUT_MS":
              "5000", "TPUNET_READMIT_PROBE_MS": "20"},
    "swap-and-moe": {"TPUNET_SWAP_TIMEOUT_MS": "1", "TPUNET_SWAP_CHUNK_BYTES":
                     "4096", "TPUNET_PUBLISH_CLASS": "control",
                     "TPUNET_MOE_SKEW": "0.0"},
}


@pytest.mark.parametrize("name", sorted(VALID))
def test_from_env_matches_jax(env, tmp_path, name):
    (tmp_path / "table.json").write_text(json.dumps({"entries": []}))
    env(VALID[name])
    ours, theirs = _both()
    assert ours == theirs
    assert ours != dataclasses.asdict(config.Config())  # the table moved it


INVALID = {
    "nstreams-0": {"TPUNET_NSTREAMS": "0"},
    "alias-nstreams-0": {"BAGUA_NET_NSTREAMS": "0"},
    "min-chunksize-0": {"BAGUA_NET_MIN_CHUNKSIZE": "0"},
    "metrics-port-high": {"TPUNET_METRICS_PORT": "65536"},
    "metrics-port-negative": {"TPUNET_METRICS_PORT": "-1"},
    "ring-chunksize-0": {"TPUNET_RING_CHUNKSIZE": "0"},
    "reduce-threads-negative": {"TPUNET_REDUCE_THREADS": "-1"},
    "keepalive-negative": {"TPUNET_KEEPALIVE_INTVL_S": "-5"},
    "async-channels-9": {"TPUNET_ASYNC_CHANNELS": "9"},
    "a2a-algo": {"TPUNET_A2A_ALGO": "mesh"},
    "watchdog-negative": {"TPUNET_PROGRESS_TIMEOUT_MS": "-1"},
    "metrics-interval-0": {"TPUNET_METRICS_INTERVAL_MS": "0"},
    "flightrec-negative": {"TPUNET_FLIGHTREC_EVENTS": "-1"},
    "handshake-0": {"TPUNET_HANDSHAKE_TIMEOUT_MS": "0"},
    "bootstrap-0": {"TPUNET_BOOTSTRAP_TIMEOUT_MS": "0"},
    "wire-dtype": {"TPUNET_WIRE_DTYPE": "bf-16"},
    "algo": {"TPUNET_ALGO": "butterfly"},
    "kv-wire-dtype": {"TPUNET_KV_WIRE_DTYPE": "fp8"},
    "router-policy": {"TPUNET_ROUTER_POLICY": "random"},
    "serve-role": {"TPUNET_SERVE_ROLE": "prefill"},
    "shm-ring-small": {"TPUNET_SHM_RING_BYTES": "1024"},
    "shm-ring-large": {"TPUNET_SHM_RING_BYTES": str(2 << 30)},
    "lane-adapt-0": {"TPUNET_LANE_ADAPT_MS": "0"},
    "traffic-class": {"TPUNET_TRAFFIC_CLASS": "best_effort"},
    "qos-weights-not-kv": {"TPUNET_QOS_WEIGHTS": "latency"},
    "qos-weights-key": {"TPUNET_QOS_WEIGHTS": "gold=3"},
    "qos-weights-zero": {"TPUNET_QOS_WEIGHTS": "latency=0"},
    "qos-weights-garbage": {"TPUNET_QOS_WEIGHTS": "bulk=2x"},
    "qos-inflight-key": {"TPUNET_QOS_INFLIGHT_BYTES": "window=4M"},
    "qos-inflight-negative": {"TPUNET_QOS_INFLIGHT_BYTES": "bulk=-1"},
    "lanes-empty-entry": {"TPUNET_LANES": "w=1,,w=2"},
    "lanes-not-kv": {"TPUNET_LANES": "addr"},
    "lanes-bad-addr": {"TPUNET_LANES": "addr=10.0.0.300:w=1"},
    "lanes-weight-0": {"TPUNET_LANES": "w=0"},
    "lanes-weight-256": {"TPUNET_LANES": "addr=[::1]:w=256"},
    "lanes-key": {"TPUNET_LANES": "nic=eth0"},
    "lanes-too-many": {"TPUNET_LANES": ",".join(["w=1"] * 257)},
    "dispatch-missing": {"TPUNET_DISPATCH_TABLE": "{tmp}/missing.json"},
    "dispatch-not-json": {"TPUNET_DISPATCH_TABLE": "{tmp}/bad.json"},
    "dispatch-no-entries": {"TPUNET_DISPATCH_TABLE": "{tmp}/list.json"},
    "moe-skew-negative": {"TPUNET_MOE_SKEW": "-0.5"},
    "churn-grace-0": {"TPUNET_CHURN_GRACE_MS": "0"},
    "rewire-timeout-0": {"TPUNET_REWIRE_TIMEOUT_MS": "0"},
    "readmit-probe-0": {"TPUNET_READMIT_PROBE_MS": "0"},
    "swap-timeout-0": {"TPUNET_SWAP_TIMEOUT_MS": "0"},
    "swap-chunk-small": {"TPUNET_SWAP_CHUNK_BYTES": "4095"},
    "swap-chunk-large": {"TPUNET_SWAP_CHUNK_BYTES": str((1 << 30) + 1)},
    "publish-class": {"TPUNET_PUBLISH_CLASS": "urgent"},
}


def _error(cfg_module):
    try:
        cfg_module.Config.from_env()
    except Exception as e:  # noqa: BLE001 — compared across packages
        return type(e), str(e)
    return None


@pytest.mark.parametrize("name", sorted(INVALID))
def test_invalid_values_raise_like_jax(env, tmp_path, name):
    (tmp_path / "bad.json").write_text("{entries: ")
    (tmp_path / "list.json").write_text(json.dumps([1, 2]))
    env(INVALID[name])
    ours, theirs = _error(config), _error(jax_config)
    assert ours is not None, f"{name} was accepted"
    assert ours == theirs
    var = next(iter(INVALID[name]))
    assert ours[0] is ValueError and ours[1].startswith(var + "=")
