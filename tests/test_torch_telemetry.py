"""The port's telemetry surface against the JAX package's, on the CPU.

``merge_traces`` is pure Python over the rank files, so both packages merge
the same files here: files written by two spawned ranks of the port doing
an all-reduce under ``profile()``. The metrics registry, the flight
recorder and the /metrics listener are process-wide native state shared by
both bindings, so each package drives them in a process of its own and the
two processes' readings are compared.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import run_spawn_workers
from torch_elastic_ranks import traced_allreduce_worker

from tpunet import telemetry as jax_telemetry
from tpunet_torch import telemetry

REPO = Path(__file__).resolve().parent.parent


def test_merge_traces_of_a_port_allreduce_matches_jax(tmp_path):
    trace_dir = tmp_path / "trace"
    run_spawn_workers(traced_allreduce_worker, 2, timeout=120,
                      extra_args=(str(trace_dir),))
    files = sorted(p.name for p in trace_dir.glob("tpunet-trace-rank*.json"))
    assert files == ["tpunet-trace-rank0.json", "tpunet-trace-rank1.json"]
    ours = telemetry.merge_traces(str(trace_dir),
                                  str(tmp_path / "port.json"))
    theirs = jax_telemetry.merge_traces(str(trace_dir),
                                        str(tmp_path / "jax.json"))
    merged = json.loads(Path(ours).read_text())
    assert merged == json.loads(Path(theirs).read_text())
    # Both ranks' phase spans of one collective share (comm_id, coll_seq).
    ranks_by_tag: dict = {}
    for ev in merged:
        args = ev.get("args") or {}
        if ev.get("ph") == "X" and "comm_id" in args and "coll_seq" in args:
            ranks_by_tag.setdefault((args["comm_id"], args["coll_seq"]),
                                    set()).add(ev["tid"] // 1_000_000)
    assert ranks_by_tag and any(r == {0, 1} for r in ranks_by_tag.values())


def test_profile_is_off_outside_the_block(tmp_path):
    """profile() retargets the tracer for its block only: a flush after the
    block writes nothing new, and the handle lists the rank files."""
    from tpunet_torch import transport

    with telemetry.profile(str(tmp_path)) as prof:
        assert prof.trace_dir == str(tmp_path)
        with transport.Net():
            pass
    assert prof.merged_path is None
    before = {p: p.stat().st_mtime_ns for p in tmp_path.iterdir()}
    telemetry.flush_trace()
    assert {p: p.stat().st_mtime_ns for p in tmp_path.iterdir()} == before
    assert prof.rank_files() == sorted(str(p) for p in tmp_path.glob(
        "tpunet-trace-rank*.json"))


_PROBE = r"""
import json, sys, threading
import numpy as np
pkg, dump_dir = sys.argv[1], sys.argv[2]
telemetry = __import__(pkg + ".telemetry", fromlist=["x"])
transport = __import__(pkg + ".transport", fromlist=["x"])
out = {}
telemetry.reset()
for phase, us in (("detect", 1500), ("quiesce", 20), ("rendezvous", 4e6),
                  ("rewire", 900), ("detect", 7)):
    telemetry.rewire_observe(phase, us)
for kind in ("kill", "shrink", "grow", "join", "join", "readmit"):
    telemetry.churn_event(kind)
telemetry.world_size(3)
for phase, us in (("announce", 5), ("broadcast", 70000), ("verify", 1),
                  ("flip", 12)):
    telemetry.swap_observe(phase, us)
for kind in ("publish", "commit", "abort", "retry", "mismatch", "commit"):
    telemetry.swap_event(kind)
fams = ("tpunet_rewire_duration_us", "tpunet_churn_events_total",
        "tpunet_world_size", "tpunet_weight_swap_duration_us",
        "tpunet_swap_events_total")
out["series"] = {name: sorted([list(k), v] for k, v in series.items())
                 for name, series in telemetry.metrics().items()
                 if name.startswith(fams)}
with transport.Net() as ns, transport.Net() as nr:
    lc = nr.listen()
    box = {}
    th = threading.Thread(target=lambda: box.setdefault("rc", lc.accept()))
    th.start()
    sc = ns.connect(lc.handle)
    th.join()
    src = np.arange(1 << 16, dtype=np.uint8)
    dst = np.zeros_like(src)
    req = box["rc"].irecv(dst)
    sc.isend(src).wait(timeout=60)
    req.wait(timeout=60)
    for c in (sc, box["rc"], lc):
        c.close()
recorded, capacity = telemetry.flightrec_stats()
out["recorded_positive"] = recorded > 0
out["capacity"] = capacity
try:
    path = telemetry.flightrec_dump(dump_dir, reason="probe")
    dump = json.load(open(path))
    out["dump"] = {"name": path.rsplit("/", 1)[-1], "keys": sorted(dump),
                   "reason": dump.get("reason"),
                   "has_events": bool(dump.get("events"))}
except Exception as e:
    out["dump"] = type(e).__name__
verdict = telemetry.flightrec_dump_verdict("rewire_deadline")
out["verdict"] = None if verdict is None else verdict.rsplit("/", 1)[-1]
port = telemetry.metrics_port()
out["metrics_port_bound"] = port > 0
if port:
    out["scrape_has_help"] = "# HELP" in telemetry.scrape(port)
    out["scrape_default_port"] = "tpunet_world_size" in telemetry.scrape()
print(json.dumps(out))
"""


def _probe(package: str, tmp_path: Path, extra_env: dict) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUNET_")}
    env.update({"TPUNET_RANK": "0", "TPUNET_FLIGHTREC_DIR": str(tmp_path)},
               **extra_env)
    dump_dir = tmp_path / package
    dump_dir.mkdir()
    out = subprocess.run([sys.executable, "-c", _PROBE, package,
                          str(dump_dir)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("extra_env", [
    {"TPUNET_METRICS_PORT": "0"}, {"TPUNET_FLIGHTREC_EVENTS": "0"}],
    ids=["recorder-on-ephemeral-scrape", "recorder-off"])
def test_metric_series_and_flight_recorder_match_jax(tmp_path, extra_env):
    ours = _probe("tpunet_torch", tmp_path, extra_env)
    theirs = _probe("tpunet", tmp_path, extra_env)
    assert ours == theirs
    series = ours["series"]
    assert [v for _, v in series["tpunet_world_size"]] == [3.0]
    counts = {telemetry.labels(k)["phase"]: v
              for k, v in series["tpunet_rewire_duration_us_count"]}
    assert counts == {"detect": 2, "quiesce": 1, "rendezvous": 1,
                      "rewire": 1}
    assert sum(v for _, v in series["tpunet_swap_events_total"]) == 6
    if "TPUNET_FLIGHTREC_EVENTS" in extra_env:
        assert ours["dump"] == "NativeError" and ours["verdict"] is None
        assert ours["capacity"] == 0
    else:
        assert ours["recorded_positive"] and ours["capacity"] == 16384
        assert ours["dump"]["name"] == "tpunet-flightrec-rank0.json"
        assert ours["dump"]["reason"] == "probe"
        assert ours["dump"]["has_events"]
        assert ours["metrics_port_bound"] and ours["scrape_has_help"]
        assert ours["scrape_default_port"]


@pytest.mark.parametrize("call", [
    lambda t: t.rewire_observe("warmup", 1), lambda t: t.churn_event("boom"),
    lambda t: t.swap_observe("stage", 1), lambda t: t.swap_event("flop")])
def test_unknown_labels_raise_like_jax(call):
    def err(mod):
        with pytest.raises(ValueError) as info:
            call(mod)
        return str(info.value)
    assert err(telemetry) == err(jax_telemetry)


def test_scrape_without_a_listener_raises_like_jax(monkeypatch):
    monkeypatch.delenv("TPUNET_METRICS_PORT", raising=False)
    monkeypatch.setattr(telemetry, "metrics_port", lambda: 0)
    monkeypatch.setattr(jax_telemetry, "metrics_port", lambda: 0)
    msgs = []
    for mod in (telemetry, jax_telemetry):
        with pytest.raises(ValueError) as info:
            mod.scrape()
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
