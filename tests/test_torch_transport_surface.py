"""The port's transport surface against the JAX package's, on the CPU.

The socket-free goldens (``lane_parse``, ``stripe_map``,
``qos_drr_golden``, ``reduce_into``) are pure functions of the shared
native library, so both packages' wrappers run in this process on one
table of specs and dtypes, malformed specs included (same error type name,
code and message). Process-wide native state is kept apart: the QoS
scheduler's parsed env is read in a subprocess per package, and the fault
slot is cleared after each use.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from tpunet import transport as jax_transport
from tpunet_torch import _native, transport

REPO = Path(__file__).resolve().parent.parent


def _outcome(fn, *args):
    """A call's result, or (error type name, code, message)."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return (type(e).__name__, getattr(e, "code", None), str(e))


LANE_SPECS = ["addr=127.0.0.1:w=4,addr=10.0.0.2:w=1", "w=2", "w=1,w=1,w=1",
              "addr=127.0.0.1", "addr=[::1]:w=2", "addr=[fe80::1]:w=255",
              "w=0", "w=256", "addr=notanip:w=1", "bogus=1", ",w=1", "w=x",
              "addr=127.0.0.1:w=2:w=3"]


@pytest.mark.parametrize("spec", LANE_SPECS)
def test_lane_parse_matches_jax(spec):
    ours = _outcome(transport.lane_parse, spec)
    assert ours == _outcome(jax_transport.lane_parse, spec)
    if spec == "w=0":
        assert ours[0] == "NativeError" and ours[1] == -2


STRIPES = [(5 << 20, 1 << 20, [1, 1], 0), (5 << 20, 1 << 20, [1, 2], 0),
           (9 << 20, 1 << 20, [4, 1, 2], 3), (1000, 1 << 20, [1, 1], 0),
           (0, 1 << 20, [1], 0), (64 << 20, 1 << 20, [3, 1], 7),
           (1 << 20, 1 << 20, [0, 1], 0), (1 << 20, 1 << 20, [], 0),
           (1 << 20, 0, [1, 1], 0)]


@pytest.mark.parametrize("args", STRIPES, ids=lambda a: "-".join(map(str, (
    a[0], a[1], "w" + "_".join(map(str, a[2])), a[3]))))
def test_stripe_map_matches_jax(args):
    assert _outcome(transport.stripe_map, *args) == \
        _outcome(jax_transport.stripe_map, *args)


DRR = [("latency=8,bulk=1", "wire=128K", "bulk:64K,latency:64K,control:4K"),
       ("latency=1,bulk=1", "wire=64K",
        "bulk:64K,bulk:64K,latency:64K,latency:64K"),
       ("latency=3,bulk=2", "wire=1M", "latency:1M,bulk:512K,control:1K"),
       ("", "wire=256K", "bulk:64K,latency:64K"),
       ("latency=0", "wire=64K", "bulk:64K"),
       ("latency=8", "wire=64K", "nope:64K"),
       ("latency=8", "window=64K", "bulk:64K"),
       ("latency=8", "wire=64K", "bulk:many")]


@pytest.mark.parametrize("args", DRR, ids=lambda a: "|".join(a))
def test_qos_drr_golden_matches_jax(args):
    ours = _outcome(transport.qos_drr_golden, *args)
    assert ours == _outcome(jax_transport.qos_drr_golden, *args)


_NP = {"f32": np.float32, "f64": np.float64, "i32": np.int32,
       "i64": np.int64, "u8": np.uint8, "bf16": np.uint16}
_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def _operands(dtype: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if dtype == "bf16":
        # Finite bf16 values as uint16 bit patterns.
        f = rng.standard_normal((2, n)).astype(np.float32) * 8
        return tuple(np.ascontiguousarray((x.view(np.uint32) >> 16)
                                          .astype(np.uint16)) for x in f)
    if dtype.startswith("f"):
        return tuple(rng.standard_normal((2, n)).astype(_NP[dtype]))
    hi = 200 if dtype == "u8" else 1000
    return tuple(rng.integers(0, hi, (2, n)).astype(_NP[dtype]))


@pytest.mark.parametrize("op", ["sum", "prod", "min", "max"])
@pytest.mark.parametrize("dtype", ["f32", "f64", "bf16", "i32", "i64", "u8"])
def test_reduce_into_matches_jax(dtype, op):
    """Numpy operands (and CPU tensors for f32 and bf16), out of place and
    in place, against the JAX wrapper's bytes; 1027 elements covers the
    SIMD body and the scalar tail."""
    a, b = _operands(dtype, 1027, seed=sum(map(ord, dtype + op)))
    want = np.empty_like(a)
    jax_transport.reduce_into(want, a, b, dtype, op)
    got = np.empty_like(a)
    transport.reduce_into(got, a, b, dtype, op)
    np.testing.assert_array_equal(got, want)
    acc = a.copy()
    transport.reduce_into(acc, acc, b, dtype, op)  # dst is a: in place
    np.testing.assert_array_equal(acc, want)
    if dtype in _TORCH:
        bits = np.int16 if dtype == "bf16" else np.float32
        ta, tb = (torch.from_numpy(x.view(bits).copy()).view(_TORCH[dtype])
                  for x in (a, b))
        td = torch.empty_like(ta)
        transport.reduce_into(td, ta, tb, dtype, op)
        got_t = td.view(torch.int16) if dtype == "bf16" else td
        np.testing.assert_array_equal(got_t.numpy().view(want.dtype), want)


def test_reduce_into_refusals_match_jax():
    a = np.ones(4, np.float32)
    for args in ((a, a, a, "f16"), (a, a, a, "f32", "mean"),
                 (a, a, np.ones(5, np.float32), "f32"),
                 (np.ones(8, np.float32)[::2], a, a, "f32")):
        ours = _outcome(transport.reduce_into, *args)
        assert ours[0] == "ValueError"
        theirs = _outcome(jax_transport.reduce_into, *args)
        assert ours[0] == theirs[0]
    # A non-contiguous tensor is refused, never copied.
    with pytest.raises(ValueError, match="contiguous"):
        transport.reduce_into(torch.ones(8)[::2], torch.ones(4),
                              torch.ones(4), "f32")


_QOS_ENV = {"TPUNET_QOS_WEIGHTS": "latency=4,bulk=2,control=3",
            "TPUNET_QOS_INFLIGHT_BYTES": "latency=64M,bulk=1G,wire=4M"}


def _qos_state_in(package: str) -> dict:
    code = (f"import json; from {package} import transport; "
            "print(json.dumps(transport.qos_state()))")
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUNET_")}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**env, **_QOS_ENV}, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_qos_state_under_env_matches_jax():
    ours = _qos_state_in("tpunet_torch")
    assert ours == _qos_state_in("tpunet")
    assert ours["weights"] == {"latency": 4, "bulk": 2, "control": 3}
    assert ours["budgets"]["latency"] == 64 << 20
    assert ours["budgets"]["bulk"] == 1 << 30
    assert ours["wire_window"] == 4 << 20


def test_net_devices_and_properties_match_jax():
    with transport.Net() as ours, jax_transport.Net() as theirs:
        assert ours.devices() == theirs.devices() >= 1
        for dev in range(ours.devices()):
            assert ours.properties(dev) == theirs.properties(dev)
        assert _outcome(ours.properties, 99)[0] == \
            _outcome(theirs.properties, 99)[0] == "NativeError"


def test_recv_comm_recv_round_trips_a_buffer():
    with transport.Net() as ns, transport.Net() as nr:
        lc = nr.listen()
        box: dict = {}
        th = threading.Thread(target=lambda: box.setdefault("rc",
                                                            lc.accept()))
        th.start()
        sc = ns.connect(lc.handle)
        th.join(timeout=60)
        rc = box["rc"]
        try:
            for n in (0, 33, 3 << 20):
                src = np.random.default_rng(n).integers(
                    0, 255, n).astype(np.uint8)
                dst = np.zeros(n + 7, np.uint8)  # larger than the message
                sreq = sc.isend(src)
                assert rc.recv(dst, timeout=60) == n
                sreq.wait(timeout=60)
                np.testing.assert_array_equal(dst[:n], src)
        finally:
            for c in (sc, rc, lc):
                c.close()


FAULT_SPECS = ["stream=1:after_bytes=1M:action=close",
               "side=send:action=corrupt", "stream=0:action=delay=5",
               "churn:at_step=3:rank=1:action=kill",
               "stream=1:action=explode", "stream=x:action=close",
               "after_bytes=1Q:action=close",
               "stream=0:action=close;stream=1:action=close",
               "churn:at_step=1:action=nuke", ";churn:action=kill"]


@pytest.mark.parametrize("spec", FAULT_SPECS)
def test_fault_inject_and_clear_match_jax(spec):
    try:
        ours = _outcome(transport.fault_inject, spec)
        transport.fault_clear()
        theirs = _outcome(jax_transport.fault_inject, spec)
        assert ours == theirs
        if ours[0] != "ok":
            assert ours[0] == "NativeError" and ours[1] == \
                _native.TPUNET_ERR_INVALID
            assert isinstance(_outcome_exc(transport.fault_inject, spec),
                              _native.NativeError)
    finally:
        transport.fault_clear()
    assert _outcome(transport.fault_clear) == ("ok", None)


def _outcome_exc(fn, *args):
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001
        return e
    return None
