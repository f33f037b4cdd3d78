"""The port's live weight updates (tpunet_torch/serve/publish.py and the swap
frames of the decode tier and the router) against the JAX package's, on
the CPU.

Coverage, each case beside its counterpart in tests/test_publish.py:
  * Swap chaos grammar: the native parse and one-shot poll sequence, beside
    churn and classic segments, and the typed rejection of malformed specs,
    run in one subprocess per package (both bindings share one
    libtpunet.so, whose swap script is process-wide); the Python mirror
    against JAX's on the same specs, messages included.
  * Protocol: SwapAnnounce bytes equal to JAX's, the same typed refusals;
    the HELLO's weight version in the class word.
  * Knobs, the typed -10 error, the swap metrics.
  * The wire: flatten_params(from_flax(tree)) bitwise JAX's
    flatten_params(tree) (order, layout, f32), the same bf16 wire and
    CRC32C; unflatten and the bf16 round trip bitwise; truncation, the
    receiver deadline, the version rule and the abandoned wedged broadcast
    thread typed; one native 1 MiB piece per broadcast call on both ends.
  * The tier (router + prefill on this thread, decode ranks on threads,
    real loopback comms, f32 KV wire): a hot swap keeps old sessions on v0
    and serves new ones on v1, every token bitwise the JAX generate oracle
    on the request's version, v0 retired on both tiers; one corrupt
    receiver refuses the flip fleet-wide and the clean retry commits; a
    stale rank re-admitted after the fleet moved on is caught up and its
    old version retired.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from conftest import free_port  # noqa: F401  (pins JAX_PLATFORMS=cpu first)

import jax
import jax.numpy as jnp
import torch

from tpunet.models import Transformer as JaxTransformer
from tpunet.models import generate as jax_generate
from tpunet.serve import protocol as jax_proto
from tpunet.serve import publish as jax_publish
from tpunet_torch import _native, serve, telemetry, transport
from tpunet_torch.models import Transformer, from_flax
from tpunet_torch.serve import protocol as proto
from tpunet_torch.serve import publish

REPO = Path(__file__).resolve().parent.parent
CFG = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64)
MAX_LEN = 40


@pytest.fixture(scope="module")
def models():
    """The JAX oracle model and the port's (CPU, f32), with the flax
    params of seeds 1, 2 and 3 and their port state_dicts."""
    jm = JaxTransformer(compute_dtype=jnp.float32, **CFG)
    tm = Transformer(compute_dtype=torch.float32, attn_impl="flash",
                     device="cpu", **CFG)
    init = jax.jit(jm.init)
    toks = jax.random.randint(jax.random.PRNGKey(0), (2, 24), 0, 64)
    trees = [jax.tree.map(np.asarray, init(jax.random.PRNGKey(s), toks)[
        "params"]) for s in (1, 2, 3)]
    sds = [from_flax(t, tm) for t in trees]
    return jm, tm, trees, sds


def _oracle(jm, tree, prompt, n):
    out = jax_generate(jm, jax.tree.map(jnp.asarray, tree),
                       jnp.asarray(prompt)[None], n)
    return np.asarray(out)[0, len(prompt):]


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, n).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# Swap chaos grammar: the native script in one subprocess per package.

_MALFORMED = ("swap:at_step=1:action=flip", "swap:at_step=1",
              "swap:badkey=1:action=publish", "swap:at_step=x:action=die",
              "swap")

_GRAMMAR_SCRIPT = r"""
import json, sys
pkg = sys.argv[1]
if pkg == "tpunet":
    import jax
    jax.config.update("jax_platforms", "cpu")
    from tpunet import _native, elastic, transport
    from tpunet.serve import publish
else:
    from tpunet_torch import _native, elastic, transport
    from tpunet_torch.serve import publish
lib = _native.load()
inject = lambda spec: int(lib.tpunet_c_fault_inject(spec.encode()))
out = {"poll": [inject("swap:at_step=4:action=publish;"
                       "swap:at_step=8:action=die")]}
out["poll"] += [publish.swap_pending(), publish.swap_action(3),
                publish.swap_action(5), publish.swap_action(5),
                publish.swap_pending(), publish.swap_action(9),
                publish.swap_pending()]
transport.fault_clear()
out["poll"].append(publish.swap_pending())
out["mixed"] = [inject("stream=1:action=close;"
                       "churn:at_step=2:rank=0:action=kill;"
                       "swap:at_step=3:action=corrupt")]
out["mixed"] += [publish.swap_pending(), elastic.churn_pending(),
                 publish.swap_action(3), elastic.churn_action(2, 0)]
transport.fault_clear()
out["malformed"] = {s: [inject(s), _native.last_error()]
                    for s in json.loads(sys.argv[2])}
print("GRAMMAR " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def grammar():
    runs = {}
    for pkg in ("tpunet", "tpunet_torch"):
        res = subprocess.run(
            [sys.executable, "-c", _GRAMMAR_SCRIPT, pkg,
             json.dumps(_MALFORMED)], cwd=REPO, capture_output=True,
            text=True, timeout=120,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert res.returncode == 0, res.stderr
        line = [x for x in res.stdout.splitlines()
                if x.startswith("GRAMMAR ")][-1]
        runs[pkg] = json.loads(line[len("GRAMMAR "):])
    return runs


def test_swap_script_native_parse_and_poll(grammar):
    ours = grammar["tpunet_torch"]["poll"]
    assert ours == [0, 2, None, "publish", None, 1, "die", 0, 0]
    assert ours == grammar["tpunet"]["poll"]


def test_swap_script_rides_alongside_churn_and_classic_segments(grammar):
    ours = grammar["tpunet_torch"]["mixed"]
    assert ours == [0, 1, 1, "corrupt", "kill"]
    assert ours == grammar["tpunet"]["mixed"]


@pytest.mark.parametrize("spec", _MALFORMED)
def test_swap_script_malformed_typed(grammar, spec):
    rc, msg = grammar["tpunet_torch"]["malformed"][spec]
    assert rc == _native.TPUNET_ERR_INVALID and msg
    assert [rc, msg] == grammar["tpunet"]["malformed"][spec]


def test_parse_swap_script_python_mirror():
    spec = ("churn:at_step=1:rank=0:action=kill;"
            "swap:at_step=5:action=publish;swap:at_step=9:action=die")
    assert publish.parse_swap_script(spec) == [
        {"at_step": 5, "action": "publish"}, {"at_step": 9, "action": "die"}]
    assert publish.parse_swap_script(spec) == jax_publish.parse_swap_script(
        spec)
    for bad in ("swap:at_step=1:action=flip", "swap:at_step=1",
                "swap:badkey=1:action=die", "swap:at_step",
                "swap:at_step=x:action=die"):
        with pytest.raises(ValueError) as ours:
            publish.parse_swap_script(bad)
        with pytest.raises(ValueError) as theirs:
            jax_publish.parse_swap_script(bad)
        assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# Protocol: SwapAnnounce, the HELLO's weight version.


@pytest.mark.parametrize("fields", [
    (7, 3, 2, 123457, 1 << 16, "bf16", 30_000, "127.0.0.1:2947", "bulk"),
    (1, 2, 1, 659_605_504, 64 << 20, "f32", 120_000, "10.0.0.1:7", "control"),
])
def test_swap_announce_roundtrip(fields):
    ann = proto.SwapAnnounce(*fields[:8], traffic_class=fields[8])
    packed = proto.pack_swap_begin(ann)
    assert packed == jax_proto.pack_swap_begin(
        jax_proto.SwapAnnounce(*fields[:8], traffic_class=fields[8]))
    out = proto.unpack_swap_begin(packed)
    assert (out.version, out.world, out.rank, out.nelems, out.chunk_bytes,
            out.codec, out.timeout_ms, out.coordinator,
            out.traffic_class) == fields
    assert proto._SWAP_HDR.format == jax_proto._SWAP_HDR.format
    assert (proto.T_SWAP_BEGIN, proto.T_SWAP_STATUS, proto.T_SWAP_RETIRE,
            proto.SWAP_FLIPPED, proto.SWAP_ABORTED) == (
        jax_proto.T_SWAP_BEGIN, jax_proto.T_SWAP_STATUS,
        jax_proto.T_SWAP_RETIRE, jax_proto.SWAP_FLIPPED,
        jax_proto.SWAP_ABORTED)


def test_swap_announce_typed_refusals():
    good = proto.pack_swap_begin(
        proto.SwapAnnounce(1, 2, 1, 10, 4096, "bf16", 1000, "h:1"))
    bad_codec = bytearray(good)
    bad_codec[proto._SWAP_HDR.size - 6] = 99       # codec id byte
    bad_class = bytearray(good)
    bad_class[proto._SWAP_HDR.size - 5] = 9        # traffic class byte
    refused = [
        good[:8],                                  # shorter than sub-header
        bytes(bad_codec), bytes(bad_class),
        # rank 0 is the publisher, never a receiver
        proto._SWAP_HDR.pack(1, 2, 0, 10, 4096, 1, 1, 1000) + b"h:1",
        proto._SWAP_HDR.pack(1, 2, 2, 10, 4096, 1, 1, 1000) + b"h:1",
        # the coordinator must be host:port
        proto._SWAP_HDR.pack(1, 2, 1, 10, 4096, 1, 1, 1000) + b"nohost",
    ]
    for payload in refused:
        with pytest.raises(proto.TierProtocolError) as ours:
            proto.unpack_swap_begin(payload)
        with pytest.raises(jax_proto.TierProtocolError) as theirs:
            jax_proto.unpack_swap_begin(payload)
        assert str(ours.value) == str(theirs.value)
    for kw in ({"traffic_class": "warp"}, {"codec": "int4"}):
        args = dict(version=1, world=2, rank=1, nelems=10, chunk_bytes=4096,
                    codec="bf16", timeout_ms=1000, coordinator="h:1")
        args.update(kw)
        with pytest.raises(ValueError) as ours:
            proto.pack_swap_begin(proto.SwapAnnounce(**args))
        with pytest.raises(ValueError) as theirs:
            jax_proto.pack_swap_begin(jax_proto.SwapAnnounce(**args))
        assert str(ours.value) == str(theirs.value)


def test_hello_weight_version_rides_class_word():
    h = proto.Hello(proto.ROLE_DECODE, "int8", 4, 128, 64, 0xBEEF,
                    weight_version=3)
    assert h.pack() == jax_proto.Hello(
        jax_proto.ROLE_DECODE, "int8", 4, 128, 64, 0xBEEF,
        weight_version=3).pack()
    out = proto.Hello.unpack(h.pack())
    assert out.weight_version == 3 and out.traffic_class == "latency"
    legacy = proto.Hello(proto.ROLE_DECODE, "int8", 4, 128, 64, 0xBEEF)
    assert proto.Hello.unpack(legacy.pack()).weight_version == 0
    with pytest.raises(ValueError):
        proto.Hello(proto.ROLE_DECODE, "int8", 4, 128, 64, 0,
                    weight_version=1 << 24)


# ---------------------------------------------------------------------------
# Knobs + typed error + metrics.


def test_swap_knobs_registered_and_validated(monkeypatch):
    from tpunet_torch.config import Config

    cfg = Config.from_env()
    assert (cfg.swap_timeout_ms, cfg.swap_chunk_bytes, cfg.publish_class) \
        == (30_000, 1 << 20, "bulk")
    monkeypatch.setenv("TPUNET_SWAP_TIMEOUT_MS", "5000")
    monkeypatch.setenv("TPUNET_SWAP_CHUNK_BYTES", "65536")
    monkeypatch.setenv("TPUNET_PUBLISH_CLASS", "control")
    cfg = Config.from_env()
    assert (cfg.swap_timeout_ms, cfg.swap_chunk_bytes, cfg.publish_class) \
        == (5000, 65536, "control")

    class _R:
        version = 0

    pub = publish.WeightPublisher(_R())
    assert (pub.timeout_ms, pub.chunk_bytes, pub.publish_class) == (
        5000, 65536, "control")
    for var, bad in (("TPUNET_SWAP_TIMEOUT_MS", "0"),
                     ("TPUNET_SWAP_CHUNK_BYTES", "16"),
                     ("TPUNET_SWAP_CHUNK_BYTES", str(1 << 31)),
                     ("TPUNET_PUBLISH_CLASS", "fast")):
        with monkeypatch.context() as m:
            m.setenv(var, bad)
            with pytest.raises(ValueError, match=var):
                Config.from_env()
    with pytest.raises(ValueError, match="f32 or bf16"):
        publish.WeightPublisher(_R(), codec="int8")


def test_weight_swap_error_is_typed_and_mapped():
    assert _native.TPUNET_ERR_WEIGHT_SWAP == -10
    with pytest.raises(publish.WeightSwapError):
        _native.check(_native.TPUNET_ERR_WEIGHT_SWAP, "probe")
    assert issubclass(publish.WeightSwapError, _native.NativeError)
    assert serve.WeightSwapError is publish.WeightSwapError


def test_swap_metrics_accessors_and_reset():
    telemetry.reset()
    telemetry.swap_observe("broadcast", 1234)
    telemetry.swap_observe("flip", 77)
    telemetry.swap_event("commit")
    telemetry.weight_version(5)
    m = telemetry.metrics()
    counts = {telemetry.labels(k).get("phase"): v
              for k, v in m["tpunet_weight_swap_duration_us_count"].items()}
    assert counts["broadcast"] == 1 and counts["flip"] == 1
    assert counts["announce"] == 0 and counts["verify"] == 0
    events = {telemetry.labels(k).get("kind"): v
              for k, v in m["tpunet_swap_events_total"].items()}
    assert events["commit"] == 1 and events["abort"] == 0
    assert next(iter(m["tpunet_weight_version"].values())) == 5
    with pytest.raises(ValueError):
        telemetry.swap_observe("warmup", 1)
    with pytest.raises(ValueError):
        telemetry.swap_event("explode")
    telemetry.reset()
    m = telemetry.metrics()
    assert sum(m["tpunet_weight_swap_duration_us_count"].values()) == 0
    assert next(iter(m["tpunet_weight_version"].values())) == 0


# ---------------------------------------------------------------------------
# The wire: same bytes as JAX's; helper failure paths typed.


def test_flatten_params_bytes_equal_jax(models):
    """Leaf order (block10 after block1, kernels as flax's (in, out)) and
    values: the port's vector of a converted tree is JAX's, bitwise, and so
    are the bf16 wire and its CRC32C; unflatten gives the state_dict back
    bitwise, in the port's layout."""
    _, tm, trees, sds = models
    ours = publish.flatten_params(sds[0])
    theirs = jax_publish.flatten_params(trees[0])
    assert ours.dtype == np.float32 and ours.flags.c_contiguous
    assert ours.tobytes() == theirs.tobytes()
    wire = transport.codec_encode(ours, "bf16")
    jwire = jax_publish.transport.codec_encode(theirs, "bf16")
    assert wire.tobytes() == jwire.tobytes()
    assert transport.crc32c(wire) == jax_publish.transport.crc32c(jwire)
    back = publish.unflatten_params(sds[0], ours)
    assert list(back) == list(sds[0])
    for name, t in sds[0].items():
        assert back[name].shape == t.shape and back[name].dtype == t.dtype
        assert torch.equal(back[name], t)
    # The round trip under bf16: the port's equals JAX's, converted.
    rt = publish.roundtrip_params(sds[1], "bf16")
    jrt = from_flax(jax.tree.map(np.asarray, jax_publish.roundtrip_params(
        trees[1], "bf16")), tm)
    for name in rt:
        assert torch.equal(rt[name], jrt[name]), name
    # bf16 parameters: the bf16 round trip is the identity, and the
    # norm scales stay f32.
    b16 = {k: (v if k.endswith(".scale") else v.to(torch.bfloat16))
           for k, v in sds[1].items()}
    rt16 = publish.roundtrip_params(b16, "bf16")
    for name, t in b16.items():
        assert rt16[name].dtype == t.dtype and torch.equal(rt16[name], t)


def test_flatten_params_orders_and_lays_out_like_the_flax_tree():
    """Sorted keys at every level (block10 before block2) and conv kernels
    HWIO, on a tree with no model behind it."""
    rng = np.random.default_rng(0)
    tree = {"block10": {"attn": {"kernel": rng.standard_normal((3, 5))}},
            "block2": {"mlp": {"kernel": rng.standard_normal((5, 2))},
                       "norm": {"scale": rng.standard_normal(5)}},
            "conv0": {"kernel": rng.standard_normal((3, 3, 2, 4)),
                      "bias": rng.standard_normal(4)},
            "embed": {"embedding": rng.standard_normal((7, 3))}}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    sd = {"embed.embedding": torch.from_numpy(tree["embed"]["embedding"]),
          "conv0.weight": torch.from_numpy(
              tree["conv0"]["kernel"]).permute(3, 2, 0, 1).contiguous(
                  memory_format=torch.channels_last),
          "conv0.bias": torch.from_numpy(tree["conv0"]["bias"]),
          "block2.norm.scale": torch.from_numpy(tree["block2"]["norm"][
              "scale"]),
          "block2.mlp.weight": torch.from_numpy(
              tree["block2"]["mlp"]["kernel"]).T.contiguous(),
          "block10.attn.weight": torch.from_numpy(
              tree["block10"]["attn"]["kernel"]).T.contiguous()}
    flat = publish.flatten_params(sd)
    assert flat.tobytes() == jax_publish.flatten_params(tree).tobytes()
    back = publish.unflatten_params(sd, flat)
    for name, t in sd.items():
        assert torch.equal(back[name], t)
        assert back[name].stride() == t.stride()  # channels-last kept
    assert publish.flatten_params({}).size == 0


def test_unflatten_truncation_typed(models):
    _, _, trees, sds = models
    flat = publish.flatten_params(sds[0])
    jflat = jax_publish.flatten_params(trees[0])
    for cut in (flat[:-5], np.concatenate([flat, np.zeros(3, np.float32)])):
        with pytest.raises(publish.WeightSwapError) as ours:
            publish.unflatten_params(sds[0], cut)
        with pytest.raises(jax_publish.WeightSwapError) as theirs:
            jax_publish.unflatten_params(trees[0], cut)
        assert str(ours.value) == str(theirs.value)
    assert jflat.size == flat.size


def test_receiver_deadline_typed(models):
    _, _, _, sds = models
    ann = proto.SwapAnnounce(1, 2, 1, 64, 4096, "bf16", 1,
                             "127.0.0.1:1")  # 1 ms deadline, no publisher
    recv = publish.WeightReceiver(ann, sds[0])
    time.sleep(0.01)
    with pytest.raises(publish.WeightSwapError, match="deadline"):
        recv.pump()
    assert recv.staged is None and recv.wire is None
    recv.abort()  # idempotent
    with pytest.raises(publish.WeightSwapError, match="nothing verified"):
        recv.stage()


def test_publish_version_must_increase():
    class _R:
        version = 3

    with pytest.raises(ValueError, match="must increase"):
        publish.WeightPublisher(_R()).publish(3, {})


def test_publish_abandons_wedged_broadcast_thread(monkeypatch):
    """A broadcast parked beyond the reach of the deadline force-close: the
    supervisor abandons the daemon thread past deadline + grace and raises
    typed, never wedging the serving loop."""

    class _Rank:
        alive = True
        index = 0

    class _Prefill:
        model = None
        max_len = 8

    class _Router:
        version = 0
        _ranks = [_Rank()]
        _swap_status: dict = {}
        prefill = _Prefill()

        def poll(self):
            pass

    params = {"w": np.arange(8, dtype=np.float32)}
    pub = publish.WeightPublisher(_Router(), timeout_ms=150)
    wedge = threading.Event()
    monkeypatch.setattr(pub, "_broadcast_to",
                        lambda *a, **k: wedge.wait())
    monkeypatch.setattr(publish, "_CAST_ABANDON_GRACE_S", 0.2)
    t0 = time.monotonic()
    with pytest.raises(publish.WeightSwapError, match="abandoned"):
        pub.publish(1, params, retries=0)
    assert time.monotonic() - t0 < 5.0, "abandon did not bound the wait"
    assert pub.stats["aborts"] == 1 and pub.phase is None
    wedge.set()  # release the deliberately leaked daemon thread


def test_broadcast_calls_carry_one_native_piece(monkeypatch):
    """Whatever the chunk size, every native broadcast call of a
    publication moves at most one 1 MiB pipeline piece, on the publisher
    and on the receiver alike (``Communicator.broadcast`` splits its
    buffer): a call of several pieces lets a later piece hold the QoS wire
    credit the receiver's awaited piece needs, and both ends park until
    the watchdog. A 2.5 MiB chunk that is no whole number of pieces still
    gives the receiver the sent wire byte for byte (real loopback comms,
    receiver on a thread)."""
    from tpunet_torch import _native

    sizes: dict[int, list[int]] = {}
    lib = _native.load()
    native = lib.tpunet_comm_broadcast

    def spy(comm, buf, nbytes, root):
        sizes.setdefault(comm, []).append(int(nbytes))
        return native(comm, buf, nbytes, root)

    monkeypatch.setattr(lib, "tpunet_comm_broadcast", spy)
    nelems = (5 << 20) // 4 + 61  # 2.5 MiB + 122 B of bf16 wire
    wire = np.random.default_rng(0).integers(
        0, 256, transport.codec_wire_bytes("bf16", nelems)).astype(np.uint8)
    box: dict = {}

    def receive(ann):
        try:
            recv = publish.WeightReceiver(ann, {})
            deadline = time.monotonic() + 60
            while not recv.pump():
                assert time.monotonic() < deadline, "receiver never done"
                time.sleep(0.002)
            box["wire"] = recv.wire
        except BaseException as e:  # noqa: BLE001 — asserted below
            box["err"] = e

    class _Link:
        def send_frame(self, ftype, token, payload):
            assert ftype == proto.T_SWAP_BEGIN
            thread = threading.Thread(
                target=receive, args=(proto.unpack_swap_begin(payload),))
            thread.start()
            box["thread"] = thread

    class _Rank:
        alive, index, link = True, 0, _Link()

    class _Router:
        _ranks = [_Rank()]

    pub = publish.WeightPublisher(_Router(), chunk_bytes=5 << 19,
                                  timeout_ms=60_000)
    pub._broadcast_to(_Router._ranks, 1, 1, wire, nelems,
                      time.monotonic() + 60, pump=lambda: None)
    box["thread"].join(timeout=60)
    assert "err" not in box, box.get("err")
    assert box["wire"].tobytes() == wire.tobytes()
    mib = 1 << 20
    tail = wire.size - 5 * mib // 2
    assert list(sizes.values()) == [[mib, mib, mib // 2, tail]] * 2


# ---------------------------------------------------------------------------
# The tier: hot swap, CRC refusal, catch-up.


def _decode_thread(addr, tm, sd, box, key, *, slots, weight_version=0):
    def main():
        try:
            worker = serve.connect_decode(
                addr, tm, sd, slots=slots, max_len=MAX_LEN, kv_codec="f32",
                weight_version=weight_version, device="cpu")
            box[key] = worker
            try:
                worker.serve()
            finally:
                worker.close()
        except BaseException as e:  # noqa: BLE001 — checked by the test
            box[key + "_err"] = e

    th = threading.Thread(target=main, daemon=True)
    th.start()
    return th


def _start_tier(tm, sd, *, slots, policy=None):
    lsock = serve.Router.listen("127.0.0.1:0")
    addr = "127.0.0.1:%d" % lsock.getsockname()[1]
    box: dict = {}
    th = _decode_thread(addr, tm, sd, box, "a", slots=slots)
    pe = serve.PrefillEngine(tm, sd, max_len=MAX_LEN, device="cpu")
    router = serve.Router(pe, kv_codec="f32", policy=policy)
    router.accept_ranks(lsock, 1)
    return router, box, [th], lsock, addr


def _stop(router, threads, lsock, box):
    router.shutdown()
    for th in threads:
        th.join(timeout=60)
    router.close()
    lsock.close()
    assert not any(th.is_alive() for th in threads)
    errs = [v for k, v in box.items() if k.endswith("_err")]
    assert not errs, errs


def _swap_events():
    m = telemetry.metrics()
    return {telemetry.labels(k).get("kind"): v
            for k, v in m["tpunet_swap_events_total"].items()}


def test_hot_swap_pins_old_sessions_and_serves_new_on_v1(models):
    jm, tm, trees, sds = models
    rt1 = jax_publish.roundtrip_params(trees[1], "bf16")
    telemetry.reset()
    router, box, threads, lsock, _ = _start_tier(tm, sds[0], slots=1)
    try:
        filler_p, pinned_p, new_p = _prompts(3, (5, 7, 9))
        # Occupy the single slot, then admit a request that must wait: it
        # is pinned to v0 at admission and decodes after the flip.
        filler = router.submit(filler_p, 24)
        pinned = router.submit(pinned_p, 6)

        pub = serve.WeightPublisher(router, chunk_bytes=16384)
        pub.publish(1, sds[1])
        assert router.version == 1
        assert router._ranks[0].versions >= {0, 1}
        new = router.submit(new_p, 6)  # admitted under v1
        assert router._recs[new]["version"] == 1
        assert router._recs[pinned]["version"] == 0
        results = router.run(timeout=240)

        # v0 requests on the pristine params (they never crossed the
        # weight wire), the v1 request on the bf16-roundtripped checkpoint.
        np.testing.assert_array_equal(
            results[filler], _oracle(jm, trees[0], filler_p, 24))
        np.testing.assert_array_equal(
            results[pinned], _oracle(jm, trees[0], pinned_p, 6))
        np.testing.assert_array_equal(
            results[new], _oracle(jm, rt1, new_p, 6))

        # The drained v0 retires on both tiers.
        router.poll()
        assert set(router._prefills) == {1} and router.version == 1
        worker = box["a"]
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and len(worker._servers) != 1:
            router.poll()
            time.sleep(0.02)
        assert set(worker._servers) == {1} and set(worker._params) == {1}
        assert worker.version == 1 and worker.stats["swaps"] == 1
        assert worker.srv is worker._servers[1]

        m = telemetry.metrics()
        counts = {telemetry.labels(k).get("phase"): v for k, v in
                  m["tpunet_weight_swap_duration_us_count"].items()}
        for phase in ("announce", "broadcast", "verify", "flip"):
            assert counts[phase] >= 1, f"phase {phase} never observed"
        events = _swap_events()
        assert events["publish"] >= 1 and events["commit"] >= 2
        assert events["abort"] == 0 and events["mismatch"] == 0
        assert next(iter(m["tpunet_weight_version"].values())) == 1
        assert router.stats["swaps"] == 1
        assert router.stats["rank_failures"] == 0
        assert pub.stats == {"publishes": 1, "commits": 1, "aborts": 0,
                             "retries": 0, "catch_ups": 0}
    finally:
        _stop(router, threads, lsock, box)


def test_crc_mismatch_refuses_flip_fleet_wide_then_retries_clean(models):
    jm, tm, trees, sds = models
    telemetry.reset()
    router, box, threads, lsock, _ = _start_tier(tm, sds[0], slots=2)
    try:
        deadline = time.monotonic() + 60
        while "a" not in box and time.monotonic() < deadline:
            time.sleep(0.01)
        worker = box["a"]
        worker._corrupt_next = True  # the "corrupt" action's own hook

        pub = serve.WeightPublisher(router, chunk_bytes=16384)
        with pytest.raises(publish.WeightSwapError, match="CRC32C"):
            pub.publish(1, sds[1], retries=0)
        # Refused fleet-wide: both tiers still on v0, still serving it.
        assert router.version == 0 and worker.version == 0
        (p,) = _prompts(5, (6,))
        rid = router.submit(p, 5)
        res = router.run(timeout=240)
        np.testing.assert_array_equal(res[rid], _oracle(jm, trees[0], p, 5))
        events = _swap_events()
        assert events["mismatch"] >= 1 and events["abort"] >= 1
        assert worker.stats["swap_aborts"] == 1

        # Retryable: the same version publishes clean on the next attempt.
        pub.publish(1, sds[1])
        assert router.version == 1
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and worker.version != 1:
            router.poll()
            time.sleep(0.02)
        assert worker.version == 1
        assert pub.stats["aborts"] == 1 and pub.stats["commits"] == 1
    finally:
        _stop(router, threads, lsock, box)


def test_stale_readmitted_rank_is_caught_up(models, monkeypatch):
    """The fleet moves to v1 on rank A; a host then joins on the
    re-admission port still serving v0 (HELLO weight_version 0): catch_up()
    brings it to v1 over a world=2 broadcast of the retained wire, its v0
    retires, and new requests on both ranks give the v1 oracle's tokens."""
    jm, tm, trees, sds = models
    monkeypatch.setenv("TPUNET_READMIT_PROBE_MS", "20")
    rt1 = jax_publish.roundtrip_params(trees[1], "bf16")
    router, box, threads, lsock, addr = _start_tier(
        tm, sds[0], slots=2, policy="round_robin")
    try:
        router.enable_readmission(lsock)
        pub = serve.WeightPublisher(router, chunk_bytes=16384)
        assert pub.catch_up() == 0  # nothing published yet
        pub.publish(1, sds[1])
        threads.append(_decode_thread(addr, tm, sds[0], box, "b", slots=2,
                                      weight_version=0))
        deadline = time.monotonic() + 60
        while not router.stats["readmissions"]:
            assert time.monotonic() < deadline, "stale host never admitted"
            router.poll_admissions()
            router.poll()
            time.sleep(0.01)
        stale = router._ranks[1]
        assert stale.versions == {0}
        assert pub.catch_up() == 1 and pub.stats["catch_ups"] == 1
        assert stale.versions >= {1}
        prompts = _prompts(8, (4, 6, 5, 7))
        ids = [router.submit(p, 5) for p in prompts]
        res = router.run(timeout=240)
        for i, p in zip(ids, prompts):
            np.testing.assert_array_equal(res[i], _oracle(jm, rt1, p, 5))
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and len(box["b"]._servers) != 1:
            router.poll()
            time.sleep(0.02)
        for key in ("a", "b"):
            assert set(box[key]._servers) == {1}, key
            assert box[key].version == 1
            assert box[key].stats["results"] >= 1  # both ranks served
        assert stale.versions == {1} and set(router._prefills) == {1}
        assert pub.catch_up() == 0  # nobody is stale now
    finally:
        _stop(router, threads, lsock, box)


def test_bootstrap_clamps_that_overlap_restore_the_users_knob(monkeypatch):
    """A publisher and a receiver that are threads of one process clamp the
    process-wide bootstrap knob at once and end in either order: while one
    rendezvous is still open the knob holds a swap budget, and once both
    ended it is the user's value again (no clamp leaks past its swap)."""
    for user in (None, "45000"):
        if user is None:
            monkeypatch.delenv("TPUNET_BOOTSTRAP_TIMEOUT_MS", raising=False)
        else:
            monkeypatch.setenv("TPUNET_BOOTSTRAP_TIMEOUT_MS", user)
        deadline = time.monotonic() + 30.0
        first = publish._bounded_bootstrap(deadline)
        second = publish._bounded_bootstrap(deadline - 10.0)
        first.__enter__()
        second.__enter__()
        first.__exit__(None, None, None)  # the publisher's side ends first
        held = os.environ.get("TPUNET_BOOTSTRAP_TIMEOUT_MS")
        assert held is not None and 0 < int(held) <= 30_000, held
        second.__exit__(None, None, None)
        assert os.environ.get("TPUNET_BOOTSTRAP_TIMEOUT_MS") == user


def test_retire_sweep_spares_a_readmitted_rank_serving_that_version(
        models, monkeypatch):
    """A stale host re-admitted before the router's first sweep after a flip
    still serves the old version: the sweep must neither tell it to retire
    its live version nor forget that it holds it (the catch-up then targets
    it and retires the old version there)."""
    jm, tm, trees, sds = models
    monkeypatch.setenv("TPUNET_READMIT_PROBE_MS", "20")
    router, box, threads, lsock, addr = _start_tier(
        tm, sds[0], slots=2, policy="round_robin")
    try:
        router.enable_readmission(lsock)
        pub = serve.WeightPublisher(router, chunk_bytes=16384)
        pub.publish(1, sds[1])
        assert router._retire_pending == {0}  # no sweep has run yet
        threads.append(_decode_thread(addr, tm, sds[0], box, "b", slots=2,
                                      weight_version=0))
        deadline = time.monotonic() + 60
        while not router.poll_admissions():
            assert time.monotonic() < deadline, "stale host never admitted"
            time.sleep(0.01)
        stale = router._ranks[1]
        router.poll()  # the sweep of v0 runs after the admission
        assert not router._retire_pending
        assert stale.versions == {0} and stale.live_version == 0
        assert router._ranks[0].versions == {1}
        assert pub.catch_up() == 1
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and (
                stale.versions != {1} or len(box["b"]._servers) != 1):
            router.poll()
            time.sleep(0.02)
        assert stale.versions == {1} and stale.live_version == 1
        assert set(box["b"]._servers) == {1}
    finally:
        _stop(router, threads, lsock, box)
