"""The port's serving tier against the JAX package's, on the CPU.

PrefillEngine outputs, KV-block wire bytes and hello bytes are held to the
JAX package's on the same weights and inputs; the port's own tier (router +
prefill on this thread, a decode rank on a thread, real loopback libtpunet
comms) is held bitwise to the port's single-host BatchServer on the f32
wire, and to the codec's exact int8 wire ratio by the native counters.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from conftest import free_port  # noqa: F401  (pins JAX_PLATFORMS=cpu first)

import jax
import jax.numpy as jnp
import torch

from tpunet import serve as jax_serve
from tpunet.models import Transformer as JaxTransformer
from tpunet.serve import protocol as jax_proto
from tpunet_torch import serve, telemetry
from tpunet_torch.models import BatchServer, Transformer, from_flax
from tpunet_torch.serve import protocol as proto

CFG = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=64)


@pytest.fixture(scope="module")
def pair():
    jm = JaxTransformer(compute_dtype=jnp.float32, attn_impl="flash", **CFG)
    tm = Transformer(compute_dtype=torch.float32, attn_impl="flash",
                     device="cpu", **CFG)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    return jm, tm, params, from_flax(jax.tree.map(np.asarray, params), tm)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, n).astype(np.int32) for n in lens]


def test_prefill_engine_matches_jax(pair):
    jm, tm, params, sd = pair
    jpe = jax_serve.PrefillEngine(jm, params, max_len=32)
    pe = serve.PrefillEngine(tm, sd, max_len=32, device="cpu")
    for prompt in _prompts(0, (5, 13)):
        jrows, jlast = jpe.prefill(prompt)
        rows, last = pe.prefill(prompt)
        assert pe.kv_leaf_shapes(len(prompt)) == jpe.kv_leaf_shapes(
            len(prompt))
        assert len(rows) == len(jrows) == 4
        for a, b in zip(rows, jrows):
            assert a.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(last, jlast, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
def test_kv_codec_bytes_equal_jax(codec):
    rng = np.random.default_rng(1)
    rows = [rng.standard_normal((7, 2, 8)).astype(np.float32)
            for _ in range(4)]
    rows[2][3] *= 50.0  # a block with a wide dynamic range
    wire = serve.encode_kv_block(rows, codec)
    np.testing.assert_array_equal(wire, jax_serve.encode_kv_block(rows, codec))
    shapes = [r.shape for r in rows]
    assert serve.kv_wire_bytes(codec, shapes) == jax_serve.kv_wire_bytes(
        codec, shapes)
    for a, b in zip(serve.decode_kv_block(wire, codec, shapes),
                    jax_serve.decode_kv_block(wire, codec, shapes)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fields", [
    (proto.ROLE_FRONTEND, "int8", 0, 1024, 32000, 0x1234, "latency", 0),
    (proto.ROLE_DECODE, "f32", 8, 512, 64, 0xFFFFFFFFFFFF, "bulk", 3),
    (proto.ROLE_DECODE, "bf16", 2, 40, 64, 7, "control", (1 << 24) - 1),
])
def test_hello_bytes_equal_jax(fields):
    role, codec, slots, max_len, vocab, sig, cls, ver = fields
    mine = proto.Hello(role, codec, slots, max_len, vocab, sig, cls, ver)
    theirs = jax_proto.Hello(role, codec, slots, max_len, vocab, sig, cls,
                             ver)
    assert mine.pack() == theirs.pack()
    back = proto.Hello.unpack(theirs.pack())
    assert (back.role, back.kv_codec, back.slots, back.max_len, back.vocab,
            back.model_sig, back.traffic_class, back.weight_version) == (
        role, codec, slots, max_len, vocab, sig, cls, ver)


def test_model_signature_tracks_config(pair):
    _, tm, _, _ = pair
    same = Transformer(compute_dtype=torch.float32, device="meta", **CFG)
    other = Transformer(compute_dtype=torch.float32, device="meta",
                        **{**CFG, "d_ff": 128})
    assert serve.model_signature(tm) == serve.model_signature(same)
    assert serve.model_signature(tm) != serve.model_signature(other)


def _run_tier(tm, sd, prompts, lens, *, kv_codec, decode_slots=2,
              max_len=40, queue_limit=None, before_run=None):
    """Frontend on this thread, one decode rank on a worker thread, over
    real loopback transport comms; returns (results by submit order,
    router, worker)."""
    lsock = serve.Router.listen("127.0.0.1:0")
    addr = "127.0.0.1:%d" % lsock.getsockname()[1]
    box = {}

    def decode_main():
        worker = serve.connect_decode(addr, tm, sd, slots=decode_slots,
                                      max_len=max_len, kv_codec=kv_codec,
                                      device="cpu")
        box["worker"] = worker
        try:
            worker.serve()
        finally:
            worker.close()

    th = threading.Thread(target=decode_main, daemon=True)
    th.start()
    pe = serve.PrefillEngine(tm, sd, max_len=max_len, device="cpu")
    router = serve.Router(pe, kv_codec=kv_codec, queue_limit=queue_limit)
    try:
        router.accept_ranks(lsock, 1)
        lsock.close()
        ids = [router.submit(p, n) for p, n in zip(prompts, lens)]
        if before_run is not None:
            before_run(router)
        results = router.run(timeout=240)
    finally:
        router.shutdown()
        th.join(timeout=60)
        router.close()
    return [results[i] for i in ids], router, box.get("worker")


def test_tier_f32_wire_is_bitwise_single_host(pair):
    _, tm, _, sd = pair
    prompts = _prompts(2, (5, 9, 13, 7))
    lens = [8, 6, 8, 5]
    got, router, worker = _run_tier(tm, sd, prompts, lens, kv_codec="f32")
    srv = BatchServer(tm, sd, slots=2, max_len=40, device="cpu")
    sids = [srv.submit(p, n) for p, n in zip(prompts, lens)]
    single = srv.run()
    for tokens, sid, n in zip(got, sids, lens):
        assert len(tokens) == n
        np.testing.assert_array_equal(tokens, single[sid])
    assert router.stats["completed"] == 4 and router.stats["rank_failures"] == 0
    assert worker.srv.stats["kv_adopts"] == 4
    assert worker.srv.stats["prefills"] == 0  # decode never re-prefills


def test_tier_int8_wire_ratio_by_counters(pair):
    """8-token prompts: 8 x 2 layers x 2 leaves x 2 kv heads x 8 = 512 f32
    elements per block, a multiple of 256, so the int8 wire is exactly
    (512 + 2*4) / 2048 of the f32 bytes."""
    _, tm, _, sd = pair
    telemetry.reset()  # the registry is shared by both bindings
    got, _, _ = _run_tier(tm, sd, _prompts(3, (8, 8, 8)), [6, 6, 6],
                          kv_codec="int8")
    assert all(len(t) == 6 for t in got)
    m = telemetry.metrics()
    ratio = next(iter(m["tpunet_codec_wire_ratio"].values()))
    assert abs(ratio - 0.25390625) < 1e-6  # exposition prints 6 digits
    int8_tx = sum(v for k, v in m["tpunet_codec_bytes_total"].items()
                  if telemetry.labels(k).get("codec") == "int8"
                  and telemetry.labels(k).get("dir") == "tx")
    assert int8_tx == 3 * (512 + 8)
    assert sum(b for _, b in telemetry.histogram_buckets(
        "tpunet_req_ttft_us", m)[-1:]) == 3


def test_router_backpressure_is_typed(pair):
    _, tm, _, sd = pair
    p0 = _prompts(4, (6,))[0]

    def second_submit(router):
        with pytest.raises(serve.RouterBusyError):
            router.submit(p0, 4)  # slot busy, zero queue headroom
        assert router.stats["rejected"] == 1

    got, _, _ = _run_tier(tm, sd, [p0], [4], kv_codec="f32",
                          decode_slots=1, queue_limit=0,
                          before_run=second_submit)
    srv = BatchServer(tm, sd, slots=1, max_len=40, device="cpu")
    sid = srv.submit(p0, 4)
    np.testing.assert_array_equal(got[0], srv.run()[sid])


def test_batch_server_pipeline_and_refill_match(pair):
    """More requests than slots, pipelined windows and multi-step windows
    all give the same greedy tokens as one request at a time."""
    _, tm, _, sd = pair
    prompts = _prompts(5, (4, 11, 6, 9, 3))
    lens = [5, 3, 7, 4, 6]
    outs = []
    for kw in ({}, {"steps_per_call": 3}):
        for pipeline in (1, 2):
            srv = BatchServer(tm, sd, slots=2, max_len=24, device="cpu", **kw)
            ids = [srv.submit(p, n) for p, n in zip(prompts, lens)]
            res = srv.run(pipeline=pipeline)
            outs.append([res[i] for i in ids])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(a, b)
    for p, n, toks in zip(prompts, lens, outs[0]):
        srv = BatchServer(tm, sd, slots=1, max_len=24, device="cpu")
        sid = srv.submit(p, n)
        np.testing.assert_array_equal(srv.run()[sid], toks)


def test_batch_server_eos_cuts_and_frees_slot(pair):
    """A request stops at its first eos (kept), its slot refills, and the
    other requests' tokens are unchanged."""
    _, tm, _, sd = pair
    prompts = _prompts(6, (5, 8, 7))
    srv = BatchServer(tm, sd, slots=2, max_len=32, device="cpu")
    ids = [srv.submit(p, 10) for p in prompts]
    free_run = srv.run()
    eos = int(free_run[ids[0]][3])
    srv = BatchServer(tm, sd, slots=2, max_len=32, eos_id=eos, device="cpu")
    ids = [srv.submit(p, 10) for p in prompts]
    cut = srv.run()
    for i in ids:
        full = free_run[i]
        hits = np.nonzero(full == eos)[0]
        want = full[: hits[0] + 1] if hits.size else full
        np.testing.assert_array_equal(cut[i], want)
    assert len(cut[ids[0]]) <= 4


@pytest.mark.parametrize("retain_kv", [True, False])
def test_decode_rank_death_replay_contained(pair, retain_kv):
    """A decode rank dies with a shipped request unreported; the router
    replays it on the surviving rank (from the retained KV block, or by
    re-prefilling) and every stream completes equal to single-host."""
    _, tm, _, sd = pair
    prompts = _prompts(7, (7, 7, 7, 7))
    lsock = serve.Router.listen("127.0.0.1:0")
    addr = "127.0.0.1:%d" % lsock.getsockname()[1]

    def decode_main(max_blocks):
        worker = serve.connect_decode(addr, tm, sd, slots=1, max_len=40,
                                      kv_codec="f32", device="cpu")
        try:
            worker.serve(max_blocks=max_blocks)  # 1: dies holding a block
        finally:
            worker.close()

    flaky = threading.Thread(target=decode_main, args=(1,), daemon=True)
    flaky.start()
    pe = serve.PrefillEngine(tm, sd, max_len=40, device="cpu")
    router = serve.Router(pe, kv_codec="f32", retain_kv=retain_kv)
    router.accept_ranks(lsock, 1)
    healthy = threading.Thread(target=decode_main, args=(None,), daemon=True)
    healthy.start()
    router.accept_ranks(lsock, 1)
    lsock.close()
    try:
        ids = [router.submit(p, 6) for p in prompts]
        results = router.run(timeout=240)
    finally:
        router.shutdown()
        flaky.join(timeout=60)
        healthy.join(timeout=60)
        router.close()
    assert not flaky.is_alive() and not healthy.is_alive()
    assert sorted(results) == sorted(ids)  # nothing lost
    for p, i in zip(prompts, ids):
        srv = BatchServer(tm, sd, slots=1, max_len=40, device="cpu")
        sid = srv.submit(p, 6)
        np.testing.assert_array_equal(results[i], srv.run()[sid])
    assert router.stats["rank_failures"] == 1
    if retain_kv:
        assert router.stats["replays_kv"] >= 1
        assert router.stats["replays_prefill"] == 0
    else:
        assert router.stats["replays_prefill"] >= 1


def _readmission_run(serve_mod, model, params, prompts, lens, **kw):
    """The only decode rank serves one block and dies with a request in
    flight; a recovered host reconnects through the hello handshake on the
    router's re-admission port. Returns (tokens by submit order, router
    stats, readmit events counted during the run)."""
    lsock = serve_mod.Router.listen("127.0.0.1:0")
    addr = "127.0.0.1:%d" % lsock.getsockname()[1]
    flaky_done = threading.Event()

    def flaky_decode():
        worker = serve_mod.connect_decode(addr, model, params, slots=1,
                                          max_len=40, kv_codec="f32", **kw)
        worker.serve(max_blocks=1)  # ingest one block, report nothing
        worker.close()
        flaky_done.set()

    def recovered_decode():
        flaky_done.wait(timeout=120)
        worker = serve_mod.connect_decode(addr, model, params, slots=1,
                                          max_len=40, kv_codec="f32", **kw)
        try:
            worker.serve()
        finally:
            worker.close()

    def readmits():
        m = telemetry.metrics().get("tpunet_churn_events_total", {})
        return sum(v for k, v in m.items()
                   if telemetry.labels(k).get("kind") == "readmit")

    before = readmits()
    th_flaky = threading.Thread(target=flaky_decode, daemon=True)
    th_flaky.start()
    prefill = serve_mod.PrefillEngine(model, params, max_len=40, **kw)
    router = serve_mod.Router(prefill, kv_codec="f32", retain_kv=True)
    router.accept_ranks(lsock, 1)
    router.enable_readmission(lsock)
    th_rec = threading.Thread(target=recovered_decode, daemon=True)
    th_rec.start()
    try:
        ids = [router.submit(p, n) for p, n in zip(prompts, lens)]
        results = router.run(timeout=240)
    finally:
        router.shutdown()
        th_flaky.join(timeout=60)
        th_rec.join(timeout=60)
        router.close()
        lsock.close()
    return [results[i] for i in ids], dict(router.stats), readmits() - before


def test_router_readmission_matches_the_jax_router(pair, monkeypatch):
    """Total rank loss with re-admission armed: run() keeps the stranded
    and queued requests until the recovered host is re-admitted (probed at
    TPUNET_READMIT_PROBE_MS), then they complete from the retained KV. The
    tokens equal the JAX router's on the same (converted) params, and both
    routers count one failure, one re-admission and one readmit event."""
    jm, tm, params, sd = pair
    monkeypatch.setenv("TPUNET_READMIT_PROBE_MS", "20")
    prompts = _prompts(9, (7, 5, 9))
    lens = [6, 6, 6]
    ours, stats, events = _readmission_run(serve, tm, sd, prompts, lens,
                                           device="cpu")
    theirs, jstats, jevents = _readmission_run(jax_serve, jm, params,
                                               prompts, lens)
    for a, b, n in zip(ours, theirs, lens):
        assert len(a) == n
        np.testing.assert_array_equal(a, np.asarray(b))
    for st, ev in ((stats, events), (jstats, jevents)):
        assert st["rank_failures"] == 1 and st["readmissions"] == 1
        assert st["readmit_rejected"] == 0 and st["replays_kv"] >= 1
        assert ev == 1


def test_router_readmission_signature_drift_typed(pair):
    """A host rejoining with another model configuration fails the
    re-handshake typed on both sides (poll_admissions raises
    TierMismatchError; run() would count and contain it) and is not
    admitted; a correct host afterwards is."""
    _, tm, _, sd = pair
    import time

    lsock = serve.Router.listen("127.0.0.1:0")
    addr = "127.0.0.1:%d" % lsock.getsockname()[1]
    pe = serve.PrefillEngine(tm, sd, max_len=40, device="cpu")
    router = serve.Router(pe, kv_codec="f32")
    assert router.poll_admissions() == 0  # not armed: nothing to accept
    router.enable_readmission(lsock)
    drift_err: list = []

    def drifted_decode():
        other = Transformer(compute_dtype=torch.float32, device="cpu",
                            **{**CFG, "d_ff": 128})
        from tpunet_torch.models import init_params
        try:
            serve.connect_decode(addr, other, init_params(other, seed=1,
                                                          device="cpu"),
                                 slots=1, max_len=40, kv_codec="f32",
                                 device="cpu")
        except proto.TierMismatchError as e:
            drift_err.append(e)

    th = threading.Thread(target=drifted_decode, daemon=True)
    th.start()
    deadline = time.monotonic() + 60
    try:
        with pytest.raises(proto.TierMismatchError, match="signature"):
            while time.monotonic() < deadline:
                router.poll_admissions()
                time.sleep(0.01)
        th.join(timeout=30)
        assert drift_err, "the decode side was not told about the drift"
        assert router.stats["readmit_rejected"] == 1
        assert router.stats["readmissions"] == 0 and not router._ranks

        def correct_decode():
            worker = serve.connect_decode(addr, tm, sd, slots=1, max_len=40,
                                          kv_codec="f32", device="cpu")
            worker.serve(idle_timeout=0.5)
            worker.close()

        th2 = threading.Thread(target=correct_decode, daemon=True)
        th2.start()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not router.stats["readmissions"]:
            router.poll_admissions()
            time.sleep(0.01)
        th2.join(timeout=60)
        assert router.stats["readmissions"] == 1
        assert len(router._ranks) == 1 and router._ranks[0].alive
    finally:
        router.close()
        lsock.close()
