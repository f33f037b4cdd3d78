"""The port's MoE workload (tpunet_torch/workloads/moe.py: zipf_weights,
route_tokens, MoeDispatcher) against the JAX package's, on the CPU:
popularities and routed ids bitwise equal for one generator seed (and for
TPUNET_MOE_SKEW), pack's overflow accounting, and dispatch/combine round
trips at worlds 1 and 2 (ranks as threads, each with its own loopback
communicator) bitwise equal to the JAX dispatcher's on the same inputs.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from conftest import free_port

from tpunet.collectives import Communicator as JaxCommunicator
from tpunet.workloads import moe as jax_moe
from tpunet_torch.collectives import Communicator
from tpunet_torch.workloads import MoeDispatcher, route_tokens, zipf_weights


@pytest.mark.parametrize("n,skew", [(1, 0.0), (4, 1.0), (7, 2.5)])
def test_zipf_weights_match_jax(n, skew):
    got = zipf_weights(n, skew)
    assert got.tobytes() == jax_moe.zipf_weights(n, skew).tobytes()
    assert abs(got.sum() - 1) < 1e-12 and (np.diff(got) <= 0).all()
    with pytest.raises(ValueError):
        zipf_weights(0, 1.0)
    with pytest.raises(ValueError):
        zipf_weights(3, -1.0)


def test_route_tokens_match_jax(monkeypatch):
    for seed, skew in ((0, 1.0), (5, 0.0), (9, 3.0)):
        got = route_tokens(500, 4, skew, np.random.default_rng(seed))
        want = jax_moe.route_tokens(500, 4, skew, np.random.default_rng(seed))
        assert got.dtype == np.int64 and np.array_equal(got, want)
    # skew=None reads TPUNET_MOE_SKEW, a bad value falls back to 1.0.
    for env in ("2.0", "bogus"):
        monkeypatch.setenv("TPUNET_MOE_SKEW", env)
        got = route_tokens(300, 8, None, np.random.default_rng(1))
        want = jax_moe.route_tokens(300, 8, None, np.random.default_rng(1))
        assert np.array_equal(got, want)
    assert np.array_equal(route_tokens(50, 3), jax_moe.route_tokens(50, 3))


def test_pack_overflow_counts_drops():
    with Communicator(f"127.0.0.1:{free_port()}", 0, 1) as comm:
        with pytest.raises(ValueError):
            MoeDispatcher(comm, d_model=0, capacity=1)
        disp = MoeDispatcher(comm, d_model=3, capacity=2)
        toks = np.arange(15, dtype=np.float32).reshape(5, 3)
        buf, counts = disp.pack(toks, np.zeros(5, np.int64))
        assert buf.shape == (1, 2, 3) and counts.tolist() == [2]
        np.testing.assert_array_equal(buf[0], toks[:2])
        assert disp.tokens_dropped == 3 and disp.tokens_routed == 5
        assert disp.drop_fraction == 0.6
        with pytest.raises(ValueError, match="expert ids"):
            disp.pack(toks, np.full(5, 1, np.int64))
        with pytest.raises(ValueError):
            disp.pack(toks[:, :2], np.zeros(5, np.int64))
        with pytest.raises(RuntimeError, match="before dispatch"):
            MoeDispatcher(comm, 3, 2).combine(np.zeros((1, 2, 3), np.float32))


def _ranks(world, body):
    box = {}

    def run(rank):
        try:
            box[rank] = body(rank)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box[rank] = e

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for r in range(world):
        if isinstance(box.get(r), BaseException):
            raise box[r]
    return box


@pytest.mark.parametrize("world", [1, 2])
def test_dispatch_combine_round_trip_matches_jax(world):
    """Tokens routed with a skew, dispatched, doubled by a stand-in
    expert and combined: kept rows come back exactly doubled, dropped rows
    zero, the drop count pack's; every buffer bitwise the JAX
    dispatcher's."""
    ports = (free_port(), free_port())
    d, cap, t = 8, 5, 16

    def body(rank):
        rng = np.random.default_rng(rank)
        toks = rng.standard_normal((t, d)).astype(np.float32)
        experts = route_tokens(t, world, 1.0, rng)
        with Communicator(f"127.0.0.1:{ports[0]}", rank, world) as ours, \
                JaxCommunicator(f"127.0.0.1:{ports[1]}", rank,
                                world) as theirs:
            got, want = {}, {}
            for box, comm, mod in ((got, ours, None), (want, theirs,
                                                       jax_moe)):
                disp = (MoeDispatcher if mod is None else mod.MoeDispatcher)(
                    comm, d_model=d, capacity=cap)
                recv, counts = disp.dispatch(toks, experts)
                box.update(recv=recv, counts=counts,
                           out=disp.combine(recv * 2.0),
                           dropped=disp.tokens_dropped,
                           kept=disp._kept.copy())
        return toks, got, want

    res = _ranks(world, body)
    for r, (toks, got, want) in res.items():
        for k in ("recv", "counts", "out", "kept"):
            assert np.asarray(got[k]).tobytes() == np.asarray(
                want[k]).tobytes(), (r, k)
        kept = got["kept"]
        assert got["dropped"] == want["dropped"] == int((~kept).sum())
        assert got["out"][kept].tobytes() == (toks[kept] * 2).tobytes()
        assert not got["out"][~kept].any()
    assert sum(res[r][1]["dropped"] for r in res) > 0
