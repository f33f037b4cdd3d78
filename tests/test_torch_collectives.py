"""The port's collectives, DCN interop and cross-host trainer on 2 spawned
CPU ranks over loopback libtpunet comms.

Collectives are held against numpy (bf16 travels as torch.bfloat16
tensors: numpy has no bfloat16 without ml_dtypes). The cross-host train
step (the DCN gradient mean) must equal, bitwise, a single process that
computes each rank's half-batch gradients separately and applies
(g0 + g1) / 2: at W=2 the ring's sum is one commutative f32 add and /2 is
exact. The bucketed path must equal the flat path bitwise with more than
one bucket in flight.
"""

from __future__ import annotations

import multiprocessing as mp
import traceback

import numpy as np
import pytest
import torch

from conftest import free_port

CFG = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=64, compute_dtype=torch.float32, attn_impl="flash")
STEPS = 3


def _spawn(target, world, *args, timeout=240):
    """Run target(rank, world, q, *args) in `world` spawned processes;
    returns {rank: payload}, raising on any rank's failure."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, world, q) + args)
             for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in range(world):
            rank, status, payload = q.get(timeout=timeout)
            assert status == "OK", f"rank {rank}: {payload}"
            out[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return out


def _report(q, rank, fn):
    try:
        q.put((rank, "OK", fn()))
    except Exception:  # noqa: BLE001 — reported to the parent
        q.put((rank, "FAIL", traceback.format_exc()))


# -- collectives ---------------------------------------------------------


def _rank_data(rank):
    rng = np.random.default_rng(100 + rank)
    return (rng.standard_normal(1000).astype(np.float32),
            rng.integers(-50, 50, (6, 5)).astype(np.int64),
            rng.standard_normal(301).astype(np.float32))


def _collectives_worker(rank, world, q, port):
    def body():
        from tpunet_torch import distributed, interop

        torch.set_num_threads(1)
        comm = distributed.initialize(f"127.0.0.1:{port}", rank, world)
        f32, i64, b16 = _rank_data(rank)
        out = {
            "sum": comm.all_reduce(f32),
            "max_i64": comm.all_reduce(i64, op="max"),
            "bf16": comm.all_reduce(torch.from_numpy(b16).to(torch.bfloat16)
                                    ).float().numpy(),
            "rs": comm.reduce_scatter(f32.reshape(world * 10, -1)),
            "ag": comm.all_gather(i64),
            "bcast": comm.broadcast(f32 * (rank + 1), root=1),
        }
        inplace = torch.from_numpy(f32.copy())
        assert comm.all_reduce(inplace, inplace=True) is inplace
        out["inplace"] = inplace.numpy()
        tickets = [comm.iall_reduce(f32 * k) for k in range(1, 4)]
        out["async"] = [t.wait() for t in reversed(tickets)][::-1]
        comm.barrier()
        # interop on CPU tensors, incl. the gradient of a sum all-reduce
        x = torch.from_numpy(f32).requires_grad_()
        y = interop.dcn_psum(x)
        (g,) = torch.autograd.grad((y * (rank + 1)).sum(), x)
        out["psum"] = y.detach().numpy()
        out["psum_grad"] = g.numpy()
        out["pmean"] = interop.dcn_pmean(torch.from_numpy(f32)).numpy()
        out["dcn_ag"] = interop.dcn_all_gather(torch.from_numpy(i64)).numpy()
        out["dcn_rs"] = interop.dcn_reduce_scatter(
            torch.from_numpy(f32.reshape(world, -1))).numpy()
        out["dcn_bcast"] = interop.dcn_broadcast(
            torch.from_numpy(f32), root=0).numpy()
        t = [interop.dcn_all_reduce_start(torch.from_numpy(f32 * k))
             for k in (1, 2)]
        out["max_in_flight"] = interop.dcn_async_stats()["max_in_flight"]
        out["ticket"] = [interop.dcn_all_reduce_finish(x).numpy() for x in t]
        with pytest.raises(NotImplementedError, match="MoE"):
            comm.all_to_all(np.zeros((world, 2), np.float32))
        with pytest.raises(NotImplementedError, match="sequence-parallel"):
            comm.neighbor_exchange(np.zeros(2, np.float32))
        interop.dcn_barrier()
        distributed.finalize()
        assert not distributed.is_initialized()
        return out

    _report(q, rank, body)


def test_collectives_match_numpy_2proc():
    world = 2
    res = _spawn(_collectives_worker, world, free_port())
    data = [_rank_data(r) for r in range(world)]
    f32_sum = data[0][0] + data[1][0]
    b16 = [torch.from_numpy(d[2]).to(torch.bfloat16).float() for d in data]
    want_b16 = (b16[0] + b16[1]).to(torch.bfloat16).float().numpy()
    for r in range(world):
        got = res[r]
        np.testing.assert_array_equal(got["sum"], f32_sum)
        np.testing.assert_array_equal(got["inplace"], f32_sum)
        np.testing.assert_array_equal(got["max_i64"],
                                      np.maximum(data[0][1], data[1][1]))
        np.testing.assert_array_equal(got["bf16"], want_b16)
        np.testing.assert_array_equal(
            got["rs"], f32_sum.reshape(world * 10, -1)[r * 10:(r + 1) * 10])
        np.testing.assert_array_equal(got["ag"],
                                      np.stack([data[0][1], data[1][1]]))
        np.testing.assert_array_equal(got["bcast"], data[1][0] * 2)
        for k, a in enumerate(got["async"], 1):
            np.testing.assert_array_equal(a, data[0][0] * k + data[1][0] * k)
        np.testing.assert_array_equal(got["psum"], f32_sum)
        # d/dx of sum_r (r+1) * psum(x) is psum of the cotangent: 1 + 2.
        np.testing.assert_array_equal(got["psum_grad"], np.full(1000, 3.0))
        np.testing.assert_array_equal(got["pmean"], f32_sum / 2)
        np.testing.assert_array_equal(got["dcn_ag"],
                                      np.stack([data[0][1], data[1][1]]))
        np.testing.assert_array_equal(got["dcn_rs"],
                                      f32_sum.reshape(world, -1)[r:r + 1])
        np.testing.assert_array_equal(got["dcn_bcast"], data[0][0])
        assert got["max_in_flight"] == 2
        np.testing.assert_array_equal(got["ticket"][0], f32_sum)
        np.testing.assert_array_equal(got["ticket"][1],
                                      data[0][0] * 2 + data[1][0] * 2)


def test_unsupported_dtype_and_host_only():
    from tpunet_torch.collectives import _Buf, _dtype_code

    assert _dtype_code(torch.bfloat16) == 2
    assert _dtype_code(np.float32) == 0
    with pytest.raises(TypeError, match="bfloat16"):
        _dtype_code(np.float16)
    meta = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="host buffers"):
        _Buf(meta)


def test_psum_requires_initialize():
    from tpunet_torch import distributed, interop

    assert not distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        interop.dcn_psum(torch.ones(3))


@pytest.mark.parametrize("name,slice_", [
    ("dcn_all_to_all", "MoE"), ("dcn_neighbor_exchange", "sequence-parallel"),
    ("hierarchical_psum", "later training slice")])
def test_later_slice_collectives_raise(name, slice_):
    from tpunet_torch import interop

    with pytest.raises(NotImplementedError, match=slice_):
        getattr(interop, name)(torch.ones(2))


# -- the cross-host train step ---------------------------------------------


def _batches(rank):
    rng = np.random.default_rng(7 + rank)
    toks = rng.integers(0, CFG["vocab"], (STEPS, 2, 12)).astype(np.int32)
    return [(t, np.roll(t, -1, axis=1)) for t in toks]


def _init():
    from tpunet_torch.models import Transformer
    from tpunet_torch.train import adamw, create_train_state

    torch.set_num_threads(1)
    model = Transformer(device="meta", **CFG)
    tx = adamw(1e-3)
    state, _ = create_train_state(model, 0, torch.zeros(1, 4, dtype=torch.long),
                                  tx)
    return model, tx, state


def _flat(state):
    return torch.cat([p.detach().reshape(-1) for p in state.params.values()]
                     ).numpy()


def _train_worker(rank, world, q, port, port_bf16):
    def body():
        from tpunet_torch import distributed, interop, telemetry
        from tpunet_torch.train import make_train_step

        distributed.initialize(f"127.0.0.1:{port}", rank, world)
        out = {}
        for mode, kw in (("flat", {}), ("bucketed", {"bucket_bytes": 4096})):
            model, tx, state = _init()
            step = make_train_step(model, tx, cross_host=True, **kw)
            interop.dcn_async_stats_reset()
            losses = []
            for x, y in _batches(rank):
                state, loss = step(state, x, y, 0)
                losses.append(float(loss))
            out[mode] = _flat(state)
            out[mode + "_losses"] = losses
            out[mode + "_in_flight"] = interop.dcn_async_stats()[
                "max_in_flight"]
        distributed.finalize()
        # bf16 on the wire: the trainer ships f32 and the ring halves it.
        distributed.initialize(f"127.0.0.1:{port_bf16}", rank, world,
                               wire_dtype="bf16")
        model, tx, state = _init()
        step = make_train_step(model, tx, cross_host=True,
                               grad_compression="bf16")
        telemetry.reset()
        x, y = _batches(rank)[0]
        state, _ = step(state, x, y, 0)
        m = telemetry.metrics()
        out["wire_ratio"] = next(iter(m["tpunet_codec_wire_ratio"].values()))
        out["bf16"] = _flat(state)
        distributed.finalize()
        return out

    _report(q, rank, body)


def test_cross_host_step_equals_single_process_half_batch_mean_2proc():
    from tpunet_torch.train.trainer import _make_loss_fn, _value_and_grads

    res = _spawn(_train_worker, 2, free_port(), free_port())
    threads = torch.get_num_threads()
    try:
        model, _, state = _init()
        loss_fn = _make_loss_fn()
        streams = [_batches(r) for r in range(2)]
        for i in range(STEPS):
            net = model.bind(state.params, trainable=True)
            halves = []
            for r in range(2):
                x, y = (torch.from_numpy(a).long() for a in streams[r][i])
                halves.append(_value_and_grads(net, state.params, x, y,
                                               loss_fn, None)[1])
            for n, p in state.params.items():
                p.grad = (halves[0][n] + halves[1][n]) / 2
            state.opt_state.step()
        want = _flat(state)
    finally:
        torch.set_num_threads(threads)
    for r in range(2):
        np.testing.assert_array_equal(res[r]["flat"], want)
        np.testing.assert_array_equal(res[r]["bucketed"], res[r]["flat"])
        assert res[r]["bucketed_in_flight"] > 1
        assert res[r]["flat_in_flight"] == 0
        assert all(np.isfinite(res[r]["flat_losses"]))
        assert res[r]["wire_ratio"] == 0.5
    np.testing.assert_array_equal(res[0]["bf16"], res[1]["bf16"])


def test_trainer_option_errors():
    from tpunet_torch.train import (create_zero_train_state, make_train_step,
                                    make_zero_train_step)

    model, tx, _ = _init()
    with pytest.raises(ValueError, match="grad_compression"):
        make_train_step(model, tx, grad_compression="fp8")
    with pytest.raises(ValueError, match="bucket_bytes"):
        make_train_step(model, tx, bucket_bytes=1024)
    with pytest.raises(RuntimeError, match="initialize"):
        make_train_step(model, tx, cross_host=True)
    for fn in (create_zero_train_state, make_zero_train_step):
        with pytest.raises(NotImplementedError, match="ZeRO"):
            fn(model, tx)
