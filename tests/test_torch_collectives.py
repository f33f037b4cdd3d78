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


def _a2a_blocks(rank, world):
    return (10 * rank + np.arange(world, dtype=np.float32)[:, None]
            + np.zeros((world, 3), np.float32))


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
        # Into caller-given buffers (interop passes pinned ones).
        rs_out = torch.empty(10, 1000 // (world * 10))
        assert comm.reduce_scatter(torch.from_numpy(
            f32.reshape(world * 10, -1)), out=rs_out) is rs_out
        out["rs_into"] = rs_out.numpy()
        ag_out = torch.empty(world, 6, 5, dtype=torch.int64)
        assert comm.all_gather(torch.from_numpy(i64), out=ag_out) is ag_out
        out["ag_into"] = ag_out.numpy()
        with pytest.raises(ValueError, match="out must be"):
            comm.all_gather(i64, out=np.empty((world, 6, 5), np.int32))
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
        out["hpsum"] = interop.hierarchical_psum(torch.from_numpy(f32)).numpy()
        out["stats"] = interop.dcn_reduce_stats()
        t = [interop.dcn_all_reduce_start(torch.from_numpy(f32 * k))
             for k in (1, 2)]
        out["max_in_flight"] = interop.dcn_async_stats()["max_in_flight"]
        out["ticket"] = [interop.dcn_all_reduce_finish(x).numpy() for x in t]
        # The all-to-alls (ported with the MoE slice): rank r sends block
        # j = 10 * r + j's rows to rank j.
        a2a_in = _a2a_blocks(rank, world)
        out["a2a"] = comm.all_to_all(a2a_in)
        out["a2a_typed"] = comm.all_to_all_typed(a2a_in)
        out["dcn_a2a"] = interop.dcn_all_to_all(
            torch.from_numpy(a2a_in)).numpy()
        # The ring shift (ported with the sequence-parallel slice): rank r
        # receives rank r - 1's message, any dtype.
        out["nx"] = comm.neighbor_exchange(i64)
        out["dcn_nx"] = interop.dcn_neighbor_exchange(
            torch.from_numpy(f32).to(torch.bfloat16)).float().numpy()
        interop.dcn_barrier()
        # Messages of unequal sizes fail on both ends: the larger one
        # overflows rank 0's buffer, the smaller one is short at rank 1.
        with pytest.raises(RuntimeError,
                           match="size mismatch|exceeds posted recv"):
            comm.neighbor_exchange(np.zeros(2 + rank, np.float32))
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
        np.testing.assert_array_equal(got["rs_into"], got["rs"])
        np.testing.assert_array_equal(got["ag_into"], got["ag"])
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
        np.testing.assert_array_equal(got["hpsum"], got["psum"])
        # dcn_reduce_stats: the all-reduces (psum, its gradient, pmean,
        # hierarchical_psum) apart from the reduce-scatter and all-gather.
        stats = got["stats"]
        assert stats["calls"] == 4 and stats["bytes"] == 4 * 4000
        assert stats["reduce_scatter"]["calls"] == 1
        assert stats["reduce_scatter"]["bytes"] == 4000
        assert stats["all_gather"]["calls"] == 1
        assert stats["all_gather"]["bytes"] == 30 * 8
        for s in (stats, stats["reduce_scatter"], stats["all_gather"]):
            assert s["seconds"] >= s["collective_seconds"] > 0
        assert got["max_in_flight"] == 2
        # Block j of rank r's result came from rank j: 10 * j + r.
        want_a2a = np.stack([_a2a_blocks(j, world)[r] for j in range(world)])
        for key in ("a2a", "a2a_typed", "dcn_a2a"):
            np.testing.assert_array_equal(got[key], want_a2a, err_msg=key)
        prev = data[(r - 1) % world]
        np.testing.assert_array_equal(got["nx"], prev[1])
        np.testing.assert_array_equal(got["dcn_nx"], torch.from_numpy(
            prev[0]).to(torch.bfloat16).float().numpy())
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


BYTE_DTYPES = ("uint32", "uint16", "float16", "bool", "int8")


@pytest.fixture(scope="module")
def world1_comms():
    """A world-1 Communicator of each package, on ports of their own."""
    from tpunet.collectives import Communicator as JaxCommunicator
    from tpunet_torch.collectives import Communicator

    ours = Communicator(f"127.0.0.1:{free_port()}", 0, 1)
    theirs = JaxCommunicator(f"127.0.0.1:{free_port()}", 0, 1)
    yield ours, theirs
    ours.close()
    theirs.close()


@pytest.mark.parametrize("dtype", BYTE_DTYPES)
def test_all_gather_and_broadcast_move_bytes_of_any_dtype(world1_comms,
                                                          dtype):
    """all_gather and broadcast move raw bytes, as the JAX package's do:
    any dtype, the same bytes, dtype and shape as JAX's on the same numpy
    input; a CPU tensor comes back as a tensor of its own dtype."""
    ours, theirs = world1_comms
    rng = np.random.default_rng(len(dtype))
    raw = rng.integers(0, 256, 3 * 5 * np.dtype(dtype).itemsize, np.uint8)
    arr = raw.view(dtype).reshape(3, 5)
    if dtype == "bool":
        arr = raw.reshape(3, 5) % 2 == 1
    for mine, jax_out in ((ours.all_gather(arr), theirs.all_gather(arr)),
                          (ours.broadcast(arr), theirs.broadcast(arr))):
        assert isinstance(mine, np.ndarray)
        assert mine.dtype == jax_out.dtype == arr.dtype
        assert mine.shape == jax_out.shape
        assert mine.tobytes() == jax_out.tobytes()
    assert ours.all_gather(arr).shape == (1, 3, 5)
    t = torch.from_numpy(arr.copy())
    for got in (ours.all_gather(t)[0], ours.broadcast(t)):
        assert isinstance(got, torch.Tensor) and got.dtype == t.dtype
        assert got.numpy().tobytes() == arr.tobytes()
    # Into a caller's buffer, or in place (the weight receiver's chunks).
    buf = np.empty_like(arr)
    assert ours.broadcast(arr, out=buf) is buf
    assert buf.tobytes() == arr.tobytes()
    inplace = arr.copy()
    assert ours.broadcast(inplace, out=inplace) is inplace
    with pytest.raises(ValueError, match="out must be"):
        ours.broadcast(arr, out=np.empty(arr.shape, np.float64))


def test_reductions_still_refuse_dtypes_they_cannot_reduce(world1_comms):
    ours, _ = world1_comms
    for op in (lambda a: ours.all_reduce(a),
               lambda a: ours.reduce_scatter(a),
               lambda a: ours.iall_reduce(a)):
        with pytest.raises(TypeError, match="uint32"):
            op(np.arange(4, dtype=np.uint32))
    with pytest.raises(ValueError, match="host buffers"):
        ours.all_gather(torch.empty(3, device="meta"))
    with pytest.raises(ValueError, match="host buffers"):
        ours.broadcast(torch.empty(3, device="meta"))


def test_psum_requires_initialize():
    from tpunet_torch import distributed, interop

    assert not distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        interop.dcn_psum(torch.ones(3))
    # Like JAX's: no silent "skip the DCN tier when uninitialized".
    with pytest.raises(RuntimeError, match="initialize"):
        interop.hierarchical_psum(torch.ones(3))


@pytest.mark.parametrize("name,slice_", [
    ("dcn_all_to_all", None), ("dcn_neighbor_exchange", "sequence-parallel"),
    ("hierarchical_psum", "later training slice")])
def test_later_slice_collectives_raise(name, slice_):
    from tpunet_torch import interop

    # Every one of them is ported now: the all-to-all (MoE slice), the
    # neighbor exchange (sequence-parallel slice) and hierarchical_psum's
    # in-pod tier over a mesh axis (the mesh slice, ROADMAP A.6b;
    # tests/test_torch_tp.py holds it over a mesh of 4 ranks).
    if slice_ is None:
        _dcn_all_to_all_parity()
        return
    if name == "dcn_neighbor_exchange":
        _dcn_neighbor_exchange_parity()
        return
    from tpunet_torch.parallel import make_named_mesh

    # A mesh of one rank needs no world: its psum over "ici" and over the
    # rest of the mesh is the identity; the axis resolves against the
    # active mesh only.
    x = torch.tensor([1.0, -2.5])
    with make_named_mesh({"ici": 1, "dp": 1}):
        assert torch.equal(interop.hierarchical_psum(x, axis_name="ici"), x)
    with pytest.raises(RuntimeError, match="no active mesh"):
        interop.hierarchical_psum(x, axis_name="ici")


def _dcn_neighbor_exchange_parity():
    """dcn_neighbor_exchange at world 1 (the message comes back from this
    process itself), any dtype, against the communicator's own call and
    the JAX package's Communicator on the same numpy input."""
    from tpunet.collectives import Communicator as JaxCommunicator
    from tpunet_torch import distributed, interop

    comm = distributed.initialize(f"127.0.0.1:{free_port()}", 0, 1)
    try:
        x = torch.arange(12, dtype=torch.int16).reshape(3, 4)
        got = interop.dcn_neighbor_exchange(x)
        assert got.dtype == torch.int16 and torch.equal(got, x)
        assert got.data_ptr() != x.data_ptr()
        np.testing.assert_array_equal(comm.neighbor_exchange(x.numpy()),
                                      got.numpy())
        with JaxCommunicator(f"127.0.0.1:{free_port()}", 0, 1) as theirs:
            assert theirs.neighbor_exchange(x.numpy()).tobytes() == (
                got.numpy().tobytes())
        assert interop.dcn_reduce_stats()["neighbor_exchange"]["bytes"] >= 24
    finally:
        distributed.finalize()


def _dcn_all_to_all_parity():
    """dcn_all_to_all, ported with the MoE slice, at world 1 (the block
    comes back) and against the communicator's own call; a leading axis
    other than the world is refused."""
    from tpunet_torch import distributed, interop

    comm = distributed.initialize(f"127.0.0.1:{free_port()}", 0, 1)
    try:
        x = torch.arange(12, dtype=torch.int16).reshape(1, 3, 4)
        got = interop.dcn_all_to_all(x)
        assert got.dtype == torch.int16 and torch.equal(got, x)
        np.testing.assert_array_equal(comm.all_to_all(x.numpy()),
                                      got.numpy())
        with pytest.raises(ValueError, match="leading axis"):
            interop.dcn_all_to_all(torch.ones(2, 3))
    finally:
        distributed.finalize()


# dcn_* call -> the call on a world-1 tensor `x` (leading axis 1).
UNDIFFERENTIABLE = {
    "dcn_all_gather": lambda i, x: i.dcn_all_gather(x),
    "dcn_reduce_scatter": lambda i, x: i.dcn_reduce_scatter(x),
    "dcn_broadcast": lambda i, x: i.dcn_broadcast(x),
    "dcn_all_to_all": lambda i, x: i.dcn_all_to_all(x),
    "dcn_neighbor_exchange": lambda i, x: i.dcn_neighbor_exchange(x),
}


@pytest.mark.parametrize("name", sorted(UNDIFFERENTIABLE))
def test_backward_through_a_collective_without_jax_vjp_raises(name):
    """The JAX package's dcn_* collectives other than dcn_all_reduce are
    io_callback or FFI calls with no VJP, so jax.grad through them raises.
    The port's refuse a backward too, where a silent cut would drop the
    exchanged term: loss = (2x).sum() + collective(x).sum() at world 1
    must not back-propagate a gradient of 2. The forward under grad mode
    still runs, as model.apply does in JAX, and dcn_all_reduce keeps its
    gradient."""
    from tpunet_torch import distributed, interop

    distributed.initialize(f"127.0.0.1:{free_port()}", 0, 1)
    try:
        x = torch.arange(6, dtype=torch.float32).reshape(1, 2, 3)
        x.requires_grad_()
        y = UNDIFFERENTIABLE[name](interop, x)
        assert torch.equal(y.detach().reshape(x.shape), x.detach())
        loss = (2 * x).sum() + y.sum()
        with pytest.raises(RuntimeError, match="JAX package"):
            loss.backward()
        with torch.no_grad():
            assert UNDIFFERENTIABLE[name](interop, x).grad_fn is None
        (g,) = torch.autograd.grad(interop.dcn_psum(x).sum(), x)
        assert torch.equal(g, torch.ones_like(x))
    finally:
        distributed.finalize()


def _broadcast_soak(q, tries, nbytes):
    """tries x (two thread ranks, fresh loopback comms, one broadcast of
    `nbytes`) under the armed QoS wire window on two data streams, in a
    process of its own: the window is read once, at a process's first
    engine. Reports the tries that failed."""
    import os
    import threading

    os.environ.update({"TPUNET_QOS_INFLIGHT_BYTES": "wire=256K",
                       "TPUNET_QOS_WEIGHTS": "latency=8,bulk=1",
                       "TPUNET_NSTREAMS": "2",
                       "TPUNET_PROGRESS_TIMEOUT_MS": "5000"})

    def body():
        from tpunet_torch.collectives import Communicator

        wire = np.random.default_rng(0).integers(0, 256, nbytes, np.uint8)
        failed = []
        for t in range(tries):
            port, box = free_port(), {}

            def rank(r):
                try:
                    with Communicator(f"127.0.0.1:{port}", r, 2,
                                      wire_dtype="f32", algo="tree",
                                      traffic_class="bulk") as comm:
                        buf = wire.copy() if r == 0 else np.zeros_like(wire)
                        comm.broadcast(buf, root=0, out=buf)
                        box[r] = buf.tobytes() == wire.tobytes()
                except Exception as e:  # noqa: BLE001 — reported below
                    box[r] = repr(e)

            threads = [threading.Thread(target=rank, args=(r,))
                       for r in range(2)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=30)
            if box.get(0) is not True or box.get(1) is not True:
                failed.append((t, box))
        return failed

    _report(q, 0, body)


def test_broadcast_under_the_qos_wire_window_does_not_stall():
    """C.12's guard: an 8 MiB Communicator.broadcast (8 native calls of one
    1 MiB piece each) between two loopback ranks under an armed 256K wire
    window on two data streams, 20 times; the progress watchdog (5 s)
    bounds a stalled try. Every try must deliver the root's bytes."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_broadcast_soak, args=(q, 20, 8 << 20))
    p.start()
    try:
        _, status, failed = q.get(timeout=240)
    finally:
        p.join(timeout=30)
        if p.is_alive():
            p.kill()
    assert status == "OK", failed
    assert failed == [], failed


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
    with pytest.raises(ValueError, match="grad_compression"):
        make_zero_train_step(model, tx, grad_compression="fp8")
    with pytest.raises(RuntimeError, match="initialize"):
        create_zero_train_state(model, 0, torch.zeros(1, 4, dtype=torch.long),
                                tx, device="cpu")
