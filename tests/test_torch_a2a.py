"""The port's all-to-alls (tpunet_torch/collectives.py's all_to_all,
all_to_all_typed and iall_to_all) against the numpy oracle and against the
JAX package's Communicator on the same inputs, on the CPU.

Ranks are threads of this process, each with its own loopback
communicators of both packages (one libtpunet.so serves both, so every
result is bitwise the JAX package's on every wire). Worlds 2 and 3; the
typed form on the f32, bf16 and int8 wires: f32 blocks bitwise the block
transpose, and on a compressed wire each non-self block bitwise the codec
oracle (one codec_encode at the source, one codec_decode at the
destination), the self block exact. The byte forms move any dtype;
iall_to_all overlaps an iall_reduce. Refusals: a leading axis other than
the world, a 0-d buffer, a typed dtype outside the reductions'.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from conftest import free_port

import torch

from tpunet.collectives import Communicator as JaxCommunicator
from tpunet_torch import transport
from tpunet_torch.collectives import Communicator

N = 1031  # odd: the int8 codec's scale blocks restart per (src, dst) block


def _ranks(world, body):
    """body(rank) on `world` threads; {rank: result}, raising the first
    rank's exception."""
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
        assert r in box, f"rank {r} did not finish"
    return box


def _blocks(rank, world):
    rng = np.random.default_rng(1000 * world + rank)
    return (rng.standard_normal((world, N)) * (rank + 1)).astype(np.float32)


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("world", [2, 3])
def test_a2a_matches_oracle_and_jax(world, wire):
    ports = (free_port(), free_port())

    def body(rank):
        send = _blocks(rank, world)
        with Communicator(f"127.0.0.1:{ports[0]}", rank, world,
                          wire_dtype=wire) as ours, JaxCommunicator(
                f"127.0.0.1:{ports[1]}", rank, world,
                wire_dtype=wire) as theirs:
            out = {"typed": ours.all_to_all_typed(send),
                   "jax_typed": theirs.all_to_all_typed(send)}
            # Byte forms: any dtype, here f16 numpy and an int16 tensor.
            h = send.astype(np.float16)
            out["bytes"] = ours.all_to_all(h)
            out["jax_bytes"] = theirs.all_to_all(h)
            i16 = torch.from_numpy((send * 100).astype(np.int16))
            out["tensor"] = ours.all_to_all(i16)
            # iall_to_all in flight beside an iall_reduce.
            red = ours.iall_reduce(send[0].copy())
            pend = ours.iall_to_all(send)
            out["async"], out["reduce"] = pend.wait(), red.wait()
            assert pend.test()
        return send, out

    res = _ranks(world, body)
    sends = {r: res[r][0] for r in res}
    total = sum(sends[r][0].astype(np.float64) for r in res)
    for r, (_, out) in res.items():
        assert out["typed"].dtype == np.float32
        assert out["typed"].tobytes() == out["jax_typed"].tobytes()
        for j in range(world):
            blk = sends[j][r]
            want = blk
            if j != r and wire != "f32":
                want = transport.codec_decode(transport.codec_encode(
                    np.ascontiguousarray(blk), wire), wire, N)
            assert out["typed"][j].tobytes() == want.tobytes(), (r, j)
            assert out["async"][j].tobytes() == blk.tobytes()
            assert out["bytes"][j].tobytes() == blk.astype(
                np.float16).tobytes()
            assert torch.equal(out["tensor"][j], torch.from_numpy(
                (blk * 100).astype(np.int16)))
        assert out["bytes"].tobytes() == out["jax_bytes"].tobytes()
        assert isinstance(out["tensor"], torch.Tensor)
        # The overlapped all-reduce finished (lossy on a compressed wire).
        assert out["reduce"].shape == (N,)
        assert np.isfinite(out["reduce"]).all()
        if wire == "f32":
            np.testing.assert_allclose(out["reduce"], total, rtol=1e-5,
                                       atol=1e-5)


def test_bf16_tensor_typed_a2a():
    """A torch.bfloat16 tensor travels typed (dtype code 2) and comes back
    a bfloat16 tensor, each block exact."""
    port = free_port()
    x = {r: torch.arange(2 * 5, dtype=torch.float32).reshape(2, 5).add(
        10 * r).to(torch.bfloat16) for r in range(2)}

    def body(rank):
        with Communicator(f"127.0.0.1:{port}", rank, 2) as comm:
            return comm.all_to_all_typed(x[rank])

    res = _ranks(2, body)
    for r in range(2):
        assert res[r].dtype == torch.bfloat16
        for j in range(2):
            assert torch.equal(res[r][j], x[j][r])


def test_a2a_refusals():
    with Communicator(f"127.0.0.1:{free_port()}", 0, 1) as comm:
        for call in (comm.all_to_all, comm.all_to_all_typed,
                     comm.iall_to_all):
            with pytest.raises(ValueError, match="leading axis"):
                call(np.zeros((2, 3), np.float32))
            with pytest.raises(ValueError, match="leading axis"):
                call(np.float32(1.0))
        with pytest.raises(TypeError, match="unsupported dtype"):
            comm.all_to_all_typed(np.zeros((1, 3), np.float16))
        with pytest.raises(TypeError, match="unsupported dtype"):
            comm.all_to_all_typed(np.zeros((1, 3), np.complex64))
        with pytest.raises(ValueError, match="host buffers"):
            comm.all_to_all(torch.zeros(1, 3, device="meta"))
        # World 1: every form hands the block back; empty buffers pass.
        x = np.arange(6, dtype=np.int64).reshape(1, 6)
        assert comm.all_to_all(x).tobytes() == x.tobytes()
        assert comm.all_to_all_typed(x).tobytes() == x.tobytes()
        assert comm.iall_to_all(x).wait().tobytes() == x.tobytes()
        assert comm.all_to_all(np.zeros((1, 0), np.float32)).shape == (1, 0)
