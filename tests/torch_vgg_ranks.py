"""The 2-rank worker of ``test_torch_vgg.py``, in a module that imports no
JAX, so the spawned ranks start faster: on a tiny VGG with ``sgd``, the
flat and bucketed cross-host steps and the ZeRO-1 step give the same
losses and params bitwise, the ranks agree, and the in-place flat mean has
``dcn_pmean``'s bits (f32 and the bf16 cast)."""

from __future__ import annotations

import numpy as np
import torch

# The tiny plan of tests/test_models.py, on 16x16 images.
TINY = dict(cfg=(8, "M", 16, "M"), num_classes=10, hidden=32)
TINY_SIZE = 16


def rank_worker(rank, world, port, q):
    try:
        from tpunet_torch import distributed, interop
        from tpunet_torch.interop import dcn_all_gather, dcn_pmean
        from tpunet_torch.models import VGG
        from tpunet_torch.train import (create_train_state,
                                        create_zero_train_state,
                                        make_train_step,
                                        make_zero_train_step, sgd,
                                        synthetic_batch)
        from tpunet_torch.train.trainer import _flat_dcn_pmean

        torch.set_num_threads(1)
        distributed.initialize(f"127.0.0.1:{port}", rank, world)
        model = VGG(**TINY, compute_dtype=torch.float32,
                    classifier_dropout=0.0, image_size=TINY_SIZE,
                    device="meta")
        batches = [synthetic_batch(np.random.default_rng(100 + 10 * rank + i),
                                   4, TINY_SIZE, 10) for i in range(3)]
        tx = sgd(5e-2, momentum=0.9)
        steps = {
            "flat": make_train_step(model, cross_host=True),
            "bucketed": make_train_step(model, cross_host=True,
                                        bucket_bytes=4096),
            "zero": make_zero_train_step(model)}
        finals = {}
        for kind, step in steps.items():
            create = (create_zero_train_state if kind == "zero"
                      else create_train_state)
            state, _ = create(model, 0, None, tx, device="cpu")
            losses = []
            for i, (x, y) in enumerate(batches):
                state, loss = step(state, x, y, i)
                losses.append(float(loss))
            finals[kind] = (losses, torch.cat([
                p.detach().reshape(-1) for p in state.params.values()]))
        for kind in ("bucketed", "zero"):
            assert finals[kind][0] == finals["flat"][0], kind
            assert torch.equal(finals[kind][1], finals["flat"][1]), kind
        every = dcn_all_gather(finals["flat"][1])
        assert torch.equal(every[0], every[1])

        # The in-place flat mean has dcn_pmean's bits, f32 and bf16 cast,
        # and counts as one blocking all-reduce.
        g = torch.from_numpy(np.random.default_rng(rank).standard_normal(
            1000).astype(np.float32))
        grads = {"a": g[:600].view(20, 30), "b": g[600:]}
        want32 = dcn_pmean(g.clone())
        want16 = dcn_pmean(g.to(torch.bfloat16)).to(torch.float32)
        interop.dcn_reduce_stats_reset()
        got32 = _flat_dcn_pmean(dict(grads), None, world)
        got16 = _flat_dcn_pmean(dict(grads), "bf16", world)
        assert interop.dcn_reduce_stats()["calls"] == 2
        for got, want in ((got32, want32), (got16, want16)):
            flat = torch.cat([got["a"].reshape(-1), got["b"]])
            assert torch.equal(flat, want)
        distributed.finalize()
        q.put((rank, "OK"))
    except Exception as e:  # noqa: BLE001
        import traceback

        q.put((rank, f"FAIL: {type(e).__name__}: {e}\n"
                     f"{traceback.format_exc()[-800:]}"))
