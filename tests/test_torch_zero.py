"""The port's ZeRO-1 step (optimizer state sharded over the DCN world) on
the CPU, against the JAX package and against the port's replicated step.

- world 1, in one process: 3 adamw steps of ``make_zero_train_step``
  against the JAX ``make_zero_train_step`` from the same flax init (losses
  and params within 1e-5 relative, the bound of the replicated step's
  test);
- 2 and 3 spawned ranks (3 pads the flat vector): the ZeRO step against
  the port's replicated cross-host step, bitwise at world 2 (the
  reduce-scatter's sum is the all-reduce's, /2 is exact, adamw is
  elementwise) and within ``tests/test_zero.py``'s bound at world 3; the
  ranks bitwise equal; the optimizer state 1/world of the replicated one;
- bf16 gradients (the cast path and the bf16 wire): ranks bitwise equal;
- checkpoints: a ZeRO state through ``CheckpointManager``, ``fit`` and
  ``save_pytree`` / ``restore_pytree`` round-trips bitwise and steps
  identically; ranks sharing a directory keep every shard; a restore into
  another world size is refused;
- without ``initialize()`` the ZeRO entry points raise.
"""

from __future__ import annotations

import itertools
from pathlib import Path

import numpy as np
import pytest

from conftest import free_port, run_spawn_workers

import jax
import jax.numpy as jnp
import optax
import torch

CFG = dict(vocab=64, d_model=64, n_layers=2, n_heads=4, d_ff=128)
SMALL = dict(vocab=37, d_model=16, n_layers=2, n_heads=2, d_ff=32)


def _rel_err(a, b) -> float:
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-12))


def _flat(state) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1)
                      for p in state.params.values()]).numpy()


def _opt_elems(opt) -> int:
    return sum(v.numel() for s in opt.state.values() for v in s.values()
               if isinstance(v, torch.Tensor))


def test_zero_step_matches_jax_world1():
    from tpunet import distributed as jax_distributed
    from tpunet.models import Transformer as JaxTransformer
    from tpunet.train import create_zero_train_state as jax_create
    from tpunet.train import make_zero_train_step as jax_make
    from tpunet_torch import distributed
    from tpunet_torch.models import Transformer, from_flax, to_flax
    from tpunet_torch.train import (adamw, create_zero_train_state,
                                    make_zero_train_step)

    rng = np.random.default_rng(0)
    toks = rng.integers(0, CFG["vocab"], (3, 4, 16)).astype(np.int32)
    labels = np.roll(toks, -1, axis=2)
    jax_distributed.initialize(f"127.0.0.1:{free_port()}", 0, 1)
    distributed.initialize(f"127.0.0.1:{free_port()}", 0, 1)
    try:
        jm = JaxTransformer(compute_dtype=jnp.float32, **CFG)
        jtx = optax.adamw(3e-4)
        jstate, _ = jax_create(jm, jax.random.PRNGKey(0),
                               jnp.asarray(toks[0]), jtx)
        jstep = jax_make(jm, jtx, donate=False)

        tm = Transformer(compute_dtype=torch.float32, attn_impl="flash",
                         device="meta", **CFG)
        sd = from_flax(jax.tree.map(np.asarray, jstate.params),
                       Transformer(compute_dtype=torch.float32, device="cpu",
                                   **CFG))
        tx = adamw(3e-4)
        tstate, _ = create_zero_train_state(tm, 0, torch.from_numpy(toks[0]),
                                            tx, params=sd)
        tstep = make_zero_train_step(tm, tx)
        for i in range(3):
            jstate, jloss = jstep(jstate, jnp.asarray(toks[i]),
                                  jnp.asarray(labels[i]),
                                  jax.random.PRNGKey(i))
            tstate, tloss = tstep(tstate, toks[i], labels[i], i)
            assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(
                float(jloss))
        assert tstate.step == 3
        want = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, jstate.params))
        got = jax.tree_util.tree_leaves(to_flax(tstate.params))
        assert len(want) == len(got)
        for (path, w), g in zip(want, got):
            assert _rel_err(g, w) <= 1e-5, jax.tree_util.keystr(path)
    finally:
        distributed.finalize()
        jax_distributed.finalize()


# -- spawned ranks -----------------------------------------------------------


def _setup(rank, world, seed=0):
    from tpunet_torch.models import Transformer
    from tpunet_torch.train import adamw

    torch.set_num_threads(1)
    model = Transformer(compute_dtype=torch.float32, attn_impl="flash",
                        device="meta", **SMALL)
    rng = np.random.default_rng(100 + rank)
    toks = rng.integers(0, SMALL["vocab"], (3, 2, 8))
    return model, adamw(3e-3), toks, np.roll(toks, -1, axis=2)


def _ranks_agree(x: np.ndarray, world: int) -> None:
    from tpunet_torch.interop import dcn_all_gather

    allx = dcn_all_gather(torch.from_numpy(x)).numpy()
    for r in range(1, world):
        np.testing.assert_array_equal(allx[0], allx[r])


def _parity_worker(rank, world, port, q):
    try:
        from tpunet_torch import distributed
        from tpunet_torch.train import (create_train_state,
                                        create_zero_train_state,
                                        make_train_step, make_zero_train_step)

        distributed.initialize(f"127.0.0.1:{port}", rank, world)
        model, tx, toks, labels = _setup(rank, world)
        full, _ = create_train_state(model, 0, torch.from_numpy(toks[0]), tx)
        zero, _ = create_zero_train_state(model, 0, torch.from_numpy(toks[0]),
                                          tx)
        step_full = make_train_step(model, tx, cross_host=True)
        step_zero = make_zero_train_step(model, tx)
        for i in range(3):
            full, loss_f = step_full(full, toks[i], labels[i], i)
            zero, loss_z = step_zero(zero, toks[i], labels[i], i)
            if world == 2:
                assert float(loss_f) == float(loss_z), (i, loss_f, loss_z)
            else:  # tests/test_zero.py's bound
                np.testing.assert_allclose(float(loss_z), float(loss_f),
                                           rtol=1e-6)
        pf, pz = _flat(full), _flat(zero)
        if world == 2:
            np.testing.assert_array_equal(pz, pf)
        else:
            np.testing.assert_allclose(pz, pf, rtol=2e-6, atol=2e-7)
        _ranks_agree(pz, world)
        # Optimizer state shrinks by ~world (mod the step counts and the
        # shard padding): tests/test_zero.py's bound.
        full_elems, zero_elems = (_opt_elems(s.opt_state)
                                  for s in (full, zero))
        assert zero_elems <= full_elems / world + world + 8, (
            zero_elems, full_elems, world)
        n = pz.size
        (shard,) = zero.opt_state.param_groups[0]["params"]
        assert shard.numel() == -(-n // world)
        assert (n % world != 0) == (world == 3)  # world 3 pads
        distributed.finalize()
        q.put((rank, "OK"))
    except Exception as e:  # noqa: BLE001
        import traceback

        q.put((rank, f"FAIL: {type(e).__name__}: {e}\n"
                     f"{traceback.format_exc()[-800:]}"))


@pytest.mark.parametrize("world", [2, 3])
def test_zero_matches_replicated_cross_host_step(world):
    run_spawn_workers(_parity_worker, world)


def _bf16_worker(rank, world, port, q, port_bf16):
    try:
        from tpunet_torch import distributed, telemetry
        from tpunet_torch.train import (create_zero_train_state,
                                        make_zero_train_step)

        # f32 wire: the trainer casts the gradient to bf16 itself.
        distributed.initialize(f"127.0.0.1:{port}", rank, world)
        model, tx, toks, labels = _setup(rank, world)
        state, _ = create_zero_train_state(model, 0, torch.from_numpy(toks[0]),
                                           tx)
        step = make_zero_train_step(model, tx, grad_compression="bf16")
        state, loss = step(state, toks[0], labels[0], 0)
        cast = _flat(state)
        assert np.isfinite(cast).all() and np.isfinite(float(loss))
        _ranks_agree(cast, world)
        distributed.finalize()
        # bf16 wire: f32 shipped, the ring quantizes the reduce-scatter's
        # hops; the all-gather stays full precision.
        distributed.initialize(f"127.0.0.1:{port_bf16}", rank, world,
                               wire_dtype="bf16")
        state, _ = create_zero_train_state(model, 0, torch.from_numpy(toks[0]),
                                           tx)
        step = make_zero_train_step(model, tx, grad_compression="bf16")
        telemetry.reset()
        state, loss = step(state, toks[0], labels[0], 0)
        ratio = next(iter(telemetry.metrics()[
            "tpunet_codec_wire_ratio"].values()))
        wire = _flat(state)
        assert np.isfinite(wire).all() and np.isfinite(float(loss))
        assert ratio == 0.5  # the reduce-scatter went through the codec
        # Bitwise-equal ranks also show the all-gather stayed f32: a bf16
        # gather would leave each rank's own shard unrounded and the
        # others' rounded.
        _ranks_agree(wire, world)
        assert not np.array_equal(wire, cast)  # a different rounding path
        distributed.finalize()
        q.put((rank, "OK"))
    except Exception as e:  # noqa: BLE001
        import traceback

        q.put((rank, f"FAIL: {type(e).__name__}: {e}\n"
                     f"{traceback.format_exc()[-800:]}"))


def test_zero_bf16_gradients_2proc():
    run_spawn_workers(_bf16_worker, 2, extra_args=(free_port(),))


# -- checkpoints ---------------------------------------------------------------


def _same(a, b) -> None:
    assert a.step == b.step
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    sa, sb = a.opt_state.state_dict(), b.opt_state.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, s in sa["state"].items():
        for k, v in s.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


def test_zero_state_checkpoint_roundtrip(tmp_path):
    from tpunet_torch import distributed
    from tpunet_torch.train import (CheckpointManager,
                                    create_zero_train_state, fit,
                                    make_zero_train_step, restore_pytree,
                                    save_pytree)

    distributed.initialize(f"127.0.0.1:{free_port()}", 0, 1)
    try:
        model, tx, toks, labels = _setup(0, 1)
        state, _ = create_zero_train_state(model, 0, torch.from_numpy(toks[0]),
                                           tx)
        step = make_zero_train_step(model, tx, donate=False)
        state, _ = step(state, toks[0], labels[0], 1)

        def template(seed):
            return create_zero_train_state(model, seed,
                                           torch.from_numpy(toks[0]), tx)[0]

        mgr = CheckpointManager(tmp_path / "ck")
        mgr.save(1, state)
        assert sorted(f.name for f in (tmp_path / "ck").iterdir()) == [
            "1.pt", "1.zero-0-of-1.pt"]
        back = mgr.restore(1, template(2))
        _same(state, back)
        save_pytree(tmp_path / "zstate", state)
        tree = restore_pytree(tmp_path / "zstate", template(3))
        _same(state, tree)
        for restored in (back, tree):
            s1, l1 = step(state, toks[1], labels[1], 3)
            s2, l2 = step(restored, toks[1], labels[1], 3)
            assert float(l1) == float(l2)
            _same(s1, s2)
        # A replicated target refuses a ZeRO checkpoint.
        from tpunet_torch.train import create_train_state

        full, _ = create_train_state(model, 0, torch.from_numpy(toks[0]), tx)
        with pytest.raises(ValueError, match="ZeRO"):
            mgr.restore(1, full)

        # fit() resumes a ZeRO run exactly.
        def batches():
            return iter([(toks[i], labels[i]) for i in range(3)])

        straight = fit(template(0), step, batches(), steps=3)
        ck = str(tmp_path / "fit")
        fit(template(0), step, batches(), steps=2, checkpoint_dir=ck,
            checkpoint_every=1)
        resumed = fit(template(0), step, batches(), steps=3,
                      checkpoint_dir=ck, skip_batches_on_resume=True)
        _same(straight, resumed)
    finally:
        distributed.finalize()


def test_pytree_roundtrip_of_nested_containers(tmp_path):
    from tpunet_torch.train import restore_pytree, save_pytree

    tree = {"a": [torch.arange(5, dtype=torch.float32) / 3,
                  (np.arange(6, dtype=np.int16).reshape(2, 3), 7, 2.5)],
            "b": {"c": torch.ones(2, 2, dtype=torch.bfloat16), "d": None,
                  "e": np.float32(1.25)}}
    target = {"a": [torch.zeros(5), (np.zeros((2, 3), np.int16), 0, 0.0)],
              "b": {"c": torch.zeros(2, 2, dtype=torch.bfloat16), "d": None,
                    "e": np.float32(0)}}
    save_pytree(tmp_path / "t", tree)
    got = restore_pytree(tmp_path / "t", target)
    assert torch.equal(got["a"][0], tree["a"][0])
    assert isinstance(got["a"][1], tuple)
    np.testing.assert_array_equal(got["a"][1][0], tree["a"][1][0])
    assert got["a"][1][0].dtype == np.int16
    assert got["a"][1][1:] == (7, 2.5)
    assert torch.equal(got["b"]["c"], tree["b"]["c"])
    assert got["b"]["d"] is None and got["b"]["e"] == np.float32(1.25)
    with pytest.raises(KeyError, match="differ"):
        restore_pytree(tmp_path / "t", {"a": target["a"]})


def _shared_dir_worker(rank, world, port, q, ckdir, solo_ports):
    try:
        from tpunet_torch import distributed
        from tpunet_torch.interop import dcn_barrier
        from tpunet_torch.train import (CheckpointManager,
                                        create_zero_train_state, fit,
                                        make_zero_train_step, restore_pytree,
                                        save_pytree)

        distributed.initialize(f"127.0.0.1:{port}", rank, world)
        model, tx, toks, labels = _setup(rank, world)

        def template(seed):
            return create_zero_train_state(model, seed,
                                           torch.from_numpy(toks[0]), tx)[0]

        step = make_zero_train_step(model, tx)
        batches = iter([(toks[i], labels[i]) for i in range(2)])
        state = fit(template(0), step, batches, steps=2, checkpoint_dir=ckdir,
                    checkpoint_every=1)
        mgr = CheckpointManager(ckdir)
        back = mgr.restore(2, template(5))
        _same(state, back)
        save_pytree(f"{ckdir}/tree-{rank}", state)
        dcn_barrier()  # every rank's files are written
        names = sorted(f.name for f in Path(ckdir).iterdir()
                       if f.name.startswith("2."))
        assert names == ["2.pt", "2.zero-0-of-2.pt", "2.zero-1-of-2.pt"], \
            names
        other = f"{ckdir}/tree-{1 - rank}"
        with pytest.raises(ValueError, match="rank"):
            restore_pytree(other, template(5))
        distributed.finalize()
        # The same checkpoint restored into a world of one: refused.
        distributed.initialize(f"127.0.0.1:{solo_ports[rank]}", 0, 1)
        solo = template(5)
        with pytest.raises(ValueError, match="world"):
            CheckpointManager(ckdir).restore(2, solo)
        with pytest.raises(ValueError, match="world"):
            restore_pytree(f"{ckdir}/tree-{rank}", solo)
        distributed.finalize()
        q.put((rank, "OK"))
    except Exception as e:  # noqa: BLE001
        import traceback

        q.put((rank, f"FAIL: {type(e).__name__}: {e}\n"
                     f"{traceback.format_exc()[-800:]}"))


def test_zero_checkpoint_shared_dir_keeps_every_shard_2proc(tmp_path):
    run_spawn_workers(_shared_dir_worker, 2,
                      extra_args=(str(tmp_path / "ck"),
                                  (free_port(), free_port())))


def test_zero_requires_distributed():
    from tpunet_torch import distributed
    from tpunet_torch.models import Transformer
    from tpunet_torch.train import (adamw, create_zero_train_state,
                                    make_zero_train_step)

    assert not distributed.is_initialized()
    model = Transformer(vocab=8, d_model=8, n_layers=1, n_heads=1, d_ff=8,
                        device="meta")
    with pytest.raises(RuntimeError, match="initialize"):
        make_zero_train_step(model, adamw(0.1))
    with pytest.raises(RuntimeError, match="initialize"):
        create_zero_train_state(model, 0, torch.zeros(1, 4, dtype=torch.long),
                                adamw(0.1), device="cpu")
    with pytest.raises(ValueError, match="grad_compression"):
        make_zero_train_step(model, adamw(0.1), grad_compression="int8")


def test_zero_state_layout_shares_the_params_memory():
    """The optimizer's one parameter is this rank's slice of the flat
    buffer the params are views of: no copy of the shard exists."""
    from tpunet_torch import distributed
    from tpunet_torch.train import create_zero_train_state

    distributed.initialize(f"127.0.0.1:{free_port()}", 0, 1)
    try:
        model, tx, toks, _ = _setup(0, 1)
        state, net = create_zero_train_state(model, 0,
                                             torch.from_numpy(toks[0]), tx)
        (shard,) = state.opt_state.param_groups[0]["params"]
        n = sum(p.numel() for p in state.params.values())
        assert shard.numel() == n and shard.dtype == torch.float32
        off = 0
        for name, p in state.params.items():
            assert isinstance(p, torch.nn.Parameter)
            assert p.data_ptr() == shard.data_ptr() + 4 * off, name
            off += p.numel()
        for name, p in net.named_parameters():
            assert p is state.params[name]
        assert state.opt_state.param_groups[0]["zero"] == {
            "rank": 0, "world": 1, "n": n}
        assert list(itertools.chain(*(g["params"] for g in
                                      state.opt_state.param_groups))) == [
            shard]
    finally:
        distributed.finalize()
