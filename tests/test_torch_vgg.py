"""The port's VGG and its data-parallel training against the JAX package,
on the CPU.

- forward: logits of ``from_flax`` of a flax init (random, so
  non-symmetric, conv kernels) within 1e-5 of max|ref| in f32 and 2e-2 in
  bf16, on a tiny plan (8, M, 16, M at 16x16) and on the whole VGG16 plan
  at width_mult 0.125 on 32x32 images; a conv kernel carried over with a
  plain transpose (kh and kw swapped) must miss that bound;
- gradients, then 3 steps of ``make_train_step`` with ``sgd`` against the
  JAX trainer with ``optax.sgd`` (momentum 0.9, none, Nesterov, and
  momentum 0.9 with accum_steps=2): losses and params within 1e-5
  relative;
- the full VGG16's parameter shapes (meta) equal ``jax.eval_shape`` of the
  flax init after the converter's layout: 138,357,544 params;
- ``synthetic_batch`` bitwise JAX's, ``to_flax(from_flax(tree))`` bitwise
  the tree;
- dropout: one rng gives one loss, another rng another; kept entries
  scaled by 2 at rate 0.5, kept share near 0.5;
- 2 spawned ranks: the flat and bucketed steps bitwise equal to each
  other and across the ranks, the ZeRO-1 step with sgd bitwise the
  replicated one, the in-place flat mean bitwise ``dcn_pmean`` (f32 and
  the bf16 cast);
- an SGD state through ``CheckpointManager`` and ``fit`` (float NHWC
  batches through the CPU prefetcher).
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import pytest

from conftest import run_spawn_workers
from torch_vgg_ranks import TINY, TINY_SIZE, rank_worker

import jax
import jax.numpy as jnp
import optax
import torch

from tpunet.models import VGG as JaxVGG
from tpunet.models import vgg16 as jax_vgg16
from tpunet.train import create_train_state as jax_create_train_state
from tpunet.train import make_train_step as jax_make_train_step
from tpunet.train import synthetic_batch as jax_synthetic_batch
from tpunet_torch.models import VGG, from_flax, to_flax, vgg16
from tpunet_torch.models.convert import _torch_layout
from tpunet_torch.train import (CheckpointManager, create_train_state, fit,
                                make_train_step, sgd, synthetic_batch)
from tpunet_torch.train.trainer import _make_loss_fn, _value_and_grads

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                    torch.bfloat16)}


def _rel_err(a, b) -> float:
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-12))


def _jax_tiny(dt=jnp.float32, dropout=0.0):
    return JaxVGG(**TINY, compute_dtype=dt, classifier_dropout=dropout)


def _tiny(dt=torch.float32, dropout=0.0, device="meta"):
    return VGG(**TINY, compute_dtype=dt, classifier_dropout=dropout,
               image_size=TINY_SIZE, device=device)


@functools.lru_cache(maxsize=None)
def _flax_params(plan: str, seed: int = 0):
    """(numpy flax tree, images) of a flax init: the tiny plan at 16x16 or
    the whole VGG16 plan at width 0.125 on 2 32x32 images."""
    if plan == "tiny":
        jm, size, n = _jax_tiny(), TINY_SIZE, 4
    else:
        jm, size, n = jax_vgg16(num_classes=10, width_mult=0.125), 32, 2
    images, _ = jax_synthetic_batch(np.random.default_rng(seed), n, size, 10)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.asarray(images))["params"]
    return jax.tree.map(np.asarray, params), images


def _port(plan: str, dt):
    if plan == "tiny":
        return _tiny(dt, device="cpu")
    return vgg16(num_classes=10, width_mult=0.125, compute_dtype=dt,
                 image_size=32, device="cpu")


@pytest.mark.parametrize("plan", ["tiny", "vgg16_w0.125"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_matches_flax(plan, dt):
    jdt, tdt = DT[dt]
    tree, images = _flax_params(plan)
    jm = (_jax_tiny(jdt) if plan == "tiny"
          else jax_vgg16(num_classes=10, width_mult=0.125, compute_dtype=jdt))
    want = np.asarray(jax.jit(jm.apply)({"params": tree},
                                        jnp.asarray(images)))
    k = tree["conv0"]["kernel"]
    assert not np.allclose(k, k.swapaxes(0, 1))  # kh, kw not symmetric
    model = _port(plan, tdt)
    net = model.bind(from_flax(tree, model))
    got = net(torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = 1e-5 if dt == "f32" else 2e-2
    assert _rel_err(got.detach().numpy(), want) <= tol
    # The same weights with every conv kernel turned around by a plain
    # transpose (the right shape, kh and kw swapped) miss that bound.
    wrong = {n: (t.permute(0, 1, 3, 2) if t.dim() == 4 else t)
             for n, t in from_flax(tree, model).items()}
    bad = model.bind(wrong)(torch.from_numpy(images)).detach().numpy()
    assert _rel_err(bad, want) > 10 * tol


def test_full_vgg16_shapes_match_flax():
    shapes = jax.eval_shape(
        lambda r: jax_vgg16(num_classes=1000).init(
            r, jnp.zeros((1, 224, 224, 3)))["params"],
        jax.random.PRNGKey(0))
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        flax_path = "/".join(p.key for p in path)
        zeros = np.broadcast_to(np.zeros((), np.float32), leaf.shape)
        name = flax_path.replace("/", ".").replace("kernel", "weight")
        want[name] = _torch_layout(flax_path, zeros).shape
    model = vgg16(device="meta")
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == 138_357_544
    assert model.conv0.weight.is_contiguous(memory_format=torch.channels_last)


def test_synthetic_batch_and_roundtrip_are_bitwise():
    for seed, batch, size in ((0, 4, 16), (7, 3, 9)):
        a = synthetic_batch(np.random.default_rng(seed), batch, size, 10)
        b = jax_synthetic_batch(np.random.default_rng(seed), batch, size, 10)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    tree, _ = _flax_params("vgg16_w0.125")
    model = _port("vgg16_w0.125", torch.float32)
    back = to_flax(from_flax(tree, model))
    flat_want = jax.tree_util.tree_leaves_with_path(tree)
    flat_got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, w), (_, g) in zip(flat_want, flat_got):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))


def _jax_loss(jm, images, labels):
    def loss(p):
        logits = jm.apply({"params": p}, images, train=True,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()
    return jax.jit(jax.value_and_grad(loss))


def test_gradients_match_jax():
    tree, _ = _flax_params("tiny")
    images, labels = synthetic_batch(np.random.default_rng(1), 4, TINY_SIZE,
                                     10)
    jloss, jgrads = _jax_loss(_jax_tiny(), jnp.asarray(images),
                              jnp.asarray(labels))(tree)
    model = _tiny()
    state, net = create_train_state(
        model, 0, None, sgd(0.1), params=from_flax(tree, _tiny(device="cpu")),
        device="cpu")
    loss, grads = _value_and_grads(
        net, state.params, torch.from_numpy(images),
        torch.from_numpy(labels).long(), _make_loss_fn(), None)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                            jgrads))
    got = jax.tree_util.tree_leaves(to_flax(grads))
    assert len(got) == len(want) == 10
    for (path, w), g in zip(want, got):
        assert _rel_err(g, w) <= 1e-5, jax.tree_util.keystr(path)


SGD_CASES = {
    "momentum": (dict(momentum=0.9), {}),
    "plain": (dict(), {}),
    "nesterov": (dict(momentum=0.9, nesterov=True), {}),
    "momentum_accum2": (dict(momentum=0.9), dict(accum_steps=2)),
}


@pytest.mark.parametrize("case", list(SGD_CASES))
def test_sgd_steps_match_optax(case):
    opt, kw = SGD_CASES[case]
    tree, _ = _flax_params("tiny")
    batches = [synthetic_batch(np.random.default_rng(10 + i), 4, TINY_SIZE,
                               10) for i in range(3)]
    jm = _jax_tiny()
    jtx = optax.sgd(5e-2, **opt)
    jstate, _ = jax_create_train_state(jm, jax.random.PRNGKey(0),
                                       jnp.asarray(batches[0][0]), jtx)
    jstate = jstate._replace(params=jax.tree.map(jnp.asarray, tree),
                             opt_state=jtx.init(tree))
    jstep = jax_make_train_step(jm, jtx, donate=False, **kw)

    tx = sgd(5e-2, **opt)
    tstate, _ = create_train_state(_tiny(), 0, None, tx, device="cpu",
                                   params=from_flax(tree,
                                                    _tiny(device="cpu")))
    tstep = make_train_step(_tiny(), tx, **kw)
    for i, (x, y) in enumerate(batches):
        jstate, jloss = jstep(jstate, jnp.asarray(x), jnp.asarray(y),
                              jax.random.PRNGKey(i))
        tstate, tloss = tstep(tstate, x, y, i)
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert tstate.step == 3
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jstate.params))
    got = jax.tree_util.tree_leaves(to_flax(tstate.params))
    for (path, w), g in zip(want, got):
        assert _rel_err(g, w) <= 1e-5, jax.tree_util.keystr(path)


def test_dropout_follows_the_rng():
    from tpunet_torch.models.vgg import _dropout

    gen = torch.Generator().manual_seed(3)
    out = _dropout(torch.ones(256, 512, dtype=torch.bfloat16), 0.5, gen)
    kept = out != 0
    assert out.dtype == torch.bfloat16
    assert torch.all(out[kept] == 2.0)
    assert abs(float(kept.float().mean()) - 0.5) < 0.01

    model = _tiny(dropout=0.5)
    params = model.init_params(seed=0, device="cpu")
    net = model.bind(params)
    images, labels = synthetic_batch(np.random.default_rng(2), 8, TINY_SIZE,
                                     10)
    x, y = torch.from_numpy(images), torch.from_numpy(labels).long()
    loss_fn = _make_loss_fn()
    a, b, c = (float(loss_fn(net, x, y, r)) for r in (1, 1, 2))
    assert a == b and a != c
    assert torch.equal(net(x), net(x, rng=5))  # eval mode: no dropout
    with pytest.raises(ValueError, match="needs an rng"):
        net(x, train=True)
    # The train step seeds the dropout with its rng.
    state, _ = create_train_state(model, 0, None, sgd(0.1), device="cpu")
    step = make_train_step(model, donate=False)
    runs = [step(state, images, labels, r)[1] for r in (4, 4, 9)]
    assert float(runs[0]) == float(runs[1]) != float(runs[2])
    with pytest.raises(TypeError, match="features_only"):
        make_train_step(model, fused_xent_block=8)


# -- two spawned ranks ---------------------------------------------------------


def test_two_ranks_flat_bucketed_and_zero_are_bitwise_equal():
    # The ranks run a module that imports no JAX: they start twice as fast.
    run_spawn_workers(rank_worker, 2)


# -- checkpoints and fit -------------------------------------------------------


def _same(a, b) -> bool:
    if a.step != b.step or any(not torch.equal(a.params[k], b.params[k])
                               for k in a.params):
        return False
    sa, sb = a.opt_state.state_dict(), b.opt_state.state_dict()
    return sa["param_groups"] == sb["param_groups"] and all(
        torch.equal(v, sb["state"][i][k])
        for i, s in sa["state"].items() for k, v in s.items())


def test_sgd_state_checkpoint_and_fit(tmp_path):
    model = _tiny()
    tx = sgd(5e-2, momentum=0.9, nesterov=True)
    batches = [synthetic_batch(np.random.default_rng(30 + i), 4, TINY_SIZE,
                               10) for i in range(4)]
    step = make_train_step(model, donate=False)

    def fresh(seed=0):
        return create_train_state(model, seed, None, tx, device="cpu")[0]

    state = fresh()
    for i, (x, y) in enumerate(batches[:2]):
        state, _ = step(state, x, y, i)
    assert all("momentum_buffer" in s
               for s in state.opt_state.state_dict()["state"].values())
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(state.step, state)
    back = mgr.restore_latest(fresh(seed=1))
    assert _same(back, state)
    assert back.opt_state.defaults["nesterov"]
    a, _ = step(state, *batches[2], 2)
    b, _ = step(back, *batches[2], 2)
    assert _same(a, b)

    # fit carries float NHWC batches through the CPU prefetcher and resumes
    # from its checkpoint to the same state as a straight run.
    straight = fresh()
    for i, (x, y) in enumerate(batches):
        straight, _ = step(straight, x, y, i)
    ck = str(tmp_path / "fit")
    half = fit(fresh(), step, iter(batches[:2]), steps=2, checkpoint_dir=ck,
               prefetch=2, prefetch_device="cpu", rng=0)
    assert half.step == 2
    done = fit(fresh(), step, itertools.islice(iter(batches), 2, None),
               steps=4, checkpoint_dir=ck, prefetch=2, prefetch_device="cpu")
    assert done.step == 4
    for k in straight.params:
        assert torch.equal(done.params[k], straight.params[k]), k
