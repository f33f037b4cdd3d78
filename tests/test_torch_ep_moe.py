"""The port's MoE on a mesh against the JAX package, where the layer runs
inside one jit over the mesh and sees the global batch: capacity, slots
and the aux loss over every rank's tokens (ROADMAP C.14), the experts
split over an ``ep`` axis (tests/test_transformer.py's
test_ep_sharded_moe_forward_matches), and a train step with
``accum_steps`` and the fused cross-entropy over {dp: 2, mdl: 2} with the
experts over dp (the multichip dry run's ep = dp).

Every multi-rank case runs in ONE spawn of 4 torch-only ranks
(tests/torch_mesh_ranks.py) on each rank's blocks of the flax init
(``from_flax``, then the port's partition rules); JAX runs the whole
model on the global batch. JAX's {dp: 2, ep: 4} is cut to {dp: 2, ep: 2}.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

from conftest import free_port  # noqa: F401  (pins JAX_PLATFORMS=cpu first)

import jax
import jax.numpy as jnp
import optax
import torch
from torch_mesh_ranks import spawn

from tpunet.models import Transformer as JaxTransformer
from tpunet.models import transformer_partition_rules as jax_tp_rules
from tpunet.parallel import batch_sharding, replicated
from tpunet.parallel import make_named_mesh as jax_mesh
from tpunet.parallel import shard_params as jax_shard_params
from tpunet.train import TrainState as JaxTrainState
from tpunet.train import create_train_state as jax_create_train_state
from tpunet.train import make_train_step as jax_make_train_step
from tpunet_torch.models import Transformer, from_flax

FWD_TOL, STEP_TOL = 1e-4, 1e-5
BASE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64)
# C.14: top-2 of 4 experts at capacity factor 0.5 drops many choices, and
# which ones depends on whether the capacity and the slots count one
# rank's row or the global batch's four.
C14 = dict(BASE, n_experts=4, moe_every=1, moe_top_k=2, capacity_factor=0.5)
EP_CASES = [(1, 1.25), (2, 2.0)]   # (moe_top_k, capacity_factor)
# layout -> (mesh axes, tp_axis, ep_axis, the forward's collectives: the
# routing statistics' psum over the data axis, then the experts' own)
EP_LAYOUTS = {
    "dp2-ep2": ((("dp", 2), ("ep", 2)), None, "ep", ["dp:psum", "ep:psum"]),
    "ep=dp-mdl2": ((("dp", 2), ("mdl", 2)), "mdl", "dp",
                   ["dp:all_gather", "dp:psum", "dp:psum_scatter",
                    "mdl:all_gather", "mdl:psum"])}
STEP_CFG = dict(BASE, n_kv_heads=2, n_experts=4, moe_every=2, moe_top_k=2,
                capacity_factor=1.25)
STEP_LR, ACCUM, XENT_BLOCK = 0.1, 2, 16


def _ep_cfg(top_k, cf):
    return dict(BASE, n_experts=4, moe_every=1, moe_top_k=top_k,
                capacity_factor=cf)


@functools.lru_cache(maxsize=None)
def _flax(cfg_items: tuple, b: int, s: int, seed: int = 0):
    """(flax model, flax params, port params, tokens) of a tiny model."""
    cfg = dict(cfg_items)
    toks = np.random.default_rng(seed).integers(0, 64, (b, s)).astype(
        np.int32)
    model = JaxTransformer(compute_dtype=jnp.float32, **cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), toks)["params"]
    tm = Transformer(compute_dtype=torch.float32, device="cpu", **cfg)
    sd = {n: t.numpy() for n, t in from_flax(
        jax.tree.map(np.asarray, params), tm, device="cpu").items()}
    return model, params, sd, toks


def _apply(cfg: dict, toks) -> np.ndarray:
    model, params, _, _ = _flax(tuple(cfg.items()), 4, 16)
    return np.asarray(jax.jit(lambda p, t: model.apply({"params": p}, t))(
        params, jnp.asarray(toks)))


@functools.lru_cache(maxsize=None)
def _jax_step():
    """JAX's jitted accum_steps=2, fused-xent sgd step on {dp: 2, mdl: 2},
    the experts over dp: (loss, flax params)."""
    model, params, _, x = _flax(tuple(STEP_CFG.items()), 6, 8, seed=5)
    y = np.roll(x, -1, axis=1)
    mesh = jax_mesh({"dp": 2, "mdl": 2})
    tx = optax.sgd(STEP_LR)
    state, _ = jax_create_train_state(model, jax.random.PRNGKey(0),
                                      jnp.asarray(x), tx)
    placed = jax.device_put(params, jax_shard_params(
        params, mesh, jax_tp_rules(tp_axis="mdl", ep_axis="dp")))
    opt = jax.tree.map(lambda a: jax.device_put(a, replicated(mesh)),
                       tx.init(params))
    state = JaxTrainState(placed, opt, state.step)
    step = jax_make_train_step(model, tx, donate=False, accum_steps=ACCUM,
                               fused_xent_block=XENT_BLOCK)
    xs, ys = (jax.device_put(jnp.asarray(a), batch_sharding(mesh))
              for a in (x, y))
    with mesh:
        state, loss = step(state, xs, ys, jax.random.PRNGKey(2))
    return float(loss), jax.tree.map(np.asarray, state.params)


@functools.lru_cache(maxsize=None)
def _ranks() -> dict:
    cases = {}
    _, _, sd, toks = _flax(tuple(C14.items()), 4, 16)
    cases["c14"] = ("model", dict(axes=(("dp", 4),), impl="reference",
                                  cfg=C14, params=sd, tokens=toks))
    for top_k, cf in EP_CASES:
        cfg = _ep_cfg(top_k, cf)
        _, _, sd, toks = _flax(tuple(cfg.items()), 4, 16)
        for name, (axes, tp, ep, _) in EP_LAYOUTS.items():
            cases[f"ep-{name}-{top_k}"] = ("model", dict(
                axes=axes, impl="reference", cfg=cfg, params=sd,
                tokens=toks[:2], tp_axis=tp, ep_axis=ep))
    _, _, sd, x = _flax(tuple(STEP_CFG.items()), 6, 8, seed=5)
    cases["step"] = ("train_step", dict(
        axes=(("dp", 2), ("mdl", 2)), family="transformer", cfg=STEP_CFG,
        params=sd, inputs=x.astype(np.int64),
        labels=np.roll(x, -1, axis=1).astype(np.int64),
        tx=("sgd", STEP_LR, None), ep_axis="dp", accum_steps=ACCUM,
        fused_xent_block=XENT_BLOCK))
    return spawn(4, cases)


def test_mesh_moe_routes_the_global_batch():
    """C.14: on a dp-only mesh of 4 (one row a rank) the capacity, the
    choice-major slots and the aux loss come from the global batch, as in
    JAX's jitted model; routing each rank's row alone drops other choices
    (the JAX model applied row by row differs), which the parent tree did."""
    _, _, _, toks = _flax(tuple(C14.items()), 4, 16)
    want = _apply(C14, toks)
    alone = np.concatenate([_apply(C14, toks[i:i + 1]) for i in range(4)])
    assert np.max(np.abs(alone - want)) > 100 * FWD_TOL
    for rank, res in _ranks().items():
        got = res["c14"]
        assert isinstance(got, dict), got
        np.testing.assert_allclose(got["logits"], want, rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=f"rank {rank}")
        assert (got["dropped"] > 0).all(), got["dropped"]


@pytest.mark.parametrize("layout", list(EP_LAYOUTS))
@pytest.mark.parametrize("top_k,capacity_factor", EP_CASES)
def test_ep_sharded_moe_forward_matches(top_k, capacity_factor, layout):
    """The experts over ep: {dp: 2, ep: 2} (ep not a data axis: each ep
    rank dispatches to its own experts' columns, the combine summed over
    ep), and ep = dp with the expert FFN over mdl 2 (the local (e, cap, d)
    buffer reduce-scattered over dp, the outputs all-gathered back)."""
    cfg = _ep_cfg(top_k, capacity_factor)
    _, _, _, toks = _flax(tuple(cfg.items()), 4, 16)
    want = _apply(cfg, toks[:2])
    for rank, res in _ranks().items():
        got = res[f"ep-{layout}-{top_k}"]
        assert isinstance(got, dict), got
        np.testing.assert_allclose(got["logits"], want, rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=f"rank {rank}")
        assert got["collectives"] == EP_LAYOUTS[layout][3], got["collectives"]


def test_moe_accum_fused_xent_step_over_ep_matches_jax():
    """One f32 sgd step with accum_steps=2 and fused_xent_block on {dp: 2,
    mdl: 2}, experts over dp: 3 rows a dp rank, so the two strided global
    microbatches take 2 + 1 and 1 + 2 rows of the two ranks (the shares
    weighted), the MoE capacity and aux per global microbatch, the
    lm_head gathered over mdl for the fused loss. The loss (the mean over
    dp) and every gathered param within 1e-5 of JAX's jitted step."""
    want_loss, want_params = _jax_step()
    model = Transformer(compute_dtype=torch.float32, device="meta",
                        **STEP_CFG)
    want = {n: t.numpy() for n, t in from_flax(want_params, model,
                                               device="cpu").items()}
    for rank, res in _ranks().items():
        got = res["step"]
        assert isinstance(got, dict), got
        np.testing.assert_allclose(got["losses"], [want_loss],
                                   rtol=STEP_TOL, atol=STEP_TOL)
        assert {k[len("param:"):] for k in got if k.startswith("param:")} \
            == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(got[f"param:{name}"], w,
                                       rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=f"rank {rank} {name}")
