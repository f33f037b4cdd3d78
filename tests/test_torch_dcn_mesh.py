"""The DCN tier across host meshes (a mesh is one host's ranks, its DCN
group the ranks at its coordinates in every host) against the JAX package,
where a process drives its host's chips and the DCN tier runs across the
processes.

Every multi-rank case runs in ONE spawn of 8 ranks
(tests/torch_dcn_mesh_ranks.py): 2 hosts of {dp: 2, mdl: 2}, and over the
same ranks the world-spanning {dp: 4, mdl: 2}. The model is a tiny GQA
Transformer (2 layers, d 64, 4 heads, 2 kv heads, vocab 128, seq 16) on a
global batch of 8 rows, 4 a host, 2 a rank. JAX runs ``make_train_step``
on one process over the two hosts' batches concatenated in host order, on
its virtual {dp: 4, mdl: 2} CPU mesh (the mean of equal host means is the
global mean):

- wiring: each rank's in-host groups and its DCN group, and a sum over
  each; at one host no DCN group, and ``dcn_*`` over the world;
- ``cross_host=True`` flat, bucketed (at least 3 buckets) and
  ``accum_steps=2``: two steps' losses and every rank's blocks within f32
  rtol 1e-5 / atol 1e-6 of JAX's (``STEP_RTOL``, ``STEP_ATOL``);
- ``grad_compression="bf16"``, cast by the trainer on the f32 wire and
  quantized by the DCN group's ring on a bf16 wire (the group takes the
  world's codec, an in-host group does not): within ``BF16_TOL`` of the f32
  run;
- ZeRO-1 bitwise the ``cross_host`` run (at 2 hosts the reduce-scatter's
  sum is the all-reduce's, /2 is exact, adamw is elementwise), so at JAX's
  tolerance too, with one reduce-scatter and one all-gather a step and
  optimizer bytes at most the replicated ones / 2 plus padding; and over
  4 hosts of {dp: 2, mdl: 1}, DCN groups of 4 whose shards a model of
  51,942 elements pads by 2, within tests/test_zero.py's world-3 bound of
  the ``cross_host`` run (a ring of 4 sums an element in the order of
  its chunk, which the padding moves);
- ``hierarchical_psum`` over an axis: on the host mesh JAX's ``lax.psum``
  over the axis of a host's blocks summed over the hosts; on the world
  mesh ``lax.psum`` alone (ROADMAP C.16);
- checkpoints (ROADMAP C.15): a replicated state of the world mesh, and a
  replicated and a ZeRO state of the host mesh, each through
  ``fit(checkpoint_dir=...)`` in a directory its ranks share: every rank
  restores its own blocks and optimizer state bitwise and ``fit`` resumes
  from them; the host mesh's checkpoints restored into the world mesh's
  states raise, and a ``save_pytree`` to one shared path gives a rank its
  own blocks or raises;
- a QLoRA int8 base under TP with ``cross_host``: the integer leaves
  untouched, the rest within ``STEP_RTOL`` of the world mesh's step.
"""

from __future__ import annotations

import functools
import shutil
import tempfile

import numpy as np
import pytest

from conftest import free_port

import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import PartitionSpec as JP
from torch_dcn_mesh_ranks import H4, HOST, WORLD, spawn

from tpunet.models import Transformer as JaxTransformer
from tpunet.models import transformer_partition_rules as jax_tp_rules
from tpunet.parallel import batch_sharding, replicated
from tpunet.parallel import make_named_mesh as jax_mesh
from tpunet.parallel import shard_params as jax_shard_params
from tpunet.parallel.smap import shard_map as jax_shard_map
from tpunet.train import TrainState as JaxTrainState
from tpunet.train import create_train_state as jax_create_train_state
from tpunet.train import make_train_step as jax_make_train_step
from tpunet_torch.models import (Transformer, from_flax, graft_base,
                                 lora_mask, quantize_params)

CFG = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=128)
QLORA = dict(CFG, weight_quant="int8", lora_rank=4)
BATCH, SEQ, LR, HOSTS = 8, 16, 1e-3, 2
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6
# bf16 gradients against f32 ones, two adamw steps: adam normalises each
# update, so where a gradient's bf16 rounding (2^-8 relative) is all there
# is to an element, the two runs' updates can point opposite ways. An
# update is at most lr·|m̂/sqrt(v̂)|: 1 at the first step and, by
# Cauchy-Schwarz over optax's b1 0.9 and b2 0.999, 1.0014 at the second;
# so two runs differ by at most 2·lr·(1 + 1.0014) < 4.01·lr an element.
# Their losses, means over the whole batch, stay within BF16_LOSS_RTOL.
BF16_TOL, BF16_LOSS_RTOL = 4.01 * LR, 1e-4
BUCKET_BYTES = 16 << 10
# A model of 51,942 elements, which 4 hosts do not divide: ZeRO pads the
# flat vector by 2 (an even head dim for the rotary embedding, d_model
# 2 mod 4).
PAD = dict(vocab=128, d_model=66, n_layers=1, n_heads=3, d_ff=132)


def _flax_model(cfg):
    return JaxTransformer(compute_dtype=jnp.float32, **cfg)


@functools.lru_cache(maxsize=None)
def _inputs():
    """(flax params, port params, tokens, labels): the global batch."""
    toks = np.random.default_rng(0).integers(0, CFG["vocab"], (BATCH, SEQ))
    toks = toks.astype(np.int32)
    params = jax.jit(_flax_model(CFG).init)(jax.random.PRNGKey(1),
                                            toks)["params"]
    tm = Transformer(compute_dtype=torch.float32, device="cpu", **CFG)
    sd = {n: t.numpy() for n, t in from_flax(
        jax.tree.map(np.asarray, params), tm, device="cpu").items()}
    return params, sd, toks, np.roll(toks, -1, axis=1)


@functools.lru_cache(maxsize=None)
def _qlora_params() -> dict:
    """The port's QLoRA tree: an int8 base grafted under rank-4 adapters
    moved by 0.01 normal noise (constant adapters give the lm_head's A a
    gradient of pure rounding noise)."""
    base = Transformer(compute_dtype=torch.float32, device="cpu", **CFG)
    adapted = Transformer(compute_dtype=torch.float32, device="cpu",
                          **QLORA)
    p = graft_base(adapted.init_params(seed=2, device="cpu"),
                   quantize_params(base.init_params(seed=1, device="cpu")))
    rng = np.random.default_rng(4)
    mask = lora_mask(p)
    return {k: (t.numpy() + 0.01 * rng.standard_normal(t.shape).astype(
        np.float32)) if mask[k] else t.numpy() for k, t in p.items()}


@functools.lru_cache(maxsize=None)
def _jax_step(accum_steps: int | None, steps: int = 2):
    """JAX's jitted steps on one process over the global batch on
    {dp: 4, mdl: 2}: (losses, port-layout params)."""
    params, _, x, y = _inputs()
    model = _flax_model(CFG)
    tx = optax.adamw(LR, weight_decay=1e-4)
    mesh = jax_mesh(dict(WORLD))
    state, _ = jax_create_train_state(model, jax.random.PRNGKey(0),
                                      jnp.asarray(x), tx)
    opt = jax.tree.map(lambda a: jax.device_put(a, replicated(mesh)),
                       tx.init(params))
    placed = jax.device_put(params, jax_shard_params(params, mesh,
                                                     jax_tp_rules("mdl")))
    state = JaxTrainState(placed, opt, state.step)
    step = jax_make_train_step(model, tx, donate=False,
                               accum_steps=accum_steps)
    xs, ys = (jax.device_put(jnp.asarray(a), batch_sharding(mesh))
              for a in (x, y))
    losses = []
    with mesh:
        for _ in range(steps):
            state, loss = step(state, xs, ys, jax.random.PRNGKey(2))
            losses.append(float(loss))
    tm = Transformer(compute_dtype=torch.float32, device="meta", **CFG)
    out = {n: t.numpy() for n, t in from_flax(
        jax.tree.map(np.asarray, state.params), tm, device="cpu").items()}
    return np.array(losses), out


@functools.lru_cache(maxsize=None)
def _ranks() -> dict:
    _, sd, x, y = _inputs()
    run = dict(cfg=CFG, params=sd, inputs=x.astype(np.int64),
               labels=y.astype(np.int64), lr=LR)
    tmp = tempfile.mkdtemp(prefix="dcn_mesh_ckpt_")
    cases = {
        "wiring": ("wiring", {}),
        "flat": ("train", dict(axes=HOST, **run)),
        "bucketed": ("train", dict(axes=HOST, bucket_bytes=BUCKET_BYTES,
                                   **run)),
        "accum": ("train", dict(axes=HOST, accum_steps=2, **run)),
        "bf16-cast": ("train", dict(axes=HOST, grad_compression="bf16",
                                    **run)),
        "zero": ("train", dict(axes=HOST, zero=True, **run)),
        "world": ("train", dict(axes=WORLD, **run)),
        "hierarchical": ("hierarchical", {}),
        "ckpt-world": ("checkpoint", dict(directory=f"{tmp}/world",
                                          axes=WORLD, zero=False, steps=1,
                                          **run)),
        "ckpt-replicated": ("checkpoint", dict(
            directory=f"{tmp}/replicated", axes=HOST, zero=False, **run)),
        "ckpt-zero": ("checkpoint", dict(directory=f"{tmp}/zero", axes=HOST,
                                         zero=True, **run)),
        "ckpt-foreign": ("foreign", dict(directory=tmp, cfg=CFG, params=sd,
                                         lr=LR)),
    }
    pad = {k: t.numpy() for k, t in Transformer(
        compute_dtype=torch.float32, device="cpu", **PAD).init_params(
            seed=3, device="cpu").items()}
    prun = dict(run, cfg=PAD, params=pad)
    cases["h4-flat"] = ("train", dict(axes=H4, **prun))
    cases["h4-zero"] = ("train", dict(axes=H4, zero=True, **prun))
    qrun = dict(run, cfg=QLORA, params=_qlora_params(), lora=True)
    cases["qlora"] = ("train", dict(axes=HOST, **qrun))
    cases["qlora-world"] = ("train", dict(axes=WORLD, **qrun))
    try:
        return spawn(8, cases, dict(run, port=free_port()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _result(rank_res: dict, name: str) -> dict:
    got = rank_res[name]
    assert isinstance(got, dict), f"{name}: {got}"
    return got


def _params(got: dict) -> dict:
    return {k[len("param:"):]: v for k, v in got.items()
            if k.startswith("param:")}


def test_host_mesh_wiring():
    """Host h is ranks 4h..4h+3 laid out as {dp: 2, mdl: 2}; the in-host
    groups stay in the host; the DCN group is the ranks at the same
    coordinates, ranked by host; the world mesh has no DCN group, and
    dcn_* under it (or with no mesh active) run over the world."""
    for rank, res in _ranks().items():
        w = _result(res, "wiring")
        h, local = divmod(rank, 4)
        host = w["host"]
        assert (host["n_hosts"], host["host"]) == (HOSTS, h)
        assert host["devices"] == (4 * h + np.arange(4).reshape(2, 2)
                                   ).tolist()
        assert host["coords"] == {"dp": local // 2, "mdl": local % 2}
        assert host["groups"] == {
            "dp": [4 * h + local % 2, 4 * h + 2 + local % 2],
            "mdl": [4 * h + local // 2 * 2, 4 * h + local // 2 * 2 + 1],
            "dp+mdl": list(range(4 * h, 4 * h + 4))}
        assert host["dcn"] == (h, HOSTS)
        for axes, members in host["groups"].items():
            assert host["sums"][axes] == sum(members)
        assert host["dcn_sum"] == local + (local + 4)
        np.testing.assert_array_equal(host["dcn_gather"],
                                      [[local], [local + 4]])
        world = w["world"]
        assert (world["n_hosts"], world["host"], world["dcn"]) == (1, 0, None)
        assert world["devices"] == np.arange(8).reshape(4, 2).tolist()
        assert world["sums"]["dp+mdl"] == 28
        assert world["dcn_sum"] == w["no_mesh_sum"] == 28


def _held_to_jax(got: dict, accum_steps=None) -> None:
    want_losses, want = _jax_step(accum_steps)
    np.testing.assert_allclose(got["losses"], want_losses, rtol=STEP_RTOL,
                               atol=STEP_ATOL)
    params = _params(got)
    assert set(params) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(params[name], w, rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=name)


@pytest.mark.parametrize("case", ["flat", "bucketed", "accum"])
def test_cross_host_on_a_host_mesh_matches_jax(case):
    """make_train_step(cross_host=True) on 2 hosts of {dp: 2, mdl: 2}: the
    in-host dp mean, then the DCN group's mean over the hosts (one flat
    all-reduce a step, or the buckets), is JAX's step on the global batch;
    accum_steps takes the host's strided microbatches, which at an even
    host batch are JAX's global ones."""
    for rank, res in _ranks().items():
        got = _result(res, case)
        _held_to_jax(got, 2 if case == "accum" else None)
        # The in-host dp mean, then the DCN mean: one blocking all-reduce
        # a step, or at least 3 buckets in flight at once.
        if case == "bucketed":
            assert got["calls"]["all_reduce"] == 1, got["calls"]
            assert got["max_in_flight"] >= 3, got["max_in_flight"]
        else:
            assert got["calls"]["all_reduce"] == 2, got["calls"]


def test_bf16_gradients_on_a_host_mesh():
    """grad_compression="bf16": the trainer's cast on the f32 wire, and on
    a world built with wire_dtype="bf16" the DCN group's ring (the group
    takes the world's codec; an in-host group stays at the env's f32),
    each within BF16_TOL of the f32 run, the tp ranks of a position
    equal."""
    for rank, res in _ranks().items():
        f32 = _params(_result(res, "flat"))
        wire = _result(res, "bf16-wire")
        assert wire["codecs"] == ["bf16", "bf16", "f32"]
        for name in ("bf16-cast", "bf16-wire"):
            np.testing.assert_allclose(_result(res, name)["losses"],
                                       _result(res, "flat")["losses"],
                                       rtol=BF16_LOSS_RTOL)
            got = _params(_result(res, name))
            for k, v in f32.items():
                np.testing.assert_allclose(got[k], v, rtol=0, atol=BF16_TOL,
                                           err_msg=f"{name} {k}")
            assert not all(np.array_equal(got[k], v) for k, v in f32.items())


def test_zero_on_a_host_mesh_is_the_cross_host_step():
    """ZeRO-1 over the DCN group: bitwise the cross_host run's losses and
    blocks, one reduce-scatter and one all-gather a step over the group
    (and the in-host dp mean's all-reduce), the adamw moments at most
    half the replicated step's plus padding."""
    for rank, res in _ranks().items():
        zero, flat = _result(res, "zero"), _result(res, "flat")
        np.testing.assert_array_equal(zero["losses"], flat["losses"])
        for k, v in _params(flat).items():
            np.testing.assert_array_equal(_params(zero)[k], v, err_msg=k)
        assert zero["calls"] == {"all_reduce": 1, "reduce_scatter": 1,
                                 "all_gather": 1}
        assert zero["opt_bytes"] <= flat["opt_bytes"] / HOSTS + 2 * 4 * HOSTS
        assert zero["block_bytes"] == flat["block_bytes"]
        _held_to_jax(zero)


def test_zero_over_four_hosts_pads_its_shards():
    """4 hosts of {dp: 2, mdl: 1}: the in-host dp mean, then each DCN
    group a ring of 4, the 51,942 elements padded by 2 to 4 shards of
    12,986; ZeRO within tests/test_zero.py's world-3 bound of the
    cross_host run (losses rtol 1e-6, params rtol 2e-6 / atol 2e-7), and
    every rank of both runs on the same params."""
    hosts = 4
    params = {}
    for rank, res in _ranks().items():
        zero, flat = _result(res, "h4-zero"), _result(res, "h4-flat")
        n = flat["block_bytes"] // 4
        assert n % hosts == 2 and zero["opt_elems"] == -(-n // hosts)
        assert zero["calls"] == {"all_reduce": 1, "reduce_scatter": 1,
                                 "all_gather": 1}
        assert flat["calls"]["all_reduce"] == 2
        np.testing.assert_allclose(zero["losses"], flat["losses"], rtol=1e-6)
        for k, v in _params(flat).items():
            np.testing.assert_allclose(_params(zero)[k], v, rtol=2e-6,
                                       atol=2e-7, err_msg=k)
            params.setdefault(k, v)
            np.testing.assert_array_equal(v, params[k], err_msg=k)
        assert zero["opt_bytes"] <= flat["opt_bytes"] / hosts + 2 * 4 * hosts


def test_world_mesh_step_is_the_host_meshes_step():
    """The same global batch on the world-spanning {dp: 4, mdl: 2}, no DCN
    tier: within STEP_RTOL of the two hosts' cross_host step."""
    for rank, res in _ranks().items():
        world, flat = _result(res, "world"), _result(res, "flat")
        np.testing.assert_allclose(world["losses"], flat["losses"],
                                   rtol=STEP_RTOL, atol=STEP_ATOL)
        assert world["calls"]["all_reduce"] == 1
        for k, v in _params(flat).items():
            np.testing.assert_allclose(_params(world)[k], v, rtol=STEP_RTOL,
                                       atol=STEP_ATOL, err_msg=k)


def test_hierarchical_psum_on_host_and_world_meshes():
    """hierarchical_psum(x, axis): on the host mesh JAX's psum over the
    axis of the host's 4 blocks (a {dp: 2, mdl: 2} JAX mesh), summed over
    the 2 hosts; on the world mesh JAX's psum over the axis alone."""
    blocks = np.stack([np.arange(3, dtype=np.float32) * (r + 1) + r
                       for r in range(8)])

    def jax_psum(mesh_axes, b, axis):
        mesh = jax_mesh(dict(mesh_axes))
        fn = jax_shard_map(lambda v: jax.lax.psum(v, axis), mesh=mesh,
                           in_specs=JP(("dp", "mdl")),
                           out_specs=JP(("dp", "mdl")))
        return np.asarray(jax.jit(fn)(jnp.asarray(b)))

    for axis in ("mdl", "dp"):
        host = sum(jax_psum(HOST, blocks[4 * h:4 * h + 4], axis)
                   for h in range(HOSTS))
        world = jax_psum(WORLD, blocks, axis)
        for rank, res in _ranks().items():
            got = _result(res, "hierarchical")
            np.testing.assert_array_equal(got[f"host:{axis}"], host[rank % 4])
            np.testing.assert_array_equal(got[f"world:{axis}"], world[rank])


@pytest.mark.parametrize("case", ["ckpt-world", "ckpt-replicated",
                                  "ckpt-zero"])
def test_mesh_checkpoint_in_a_shared_directory(case):
    """ROADMAP C.15: the ranks of a mesh share one checkpoint directory;
    every rank gets back its own blocks and optimizer state, bitwise, from
    CheckpointManager.restore and from fit() resuming."""
    for rank, res in _ranks().items():
        got = _result(res, case)
        assert got["params"] and got["opt"], (rank, got)
        assert got["fit_resumed"], (rank, got)


def test_mesh_checkpoint_refuses_a_foreign_layout():
    """A host mesh's checkpoints restored into states of another mesh
    shape (and, for ZeRO, another host count) raise; a save_pytree that
    every rank wrote to one path gives back the rank's own blocks or
    raises, never another rank's."""
    for rank, res in _ranks().items():
        got = _result(res, "ckpt-foreign")
        assert got["replicated"].startswith("raised"), got
        assert got["zero"].startswith("raised"), got
        assert got["pytree"] == "own" or got["pytree"].startswith("raised")


def test_qlora_under_tp_with_cross_host():
    """The int8 base under TP with rank-4 adapters, lora_optimizer(adamw),
    cross_host over 2 hosts: the integer leaves bitwise their start (they
    take no part in either tier), the rest within STEP_RTOL of the world
    mesh's step on the same global batch."""
    for rank, res in _ranks().items():
        got, world = _result(res, "qlora"), _result(res, "qlora-world")
        assert got["frozen"] > 0 and got["frozen_same"]
        np.testing.assert_allclose(got["losses"], world["losses"],
                                   rtol=STEP_RTOL, atol=STEP_ATOL)
        start = _qlora_params()
        for k, v in _params(world).items():
            if not np.issubdtype(v.dtype, np.floating):
                np.testing.assert_array_equal(_params(got)[k], start[k])
            np.testing.assert_allclose(_params(got)[k], v, rtol=STEP_RTOL,
                                       atol=STEP_ATOL, err_msg=k)
