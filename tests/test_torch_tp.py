"""The port's tensor parallelism over a mesh (the Transformer and VGG over a
``tp_axis``, the trainer's step on a mesh, ``hierarchical_psum`` over an
axis) against the JAX package, where XLA splits the same layers from the
parameters' shardings alone.

JAX runs on its virtual CPU mesh with the parameters placed by
``shard_params`` of its partition rules; the port runs in ONE spawn of 4
ranks (tests/torch_mesh_ranks.py) on each rank's blocks of the same
weights (flax init carried by ``from_flax``, then the port's
``shard_params``), and the blocks are gathered back. JAX's {dp: 4, mdl:
2} is cut to {dp: 2, mdl: 2}:

- the TP Transformer's logits (tests/test_transformer.py's
  test_tp_sharded_forward_matches: gelu MHA, and GQA swiglu), and ring
  attention over {sp: 2} with TP over {mdl: 2}, within 1e-4;
- one TP x DP adamw step of the Transformer (f32): the loss, the mean of
  the data ranks' losses, and every gathered param within 1e-5 of JAX's
  jitted step on the sharded state;
- the VGG's TP classifier (fc1 column, fc2 row, head column): logits and
  2 steps of sgd(momentum 0.9) within 1e-5 relative of JAX's; dropout
  under TP bitwise the unsharded port's for one seed;
- ``hierarchical_psum`` over "mdl": JAX's ``psum`` over "mdl" alone (a
  mesh that spans the world is one host: no DCN tier follows);
- the options A.6c and A.6d ported, built in place on a mesh model
  (cross_host and ZeRO-1 over the DCN group of a host mesh; the spawned
  cases of test_torch_dcn_mesh.py hold them to JAX).
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
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP
from torch_mesh_ranks import spawn

from tpunet.models import VGG as JaxVGG
from tpunet.models import Transformer as JaxTransformer
from tpunet.models import transformer_partition_rules as jax_tp_rules
from tpunet.parallel import batch_sharding, replicated
from tpunet.parallel import make_named_mesh as jax_mesh
from tpunet.parallel import shard_params as jax_shard_params
from tpunet.parallel import vgg_partition_rules as jax_vgg_rules
from tpunet.parallel.smap import shard_map as jax_shard_map
from tpunet.train import TrainState as JaxTrainState
from tpunet.train import create_train_state as jax_create_train_state
from tpunet.train import make_train_step as jax_make_train_step
from tpunet_torch.models import VGG, Transformer, from_flax
from tpunet_torch.parallel import Mesh, make_named_mesh
from tpunet_torch.train import (adamw, create_train_state,
                                create_zero_train_state, make_train_step,
                                make_zero_train_step)

MODEL_TOL, STEP_TOL, VGG_TOL = 1e-4, 1e-5, 1e-5
MODELS = {
    "gelu-mha": dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64),
    "swiglu-gqa": dict(vocab=64, d_model=32, n_layers=2, n_heads=4,
                       n_kv_heads=2, d_ff=64, mlp_impl="swiglu"),
}
VGG_CFG = dict(cfg=(8, "M", 16, "M"), num_classes=10, hidden=32)
TP_MESH = {"dp": 2, "mdl": 2}
LR, VGG_LR = 1e-3, 0.05


def _flax_model(cfg, **kw):
    return JaxTransformer(compute_dtype=jnp.float32, **cfg, **kw)


def _port_sd(params, model):
    return {n: t.numpy() for n, t in from_flax(
        jax.tree.map(np.asarray, params), model, device="cpu").items()}


@functools.lru_cache(maxsize=None)
def _transformer(name: str):
    """(flax params, port params, tokens, labels) of a tiny model."""
    cfg = MODELS[name]
    toks = np.random.default_rng(0).integers(0, 64, (4, 16)).astype(np.int32)
    params = jax.jit(_flax_model(cfg).init)(jax.random.PRNGKey(1),
                                            toks)["params"]
    tm = Transformer(compute_dtype=torch.float32, device="cpu", **cfg)
    return params, _port_sd(params, tm), toks, np.roll(toks, -1, axis=1)


def _place(params, mesh, rules):
    return jax.device_put(params, jax_shard_params(params, mesh, rules))


@functools.lru_cache(maxsize=None)
def _jax_logits(name: str, ring: bool = False) -> np.ndarray:
    params, _, toks, _ = _transformer(name)
    if ring:
        mesh = jax_mesh({"sp": 2, "mdl": 2})
        model = _flax_model(MODELS[name], attn_impl="ring", mesh=mesh,
                            dp_axis=None, sp_axis="sp", tp_axis="mdl")
        data = NamedSharding(mesh, JP(None, "sp"))
    else:
        mesh = jax_mesh(TP_MESH)
        model = _flax_model(MODELS[name])
        data = batch_sharding(mesh)
    p = _place(params, mesh, jax_tp_rules(tp_axis="mdl"))
    with mesh:
        out = jax.jit(lambda p, t: model.apply({"params": p}, t))(
            p, jax.device_put(jnp.asarray(toks), data))
    return np.asarray(out)


@functools.lru_cache(maxsize=None)
def _jax_step(family: str, steps: int):
    """JAX's jitted step(s) on the sharded state: (losses, flax params)."""
    if family == "transformer":
        params, _, x, y = _transformer("swiglu-gqa")
        model = _flax_model(MODELS["swiglu-gqa"])
        tx, rules = optax.adamw(LR, weight_decay=1e-4), jax_tp_rules("mdl")
    else:
        params, _, x, y = _vgg()
        model = JaxVGG(compute_dtype=jnp.float32, classifier_dropout=0.0,
                       **VGG_CFG)
        tx, rules = optax.sgd(VGG_LR, momentum=0.9), jax_vgg_rules()
    mesh = jax_mesh(TP_MESH)
    state, _ = jax_create_train_state(model, jax.random.PRNGKey(0),
                                      jnp.asarray(x), tx)
    opt = jax.tree.map(lambda a: jax.device_put(a, replicated(mesh)),
                       tx.init(params))
    state = JaxTrainState(_place(params, mesh, rules), opt, state.step)
    step = jax_make_train_step(model, tx, donate=False)
    xs, ys = (jax.device_put(jnp.asarray(a), batch_sharding(mesh))
              for a in (x, y))
    losses = []
    with mesh:
        for _ in range(steps):
            state, loss = step(state, xs, ys, jax.random.PRNGKey(2))
            losses.append(float(loss))
    return np.array(losses), jax.tree.map(np.asarray, state.params)


@functools.lru_cache(maxsize=None)
def _vgg():
    """(flax params, port params, images, labels) of a tiny VGG."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int32)
    jm = JaxVGG(compute_dtype=jnp.float32, **VGG_CFG)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), x)["params"]
    vm = VGG(compute_dtype=torch.float32, image_size=8, device="cpu",
             **VGG_CFG)
    return params, _port_sd(params, vm), x, y


@functools.lru_cache(maxsize=None)
def _ranks() -> dict:
    tp = tuple(TP_MESH.items())
    cases = {}
    for name, cfg in MODELS.items():
        _, sd, toks, _ = _transformer(name)
        cases[f"logits-{name}"] = ("model", dict(
            axes=tp, impl="reference", cfg=cfg, params=sd, tokens=toks,
            tp_axis="mdl"))
    _, sd, toks, labels = _transformer("swiglu-gqa")
    cases["ring-tp"] = ("model", dict(
        axes=(("sp", 2), ("mdl", 2)), impl="ring", cfg=MODELS["swiglu-gqa"],
        params=sd, tokens=toks, dp_axis=None, tp_axis="mdl"))
    cases["step-transformer"] = ("train_step", dict(
        axes=tp, family="transformer", cfg=MODELS["swiglu-gqa"], params=sd,
        inputs=toks.astype(np.int64), labels=labels.astype(np.int64),
        tx=("adamw", LR)))
    _, vsd, x, y = _vgg()
    vcfg = dict(VGG_CFG, image_size=8, classifier_dropout=0.0)
    cases["step-vgg"] = ("train_step", dict(
        axes=tp, family="vgg", cfg=vcfg, params=vsd, inputs=x,
        labels=y.astype(np.int64), tx=("sgd", VGG_LR, 0.9), steps=2))
    cases["vgg-dropout"] = ("vgg_forward", dict(
        axes=tp, cfg=dict(VGG_CFG, image_size=8, classifier_dropout=0.5),
        params=vsd, images=x, rng=5))
    cases["hierarchical"] = ("hierarchical", dict(axes=tp))
    return spawn(4, cases)


@pytest.mark.parametrize("name", list(MODELS))
def test_tp_transformer_logits_match_jax(name):
    want = _jax_logits(name)
    for rank, res in _ranks().items():
        got = res[f"logits-{name}"]
        assert isinstance(got, dict), got
        np.testing.assert_allclose(got["logits"], want, rtol=MODEL_TOL,
                                   atol=MODEL_TOL, err_msg=f"rank {rank}")


def test_ring_attention_under_tp_matches_jax():
    """attn_impl="ring" over sp with the layers split over mdl: each rank
    its sequence shard and its heads."""
    want = _jax_logits("swiglu-gqa", ring=True)
    for rank, res in _ranks().items():
        got = res["ring-tp"]
        assert isinstance(got, dict), got
        np.testing.assert_allclose(got["logits"], want, rtol=MODEL_TOL,
                                   atol=MODEL_TOL, err_msg=f"rank {rank}")


def _held_to_jax(got: dict, family: str, steps: int, rel: bool):
    want_losses, want_params = _jax_step(family, steps)
    np.testing.assert_allclose(got["losses"], want_losses, rtol=STEP_TOL,
                               atol=0 if rel else STEP_TOL)
    model = (Transformer(compute_dtype=torch.float32, device="meta",
                         **MODELS["swiglu-gqa"]) if family == "transformer"
             else VGG(compute_dtype=torch.float32, image_size=8,
                      device="meta", **VGG_CFG))
    want = _port_sd(want_params, model)
    assert {k[len("param:"):] for k in got if k.startswith("param:")} == \
        set(want)
    for name, w in want.items():
        g = got[f"param:{name}"]
        if rel:
            err = np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-12)
            assert err <= VGG_TOL, (name, err)
        else:
            np.testing.assert_allclose(g, w, rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=name)


def test_tp_dp_train_step_matches_jax():
    """One adamw step over {dp: 2, mdl: 2}: the gradients meaned over dp
    only, the TP blocks never reduced over mdl."""
    for rank, res in _ranks().items():
        got = res["step-transformer"]
        assert isinstance(got, dict), got
        _held_to_jax(got, "transformer", 1, rel=False)


def test_vgg_tp_classifier_matches_jax():
    for rank, res in _ranks().items():
        got = res["step-vgg"]
        assert isinstance(got, dict), got
        _held_to_jax(got, "vgg", 2, rel=True)


def test_vgg_tp_dropout_is_the_unsharded_draw():
    """Dropout 0.5 under TP, the full hidden-wide mask drawn and the
    rank's columns kept: the logits equal the unsharded port's for one
    seed, bitwise apart from the row-parallel sum's order."""
    _, vsd, x, _ = _vgg()
    vm = VGG(compute_dtype=torch.float32, image_size=8, device="meta",
             classifier_dropout=0.5, **VGG_CFG)
    net = vm.bind({n: torch.from_numpy(a) for n, a in vsd.items()})
    want = net(torch.from_numpy(x), train=True, rng=5).detach().numpy()
    plain = net(torch.from_numpy(x)).detach().numpy()
    assert not np.allclose(want, plain, atol=1e-3)
    for rank, res in _ranks().items():
        got = res["vgg-dropout"]
        assert isinstance(got, dict), got
        np.testing.assert_allclose(got["logits"], want, rtol=1e-5,
                                   atol=1e-5, err_msg=f"rank {rank}")


def test_hierarchical_psum_over_an_axis_matches_jax():
    """hierarchical_psum(x, "mdl") with the mesh active: JAX's
    hierarchical_psum on one process, lax.psum over "mdl" alone, of the
    same blocks (the mesh spans the world: one host, no DCN tier)."""
    n = 4
    blocks = np.stack([np.arange(3, dtype=np.float32) * (r + 1) + r
                       for r in range(n)])
    mesh = jax_mesh(TP_MESH)
    fn = jax_shard_map(lambda b: jax.lax.psum(b, "mdl"),
                       mesh=mesh, in_specs=JP(("dp", "mdl")),
                       out_specs=JP(("dp", "mdl")))
    want = np.asarray(jax.jit(fn)(jnp.asarray(blocks.reshape(n * 1, 3))))
    for rank, res in _ranks().items():
        got = res["hierarchical"]
        assert isinstance(got, dict), got
        np.testing.assert_array_equal(got["total"], want[rank])


def test_mesh_refusals_and_later_options():
    """The options A.6c and A.6d ported build in place on a mesh model:
    cross_host=True and ZeRO-1 (over a mesh of one rank in a world of one:
    one host, so the DCN tier is the identity and each step is the plain
    mesh step's, bitwise), int8, LoRA and MoE layers under a tp_axis,
    accum_steps on a mesh, and features_only under TP (the spawned cases
    of test_torch_dcn_mesh.py, test_torch_tp_serve.py,
    test_torch_tp_quant_lora.py and test_torch_ep_moe.py hold them to JAX
    over 4 and 8 ranks). The disaggregated serving tiers build on a mesh
    model too (ROADMAP A.12; test_torch_tp_serve.py runs them over tp
    groups of ranks)."""
    from tpunet_torch import distributed
    from tpunet_torch.serve import PrefillEngine

    mesh = Mesh(np.arange(4).reshape(2, 2), ("dp", "mdl"), rank=0)
    cfg = dict(MODELS["gelu-mha"], compute_dtype=torch.float32)
    m = Transformer(mesh=mesh, tp_axis="mdl", device="meta", **cfg)
    tx = adamw(LR)
    local = m.local_params(m.init_params(seed=0, device="cpu"))
    pe = PrefillEngine(m, local, max_len=16, device="cpu")
    assert pe.group.size == 2 and pe.group.leader
    assert pe.kv_leaf_shapes(3)[0] == (3, 4, 8)   # whole heads (MHA)
    assert m.kv_head_ids() == [0, 1]               # this rank's two
    distributed.initialize(f"127.0.0.1:{free_port()}", 0, 1)
    try:
        one = make_named_mesh({"dp": 1, "mdl": 1})
        assert one.n_hosts == 1 and one.dcn_comm() is None
        tm = Transformer(mesh=one, tp_axis="mdl", device="meta", **cfg)
        toks = torch.from_numpy(_transformer("gelu-mha")[2]).long()
        labels = torch.roll(toks, -1, dims=1)
        runs = {}
        for name, create, make in (
                ("plain", create_train_state, make_train_step),
                ("cross_host", create_train_state,
                 lambda mm, t: make_train_step(mm, t, cross_host=True)),
                ("zero", create_zero_train_state, make_zero_train_step)):
            state, _ = create(tm, 0, None, tx, device="cpu")
            state, loss = make(tm, tx)(state, toks, labels)
            runs[name] = (float(loss), torch.cat(
                [p.detach().reshape(-1) for p in state.params.values()]))
        for name in ("cross_host", "zero"):
            assert runs[name][0] == runs["plain"][0]
            assert torch.equal(runs[name][1], runs["plain"][1]), name
        assert state.opt_state.param_groups[0]["zero"]["mesh"] == {
            "dp": 1, "mdl": 1}
    finally:
        distributed.finalize()
    make_train_step(m, tx, accum_steps=2)
    for kw in ({"weight_quant": "int8"}, {"lora_rank": 2},
               {"n_experts": 2}):
        tm = Transformer(mesh=mesh, tp_axis="mdl", device="meta", **cfg,
                         **kw)
        blocks = tm.local_params(tm.init_params(seed=0, device="cpu"))
        assert any(tuple(t.shape) != tuple(p.shape) for t, (_, p) in zip(
            blocks.values(), tm.named_parameters()))
    with pytest.warns(UserWarning, match="TP head speedup is lost"):
        make_train_step(m, tx, fused_xent_block=16)
    with pytest.raises(ValueError, match="requires a mesh"):
        Transformer(attn_impl="ring", device="meta", **cfg)
    # A mesh without a tp axis keeps every leaf whole and trains as DP.
    dp_only = Transformer(mesh=mesh, device="meta", **cfg)
    assert dp_only.data_axes() == ("dp",)
    state, _ = create_train_state(dp_only, 0, None, tx, device="cpu")
    assert all(tuple(t.shape) == tuple(p.shape) for t, (_, p) in zip(
        state.params.values(), dp_only.named_parameters()))
    # features_only under TP returns the features (a mesh of one rank:
    # every collective is the identity).
    one = make_named_mesh({"dp": 1, "mdl": 1})
    tm = Transformer(mesh=one, tp_axis="mdl", device="meta", **cfg)
    net = tm.bind(tm.local_params(tm.init_params(seed=0, device="cpu")))
    toks = torch.zeros((1, 4), dtype=torch.long)
    assert net(toks, features_only=True).shape == (1, 4, cfg["d_model"])
