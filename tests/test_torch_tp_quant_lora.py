"""The port's int8 and LoRA layers under tensor parallelism against the
JAX package, where XLA splits ``QuantDense`` and ``LoraDense`` from the
partition rules alone: the int8 model's logits, the adapted tree's
forward (tests/test_lora.py's test_lora_tp_rules_shard_the_adapted_tree)
and one QLoRA step of ``lora_optimizer(adam(1e-2))`` (the multichip dry
run's ``_dryrun_qlora_inference``), over {dp: 2, mdl: 2}.

The port runs in ONE spawn of 4 torch-only ranks
(tests/torch_mesh_ranks.py) on each rank's blocks (``from_flax`` of the
flax tree, then the port's partition rules): a column-parallel layer's q
and scale (int8) or B (LoRA) split by output, a row-parallel one's q or A
by input with the scale or B whole, the adapter's partial joining the
base's before the one psum. JAX runs on its virtual mesh of the same
shape (the dry run's mdl 4 at 8 devices is cut to mdl 2 at 4).
"""

from __future__ import annotations

import functools

import numpy as np

from conftest import free_port  # noqa: F401  (pins JAX_PLATFORMS=cpu first)

import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP
from torch_mesh_ranks import spawn

from tpunet.models import Transformer as JaxTransformer
from tpunet.models import (graft_base, lora_apply_updates, lora_mask,
                           lora_optimizer, quantize_params)
from tpunet.models import transformer_partition_rules as jax_tp_rules
from tpunet.parallel import make_named_mesh as jax_mesh
from tpunet.parallel import shard_params as jax_shard_params
from tpunet_torch.models import Transformer, from_flax
from tpunet_torch.parallel import Mesh, P, shard_params

FWD_TOL, STEP_TOL, LR = 1e-4, 1e-5, 1e-2
TP_MESH = {"dp": 2, "mdl": 2}
BASE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            n_kv_heads=2)
LORA = dict(BASE, lora_rank=4)
QLORA = dict(BASE, weight_quant="int8", lora_rank=4)
INT8 = dict(BASE, weight_quant="int8")


def _port_sd(tree, cfg):
    tm = Transformer(compute_dtype=torch.float32, device="meta", **cfg)
    return {n: t.numpy() for n, t in from_flax(
        jax.tree.map(np.asarray, tree), tm, device="cpu").items()}


@functools.lru_cache(maxsize=None)
def _trees():
    """{name: (flax model, flax params, port params, tokens)}: the int8
    base, the adapted fp tree (tests/test_lora.py's, its adapters moved by
    0.01 normal noise) and the adapted int8 tree (the dry run's QLoRA
    graft, moved the same way)."""
    base = JaxTransformer(compute_dtype=jnp.float32, **BASE)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2, 24), 0,
                                         64), np.int32)
    bp = base.init(jax.random.PRNGKey(1), toks)["params"]
    out = {"int8": (base.clone(weight_quant="int8"), quantize_params(bp),
                    INT8, toks)}
    for name, quant in (("lora", False), ("qlora", True)):
        m = base.clone(lora_rank=4, weight_quant="int8" if quant else None)
        init = m.init(jax.random.PRNGKey(2), toks)["params"]
        p = graft_base(init, quantize_params(bp) if quant else bp)
        # Random adapters: with B constant, the lm_head's A would see
        # sum_v(softmax - onehot) = 0, a gradient of pure rounding noise.
        rng = np.random.default_rng(4)
        p = jax.tree.map(lambda leaf, a: leaf + 0.01 * rng.standard_normal(
            leaf.shape).astype(np.float32) if a else leaf, p, lora_mask(p))
        out[name] = (m, p, QLORA if quant else LORA, toks)
    step_toks = np.random.default_rng(0).integers(0, 64, (4, 12)).astype(
        np.int32)
    return {k: (m, p, _port_sd(p, cfg), step_toks if k == "qlora" else t)
            for k, (m, p, cfg, t) in out.items()}


@functools.lru_cache(maxsize=None)
def _jax_qlora_step():
    """The dry run's jitted QLoRA step on {dp: 2, mdl: 2}: (loss, params)."""
    model, params, _, toks = _trees()["qlora"]
    mesh = jax_mesh(TP_MESH)
    params = jax.device_put(params, jax_shard_params(
        params, mesh, jax_tp_rules(tp_axis="mdl")))
    tx = lora_optimizer(optax.adam(LR), params)
    opt_state = tx.init(params)
    data = NamedSharding(mesh, JP("dp"))
    t = jax.device_put(jnp.asarray(toks), data)
    lb = jax.device_put(jnp.roll(jnp.asarray(toks), -1, axis=1), data)

    def loss_fn(p, t, lb):
        logits = model.apply({"params": p}, t)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, lb).mean()

    @jax.jit
    def step(p, s, t, lb):
        loss, g = jax.value_and_grad(loss_fn, allow_int=True)(p, t, lb)
        updates, s = tx.update(g, s, p)
        return lora_apply_updates(p, updates), s, loss

    with mesh:
        params, _, loss = step(params, opt_state, t, lb)
    return float(loss), jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _ranks() -> dict:
    axes = tuple(TP_MESH.items())
    cases = {}
    for name, cfg in (("int8", INT8), ("lora", LORA)):
        _, _, sd, toks = _trees()[name]
        cases[name] = ("model", dict(axes=axes, impl="reference", cfg=cfg,
                                     params=sd, tokens=toks, tp_axis="mdl"))
    _, _, sd, toks = _trees()["qlora"]
    cases["qlora-step"] = ("train_step", dict(
        axes=axes, family="transformer", cfg=QLORA, params=sd,
        inputs=toks.astype(np.int64),
        labels=np.roll(toks, -1, axis=1).astype(np.int64),
        tx=("adam", LR), lora=True))
    return spawn(4, cases)


def _apply(name: str) -> np.ndarray:
    model, params, _, toks = _trees()[name]
    return np.asarray(jax.jit(lambda p, t: model.apply({"params": p}, t))(
        params, jnp.asarray(toks)))


def test_lora_tp_rules_shard_the_adapted_tree():
    """The port's rules reach through the "base" nesting (its layout: a
    weight is (out, in), lora_a (in, r) and lora_b (r, out) flax's), and
    the adapted forward over {dp: 2, mdl: 2} is the unsharded one."""
    _, _, sd, _ = _trees()["lora"]
    mesh = Mesh(np.arange(4).reshape(2, 2), ("dp", "mdl"), rank=0)
    m = Transformer(compute_dtype=torch.float32, mesh=mesh, tp_axis="mdl",
                    device="meta", **LORA)
    specs, _ = shard_params({n: torch.from_numpy(a) for n, a in sd.items()},
                            mesh, m.partition_rules())
    assert specs["block0.attn.q.base.weight"] == P("mdl")
    assert specs["block0.attn.q.lora_a"] == P()
    assert specs["block0.attn.q.lora_b"] == P(None, "mdl")
    assert specs["block0.attn.out.base.weight"] == P(None, "mdl")
    assert specs["block0.attn.out.lora_a"] == P("mdl")
    assert specs["block0.attn.out.lora_b"] == P()
    want = _apply("lora")
    for rank, res in _ranks().items():
        got = res["lora"]
        assert isinstance(got, dict), got
        np.testing.assert_allclose(got["logits"], want, rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=f"rank {rank}")


def test_int8_tp_forward_matches_jax():
    """QuantDense under TP: the column blocks' products scaled by their
    scale block, the row blocks' by the whole scale before the psum."""
    want = _apply("int8")
    for rank, res in _ranks().items():
        got = res["int8"]
        assert isinstance(got, dict), got
        np.testing.assert_allclose(got["logits"], want, rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=f"rank {rank}")


def test_tp_qlora_step_matches_jax():
    """One lora_optimizer(adam(1e-2)) step of the int8 base under rank-4
    adapters over {dp: 2, mdl: 2}: the loss and the adapters within 1e-5
    of JAX's jitted step; every frozen leaf (int8 q and scale, embed, norm
    scales) bitwise its start."""
    want_loss, want_params = _jax_qlora_step()
    want = _port_sd(want_params, QLORA)
    _, _, start, _ = _trees()["qlora"]
    for rank, res in _ranks().items():
        got = res["qlora-step"]
        assert isinstance(got, dict), got
        np.testing.assert_allclose(got["losses"], [want_loss], rtol=STEP_TOL,
                                   atol=STEP_TOL)
        moved = 0
        for name, w in want.items():
            g = got[f"param:{name}"]
            if name.rsplit(".", 1)[-1] in ("lora_a", "lora_b"):
                np.testing.assert_allclose(g, w, rtol=STEP_TOL, atol=STEP_TOL,
                                           err_msg=f"rank {rank} {name}")
                moved += not np.array_equal(g, start[name])
            else:
                np.testing.assert_array_equal(g, start[name],
                                              err_msg=f"rank {rank} {name}")
        assert moved == 2 * (6 * BASE["n_layers"] + 1)   # every A and B
