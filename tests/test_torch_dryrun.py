"""The port's multichip dry run (``tpunet_torch/dryrun.py``) against the
JAX package's (``__graft_entry__.py``), on the CPU.

- Each of the five programs takes JAX's initial parameters (the flax inits
  of the dry run's keys, carried across with ``from_flax``) and is held to
  JAX's same program on the same mesh of 8 devices: the VGG, transformer,
  pipeline (both steps) and QLoRA losses within 1e-5 relative; the VGG,
  transformer and QLoRA params after the step within 1e-5; the gradient
  of every leaf, read off an SGD step (VGG's, and the transformer program
  under ``sgd(1.0)``), within 1e-4 relative; QLoRA's moved/frozen flags
  and its TP int8 ``generate`` tokens equal; and both servers' tokens
  equal JAX's unsharded ``generate`` (the dry run holds its sharded
  servers to exactly those tokens).
- ROADMAP C.18: the dry run's GQA model under {dp: 2, mdl: 4}, where a
  rank's k/v block is half a kv head: the forward's logits (1e-5 of
  flax's), the cross-entropy's gradient of every leaf (1e-4), and a TP
  ``generate`` whose cache holds the rank's one kv head.
- ``entry()`` on the meta device: (8, 1000) logits, nothing computed.
- ``dryrun_multichip`` without a card raises and runs nothing.

The port runs in ONE spawn of 8 torch-only CPU ranks
(tests/torch_mesh_ranks.py; every case in order on every rank); JAX runs
each program jitted on conftest's 8 virtual devices.
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
from torch_mesh_ranks import start

from tpunet.models import VGG as JaxVGG
from tpunet.models import Transformer as JaxTransformer
from tpunet.models import generate as jax_generate
from tpunet.models import (graft_base, lora_apply_updates, lora_optimizer,
                           quantize_params, transformer_partition_rules)
from tpunet.parallel import gpipe as jax_gpipe
from tpunet.parallel import make_mesh as jax_make_mesh
from tpunet.parallel import make_named_mesh as jax_named_mesh
from tpunet.parallel import batch_sharding as jax_batch_sharding
from tpunet.parallel import (replicated, shard_params, stack_stage_params,
                             vgg_partition_rules)
from tpunet.train import TrainState
from tpunet.train import make_train_step as jax_make_train_step
from tpunet.train import synthetic_batch as jax_synthetic_batch
from tpunet_torch import dryrun
from tpunet_torch.models import VGG, Transformer, from_flax
from tpunet_torch.train import sgd as port_sgd

N = 8
LOSS_RTOL, LOGIT_TOL, GRAD_TOL = 1e-5, 1e-5, 1e-4
# The params after a program's step (rtol and atol), and the gradient read
# off an SGD step: relative, and absolute above the f32 rounding of the
# params divided by the learning rate (VGG: up to 1.5e-6 at lr 1e-2).
PARAM_TOL, GRAD_ATOL = 1e-5, 1e-5
C18_MESH = (("dp", 2), ("mdl", 4))
SMALL = dryrun.SMALL
# Blocks that cut heads at mdl 4: q's 24 columns give a rank 6 (a head and
# a half of 4), k's and v's 12 give it 3 (part of a head), and rank 1's q
# heads 1-2 read kv heads 0 and 1 (groups of 2).
CUT = dict(vocab=64, d_model=24, n_layers=1, n_heads=6, n_kv_heads=3,
           d_ff=32)
# Whole q heads that cut kv groups: rank 0's heads 0-2 read kv heads 0, 0,
# 1 (a kv head a q head), and k's 24 columns give a rank one and a half.
UNEVEN = dict(vocab=64, d_model=48, n_layers=1, n_heads=12, n_kv_heads=6,
              d_ff=32)
C18_CFG = {"gqa": SMALL, "cut": CUT, "uneven": UNEVEN}


def _devices():
    return jax.devices()[:N]


def _port(tree, model) -> dict:
    """A flax tree as the port's state_dict of `model`, numpy."""
    return {n: t.numpy() for n, t in from_flax(
        jax.tree.map(np.asarray, tree), model, device="cpu").items()}


def _init(model, rng, sample, tx=None):
    """``model.init``'s params (and, with `tx`, create_train_state's
    TrainState), jitted: the same values as the dry run's eager init."""
    params = jax.jit(model.init)(jax.random.PRNGKey(rng), sample)["params"]
    if tx is None:
        return params
    return TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))


def _placed(tree, mesh, rules):
    return jax.device_put(tree, shard_params(tree, mesh, rules))


def _state_on(state, mesh, rules):
    """The dry run's placement: params by the rules, the rest
    replicated."""
    return TrainState(_placed(state.params, mesh, rules),
                      jax.tree.map(lambda a: jax.device_put(
                          a, replicated(mesh)), state.opt_state),
                      jax.device_put(state.step, replicated(mesh)))


# -- JAX's programs: each yields the port's initial params, then returns
# its numbers -----------------------------------------------------------------


def _jax_vgg():
    mesh = jax_make_mesh(dp=4, mdl=2, devices=_devices())
    model = JaxVGG(cfg=(8, "M", 16, "M"), num_classes=16, hidden=64,
                   compute_dtype=jnp.float32, classifier_dropout=0.0)
    tx = optax.sgd(1e-2, momentum=0.9)
    state = _init(model, 0, jnp.zeros((8, 16, 16, 3)), tx)
    yield _port(state.params, VGG(**dryrun.VGG_CFG,
                                  compute_dtype=torch.float32, device="meta"))
    state = _state_on(state, mesh, vgg_partition_rules())
    imgs, labels = jax_synthetic_batch(np.random.default_rng(0), 8, 16, 16)
    sh = jax_batch_sharding(mesh)
    with mesh:
        state, loss = jax_make_train_step(model, tx)(
            state, jax.device_put(jnp.asarray(imgs), sh),
            jax.device_put(jnp.asarray(labels), sh), jax.random.PRNGKey(1))
    return {"loss": float(loss), "params": _port(
        state.params, VGG(**dryrun.VGG_CFG, compute_dtype=torch.float32,
                          device="meta"))}


def _jax_transformer(sgd: bool = False):
    """The transformer program; `sgd`: under ``optax.sgd(1.0)``, whose
    update is minus the gradient."""
    axes = dryrun.transformer_axes(N)
    mesh = jax_named_mesh(axes, devices=_devices())
    dp, sp = axes["dp"], axes["sp"]
    cfg = dict(dryrun.TRANSFORMER, n_experts=dp, moe_top_k=2)
    model = JaxTransformer(**cfg, compute_dtype=jnp.float32,
                           attn_impl="ring", mesh=mesh, dp_axis="dp",
                           sp_axis="sp", tp_axis="mdl")
    tx = optax.sgd(1.0) if sgd else optax.adam(1e-3)
    batch, seq = 2 * dp, 8 * sp
    state = _init(model, 0, jnp.zeros((batch, seq), jnp.int32), tx)
    tm = Transformer(**cfg, compute_dtype=torch.float32, device="meta")
    yield _port(state.params, tm)
    state = _state_on(state, mesh, transformer_partition_rules(
        tp_axis="mdl", ep_axis="dp"))
    toks = np.random.default_rng(0).integers(0, 64, size=(batch, seq))
    sh = NamedSharding(mesh, JP("dp", "sp"))
    with mesh:
        state, loss = jax_make_train_step(model, tx, accum_steps=2)(
            state, jax.device_put(jnp.asarray(toks, jnp.int32), sh),
            jax.device_put(jnp.asarray(np.roll(toks, -1, 1), jnp.int32), sh),
            jax.random.PRNGKey(1))
    return {"loss": float(loss), "params": _port(state.params, tm)}


def _jax_stage_fn(params, x):
    return x + jax.nn.gelu(x @ params["w1"]) @ params["w2"]


def _jax_pipeline():
    pp, dp = N // 2, 2
    mesh = jax_named_mesh({"pp": pp, "dp": dp}, devices=_devices())
    micro = max(2, pp)
    batch = micro * 2 * dp
    d, ff = dryrun.PIPE_D, dryrun.PIPE_FF

    def stage_init(rng):
        k1, k2 = jax.random.split(rng)
        return {"w1": jax.random.normal(k1, (d, ff)) * 0.1,
                "w2": jax.random.normal(k2, (ff, d)) * 0.1}

    stacked = stack_stage_params([stage_init(jax.random.PRNGKey(s))
                                  for s in range(pp)])
    yield {k: np.asarray(v) for k, v in stacked.items()}
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((batch, d)), jnp.float32)
    y = jnp.asarray(rng.standard_normal((batch, d)), jnp.float32)

    def loss_fn(p):
        out = jax_gpipe(_jax_stage_fn, p, x, mesh, num_microbatches=micro,
                        dp_axis="dp", remat_stages=True)
        return jnp.mean((out - y) ** 2)

    @jax.jit
    def step(p):
        loss, g = jax.value_and_grad(loss_fn)(p)
        return jax.tree.map(lambda w, gw: w - 1e-2 * gw, p, g), loss

    with mesh:
        p2, loss = step(stacked)
        _, loss2 = step(p2)
    return {"losses": [float(loss), float(loss2)]}


def _jax_qlora():
    axes = dryrun._dp_mdl_axes(N)
    mesh = jax_named_mesh(axes, devices=_devices())
    dp = axes["dp"]
    base = JaxTransformer(**SMALL, compute_dtype=jnp.float32)
    toks = jnp.asarray(np.random.default_rng(0).integers(
        0, 64, size=(2 * dp, 12)), jnp.int32)
    base_params = _init(base, 0, toks)
    qbase = quantize_params(base_params)
    qlmodel = base.clone(weight_quant="int8", lora_rank=4)
    qinit = _init(qlmodel, 1, toks)
    tm = Transformer(**SMALL, compute_dtype=torch.float32, device="meta")
    yield {"base": _port(base_params, tm),
           "adapted": _port(qinit, tm.clone(weight_quant="int8", lora_rank=4))}
    rules = transformer_partition_rules(tp_axis="mdl")
    params = _placed(graft_base(qinit, qbase), mesh, rules)
    tx = lora_optimizer(optax.adam(1e-2), params)
    opt_state = tx.init(params)
    sh = NamedSharding(mesh, JP("dp"))

    def loss_fn(p, t, lab):
        logits = qlmodel.apply({"params": p}, t)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, lab).mean()

    @jax.jit
    def step(p, s, t, lab):
        loss, g = jax.value_and_grad(loss_fn, allow_int=True)(p, t, lab)
        updates, s = tx.update(g, s, p)
        return lora_apply_updates(p, updates), s, loss

    with mesh:
        params, _, loss = step(params, opt_state, jax.device_put(toks, sh),
                               jax.device_put(jnp.roll(toks, -1, 1), sh))
    moved = not (np.asarray(params["block0"]["attn"]["q"]["lora_b"])
                 == 0).all()
    frozen = (np.asarray(params["block0"]["attn"]["q"]["base"]["q"])
              == np.asarray(qbase["block0"]["attn"]["q"]["q"])).all()
    trained = _port(params, tm.clone(weight_quant="int8", lora_rank=4))
    qmodel = base.clone(weight_quant="int8")
    with mesh:
        out = jax.jit(lambda p, t: jax_generate(qmodel, p, t, 4))(
            _placed(qbase, mesh, rules), jax.device_put(toks[:, :8], sh))
    return {"loss": float(loss), "moved": bool(moved),
            "frozen": bool(frozen), "tokens": np.asarray(out),
            "params": trained}


def _serve_inputs():
    """The serve program's model, its flax init and the 3 requests."""
    model = JaxTransformer(**SMALL, attn_window=6, compute_dtype=jnp.float32)
    rng = np.random.default_rng(0)
    toks = jnp.asarray(rng.integers(0, 64, size=(1, 12)), jnp.int32)
    params = _init(model, 0, toks)
    requests = [(rng.integers(0, 64, size=k).astype(np.int32), m)
                for k, m in ((8, 6), (8, 9), (10, 4))]
    return model, params, requests


def _jax_serve():
    """The serve program's oracle, JAX's unsharded generate, to which the
    dry run holds both its sharded servers."""
    model, params, requests = _serve_inputs()
    yield _port(params, Transformer(**SMALL, attn_window=6,
                                    compute_dtype=torch.float32,
                                    device="meta"))
    return {"oracle": [np.asarray(jax.jit(
        lambda q, t, m=m: jax_generate(model, q, t, m, temperature=0.0))(
            params, jnp.asarray(p)[None]))[0, len(p):]
        for p, m in requests]}


JAX_PROGRAMS = {"vgg": _jax_vgg, "transformer": _jax_transformer,
                "transformer-sgd": functools.partial(_jax_transformer,
                                                     sgd=True),
                "pipeline": _jax_pipeline, "qlora": _jax_qlora,
                "serve": _jax_serve}
# The port's side of each: (its program, keywords), gathering the params
# after the step where the test holds them to JAX's.
PORT_PROGRAMS = {"vgg": ("vgg", dict(gather=True)),
                 "transformer": ("transformer", dict(gather=True)),
                 "transformer-sgd": ("transformer", dict(gather=True,
                                                         tx=port_sgd(1.0))),
                 "pipeline": ("pipeline", {}),
                 "qlora": ("qlora", dict(gather=True)),
                 "serve": ("serve", {})}


def _finish(gen):
    try:
        next(gen)
    except StopIteration as done:
        return done.value
    raise AssertionError("a JAX program yields its params once")


# -- C.18 ---------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _gqa(name: str = "gqa"):
    """The dry run's GQA model (d 32, 4 heads, 2 kv heads), or CUT or
    UNEVEN: its flax init, 4 prompts of 8 tokens and their labels."""
    cfg = C18_CFG[name]
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 64, (4, 8)).astype(np.int32)
    model = JaxTransformer(**cfg, compute_dtype=jnp.float32)
    params = _init(model, 3, toks)
    tm = Transformer(**cfg, compute_dtype=torch.float32, device="meta")
    return model, params, _port(params, tm), toks, np.roll(toks, -1, 1)


@functools.lru_cache(maxsize=None)
def _run() -> tuple[dict, dict]:
    """(JAX's numbers a program, the ranks' results): the ranks start as
    soon as JAX's inits are known and run while JAX runs its programs."""
    runs = {p: fn() for p, fn in JAX_PROGRAMS.items()}
    inits = {p: next(g) for p, g in runs.items()}
    cases = {p: ("dryrun", dict(program=PORT_PROGRAMS[p][0], n=N,
                                params=inits[p], **PORT_PROGRAMS[p][1]))
             for p in runs}
    for name, cfg in C18_CFG.items():
        _, _, sd, toks, labels = _gqa(name)
        cases[f"c18-model-{name}"] = ("model", dict(
            axes=C18_MESH, impl="reference", cfg=cfg, params=sd,
            tokens=toks, dp_axis=None, tp_axis="mdl"))
        cases[f"c18-grads-{name}"] = ("grads", dict(
            axes=C18_MESH, cfg=cfg, params=sd, tokens=toks, labels=labels))
    _, _, sd, toks, _ = _gqa()
    cases["c18-generate"] = ("generate", dict(axes=C18_MESH, cfg=SMALL,
                                              params=sd, prompt=toks,
                                              max_new=6))
    collect = start(N, cases)
    jax_out = {p: _finish(g) for p, g in runs.items()}
    for p, init in inits.items():
        jax_out[p]["init"] = init
    return jax_out, collect()


def _jax(program: str) -> dict:
    return _run()[0][program]


def _results(name: str) -> list:
    out = []
    for rank, res in sorted(_run()[1].items()):
        assert isinstance(res[name], dict), f"rank {rank}: {res[name]}"
        out.append(res[name])
    return out


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("program", ["vgg", "transformer", "qlora"])
def test_program_loss_matches_jax(program):
    """One step from JAX's init on the same mesh: the global loss within
    1e-5 relative of JAX's, the same on every rank."""
    want = _jax(program)["loss"]
    for got in _results(program):
        assert _rel(got["loss"], want) <= LOSS_RTOL, (got["loss"], want)


@pytest.mark.parametrize("program", ["vgg", "transformer", "qlora"])
def test_program_params_after_the_step_match_jax(program):
    """Every leaf after the step within 1e-5 of JAX's on every rank: the
    VGG program's SGD update, the transformer program's adam update (MoE
    with ring attention, TP and two accumulated microbatches), QLoRA's
    adapters (its int8 leaves bitwise)."""
    want = _jax(program)["params"]
    for got in _results(program):
        assert set(got["params"]) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got["params"][k], w, rtol=PARAM_TOL,
                                       atol=PARAM_TOL, err_msg=k)


@pytest.mark.parametrize("program,lr", [("vgg", 1e-2),
                                        ("transformer-sgd", 1.0)])
def test_program_gradient_matches_jax(program, lr):
    """The gradient of every leaf, (init - after) / lr of an SGD step (the
    VGG program's first momentum step; the transformer program under
    sgd(1.0)), within 1e-4 relative of JAX's. An adam step cannot show a
    gradient's scale; this does: the experts' gradients, replicated over
    sp while dispatched over ep = dp with two accumulated microbatches,
    are far above the tolerance and at JAX's scale."""
    jx = _jax(program)
    init = jx["init"]
    want = {k: (init[k] - v) / lr for k, v in jx["params"].items()}
    if program.startswith("transformer"):
        assert all(np.abs(w).max() > 100 * GRAD_ATOL
                   for k, w in want.items() if ".moe." in k)
    for got in _results(program):
        for k, w in want.items():
            np.testing.assert_allclose((init[k] - got["params"][k]) / lr, w,
                                       rtol=GRAD_TOL, atol=GRAD_ATOL,
                                       err_msg=k)


def test_pipeline_both_steps_match_jax():
    want = _jax("pipeline")["losses"]
    for got in _results("pipeline"):
        assert all(_rel(g, w) <= LOSS_RTOL
                   for g, w in zip(got["losses"], want)), (got, want)
        assert got["losses"][1] < got["losses"][0]


def test_qlora_flags_and_int8_generate_match_jax():
    want = _jax("qlora")
    assert want["moved"] and want["frozen"]
    for got in _results("qlora"):
        assert got["moved"] and got["frozen"]
        assert got["tokens"].shape == (4, 12)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("server", ["server", "spec_server"])
def test_servers_match_jax_tokens(server):
    """Both servers' tokens on every rank equal JAX's unsharded generate,
    to which JAX's dry run holds its sharded servers exactly."""
    want = _jax("serve")["oracle"]
    for got in _results("serve"):
        for a, b in zip(got[server], want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(C18_CFG))
def test_c18_forward_and_gradient_with_half_a_kv_head_a_rank(name):
    """{dp: 2, mdl: 4}, "gqa": the k/v kernels (32, 16) split into 4
    columns a rank, half a kv head; each rank gathers the k/v projections
    over mdl and attends its q head with the kv head it reads. "cut": q's
    block cuts a head too, and a rank's q heads read two kv heads.
    "uneven": a rank's q heads cut kv groups, one kv head a q head."""
    model, params, sd, toks, labels = _gqa(name)

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(toks))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean(), logits

    (loss, logits), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    tm = Transformer(**C18_CFG[name], compute_dtype=torch.float32,
                     device="meta")
    want = _port(g, tm)
    for got in _results(f"c18-model-{name}"):
        np.testing.assert_allclose(got["logits"], np.asarray(logits),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for got in _results(f"c18-grads-{name}"):
        assert _rel(float(got["loss"]), float(loss)) <= LOSS_RTOL
        for k, w in want.items():
            np.testing.assert_allclose(got[f"grad:{k}"], w, atol=GRAD_TOL,
                                       rtol=GRAD_TOL, err_msg=k)


def test_c18_generate_caches_the_ranks_kv_head():
    """TP generate over {dp: 2, mdl: 4}: each rank's cache holds the one
    kv head its q head reads; the tokens are JAX's."""
    model, params, _, toks, _ = _gqa()
    want = np.asarray(jax.jit(lambda p, t: jax_generate(model, p, t, 6))(
        params, jnp.asarray(toks)))
    for got in _results("c18-generate"):
        assert int(got["kv_heads"]) == 1
        np.testing.assert_array_equal(got["tokens"], want)


def test_entry_on_meta_computes_nothing():
    fn, (params, images) = dryrun.entry(device="meta")
    assert tuple(images.shape) == (8, 224, 224, 3)
    out = fn(params, images)
    assert out.device.type == "meta" and tuple(out.shape) == (8, 1000)


def test_dryrun_without_a_card_raises(monkeypatch):
    """device=None means the card: without one it raises before any rank
    starts; it never carries on on the CPU."""
    import multiprocessing

    started = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(multiprocessing.context.SpawnProcess, "start",
                        lambda self: started.append(self))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(N)
    assert started == []
