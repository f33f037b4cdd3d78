"""The port's MoE (tpunet_torch/models/transformer.py's MoeMlp, the
Transformer's n_experts / moe_every / moe_top_k / capacity_factor, the
trainer's auxiliary loss) against the JAX package's, on the CPU.

Tolerances: outputs, aux losses and logits within 1e-5 of flax's (f32,
relative to the largest entry); train steps' losses and params within
1e-5 relative, the bound of tests/test_torch_train.py. Init stds within
5 % of flax's lecun_normal fan-ins. The converter round trip, remat
against no remat, and ZeRO against the replicated step at world 1 are
bitwise.
"""

from __future__ import annotations

import functools
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

from conftest import free_port  # noqa: F401  (pins JAX_PLATFORMS=cpu first)

import jax
import jax.numpy as jnp
import optax
import torch

from tpunet.models import Transformer as JaxTransformer
from tpunet.models import generate as jax_generate
from tpunet.models.transformer import MoeMlp as JaxMoeMlp
from tpunet.train import create_train_state as jax_create_train_state
from tpunet.train import make_train_step as jax_make_train_step
from tpunet_torch.models import (BatchServer, MoeMlp, Transformer, from_flax,
                                 generate, init_params, to_flax)
from tpunet_torch.train import (adamw, create_train_state, make_train_step,
                                sgd)

REPO = Path(__file__).resolve().parent.parent
CFG = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
           n_experts=4)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread is ~10x quicker than a pool
    (restored after the module, so other files keep their setting)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))),
                                             1e-12))


# -- MoeMlp ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_moe(top_k, capacity_factor):
    jm = JaxMoeMlp(4, 48, capacity_factor, jnp.float32, top_k=top_k)
    x = jnp.asarray(np.random.default_rng(top_k).standard_normal(
        (3, 10, 16)).astype(np.float32))
    params = jax.jit(jm.init)(jax.random.PRNGKey(top_k), x)["params"]

    @jax.jit
    def run(params, x):
        y, mut = jm.apply({"params": params}, x, mutable=["intermediates"])
        (aux,) = mut["intermediates"]["moe_aux_loss"]
        return y, aux

    return run, jax.tree.map(np.asarray, params), np.asarray(x)


@pytest.mark.parametrize("top_k,capacity_factor", [(1, 0.5), (2, 0.5),
                                                   (2, 1.25)])
def test_moe_mlp_matches_flax(top_k, capacity_factor):
    """Output and aux loss of one MoeMlp call, with a capacity that drops
    (factor 0.5) and one that keeps more."""
    run, params, x = _jax_moe(top_k, capacity_factor)
    want_y, want_aux = (np.asarray(a) for a in run(params, jnp.asarray(x)))
    moe = MoeMlp(16, 4, 48, capacity_factor, torch.float32, top_k,
                 device="cpu")
    moe.load_state_dict({k: torch.tensor(v) for k, v in params.items()})
    y, aux = moe(torch.tensor(x))
    assert _rel_err(y.detach().numpy(), want_y) <= TOL
    assert abs(aux.item() - float(want_aux)) <= TOL * abs(float(want_aux))
    assert moe.capacity(30) == max(1, int(np.ceil(
        top_k * 30 / 4 * capacity_factor)))
    if capacity_factor < 1:
        assert float(moe.dropped) > 0
        # A dropped choice contributes nothing: some token's row is 0.
        assert (y.abs().sum(-1) == 0).any() or top_k > 1


def test_moe_mlp_refuses_top_k_outside_experts():
    with pytest.raises(ValueError, match="top_k"):
        MoeMlp(16, 4, 48, top_k=5, device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        MoeMlp(16, 4, 48, top_k=0, device="cpu")


# -- the Transformer ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _flax(moe_every, top_k):
    jm = JaxTransformer(compute_dtype=jnp.float32, moe_every=moe_every,
                        moe_top_k=top_k, capacity_factor=1.0, **CFG)
    params = jax.jit(jm.init)(jax.random.PRNGKey(moe_every),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    return jm, jax.tree.map(np.asarray, params)


def _port(moe_every, top_k, **kw):
    return Transformer(compute_dtype=torch.float32, moe_every=moe_every,
                       moe_top_k=top_k, capacity_factor=1.0, device="cpu",
                       **CFG, **kw)


@pytest.mark.parametrize("moe_every,top_k", [(1, 2), (2, 1)])
def test_transformer_logits_and_aux_match_flax(moe_every, top_k):
    jm, tree = _flax(moe_every, top_k)
    toks = np.random.default_rng(5).integers(0, 64, (2, 12)).astype(np.int32)
    apply = jax.jit(functools.partial(jm.apply, mutable=["intermediates"]))
    want, mut = apply({"params": tree}, jnp.asarray(toks))
    want_aux = {jax.tree_util.keystr(p): float(v) for p, v in
                jax.tree_util.tree_leaves_with_path(mut["intermediates"])}
    tm = _port(moe_every, top_k)
    net = tm.bind(from_flax(tree, tm))
    aux = []
    got = net(torch.from_numpy(toks), moe_aux=aux)
    assert _rel_err(got.detach().numpy(), np.asarray(want)) <= TOL
    moe_blocks = [i for i in range(2) if (i + 1) % moe_every == 0]
    assert [tm.get_submodule(f"block{i}").is_moe for i in range(2)] == [
        i in moe_blocks for i in range(2)]
    assert len(aux) == len(want_aux) == len(moe_blocks)
    for a, (path, w) in zip(aux, sorted(want_aux.items())):
        assert abs(float(a) - w) <= TOL * abs(w), path
    assert tm.n_experts == 4 and tm.config()["n_experts"] == 4


def test_converter_round_trip_is_bitwise():
    """router/wi/wo keep flax's layout (never transposed); the whole tree
    comes back bitwise."""
    _, tree = _flax(1, 2)
    tm = _port(1, 2)
    sd = from_flax(tree, tm)
    np.testing.assert_array_equal(sd["block0.moe.wi"].numpy(),
                                  tree["block0"]["moe"]["wi"])
    assert tuple(sd["block1.moe.router"].shape) == (32, 4)
    back = to_flax(sd)
    want = jax.tree_util.tree_leaves_with_path(tree)
    got = jax.tree_util.tree_leaves(back)
    assert len(want) == len(got)
    for (path, w), g in zip(want, got):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), path


def test_init_stds_follow_flax_fan_ins():
    """flax's lecun_normal takes the receptive field into the fan-in: wi
    (e, d, f) has fan-in e·d, wo (e, f, d) e·f, the router (d, e) d."""
    e, d, f = 8, 256, 512
    tm = Transformer(vocab=16, d_model=d, n_layers=2, n_heads=4, d_ff=f,
                     n_experts=e, device="meta")
    p = init_params(tm, seed=0, device="cpu")
    key = jax.random.PRNGKey(0)
    for name, shape, fan in (("block1.moe.wi", (e, d, f), e * d),
                             ("block1.moe.wo", (e, f, d), e * f),
                             ("block1.moe.router", (d, e), d)):
        flax_std = float(jnp.std(jax.nn.initializers.lecun_normal()(
            key, shape)))
        got = float(p[name].std())
        assert tuple(p[name].shape) == shape
        assert abs(got / np.sqrt(1 / fan) - 1) < 0.05, (name, got)
        assert abs(got / flax_std - 1) < 0.05, (name, got, flax_std)
    assert abs(float(p["block0.mlp.up.weight"].std()) / np.sqrt(1 / d)
               - 1) < 0.05


# -- training ----------------------------------------------------------------


def _loss_grads(remat, toks):
    tm = Transformer(compute_dtype=torch.float32, moe_every=1, moe_top_k=2,
                     remat=remat, device="meta", **CFG)
    params = {k: torch.nn.Parameter(v) for k, v in
              init_params(tm, seed=3, device="cpu").items()}
    net = tm.bind(params, trainable=True)
    aux = []
    logits = net(toks, moe_aux=aux)
    loss = logits.logsumexp(-1).mean() + 0.5 * sum(aux)
    return torch.autograd.grad(loss, list(params.values())), list(params)


def test_remat_keeps_aux_loss_and_router_gradient():
    """A checkpointed MoE block hands its aux loss out as an output: the
    gradients, the router's included, are bitwise those without remat."""
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 64, (2, 12)))
    plain, names = _loss_grads(False, toks)
    remat, _ = _loss_grads(True, toks)
    for n, a, b in zip(names, plain, remat):
        assert torch.equal(a, b), n
    router = plain[names.index("block0.moe.router")]
    assert float(router.abs().max()) > 0


def test_train_steps_match_jax():
    """Two sgd steps of an MoE model (moe_every 2, top-2, a capacity
    that drops) through both packages' make_train_step, moe_aux_weight
    0.1, accum_steps=2 (capacity and aux loss per microbatch), the fused
    cross-entropy and remat: losses and params within 1e-5 relative.
    (One JAX step compiles in ~10 s here, so one case carries the three
    options.) (sgd, not adamw: the
    gradients agree within ~1e-6 relative, but adamw's first step divides
    each by |g| + 1e-8, so an entry within float noise of zero turns that
    noise into a whole lr-sized update; sgd keeps the comparison linear.
    The dense steps' adamw parity is tests/test_torch_train.py's.)"""
    kw = dict(accum_steps=2, fused_xent_block=24)
    remat = True
    cfg = dict(CFG, moe_every=2, moe_top_k=2, capacity_factor=0.75)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg["vocab"], (2, 4, 12)).astype(np.int32)
    labels = np.roll(toks, -1, axis=2)
    jm = JaxTransformer(compute_dtype=jnp.float32, remat=remat, **cfg)
    jtx = optax.sgd(0.5)
    jstate, _ = jax_create_train_state(jm, jax.random.PRNGKey(0),
                                       jnp.asarray(toks[0]), jtx)
    jstep = jax_make_train_step(jm, jtx, donate=False, moe_aux_weight=0.1,
                                **kw)
    tm = Transformer(compute_dtype=torch.float32, remat=remat,
                     attn_impl="flash", device="meta", **cfg)
    sd = from_flax(jax.tree.map(np.asarray, jstate.params),
                   Transformer(compute_dtype=torch.float32, device="cpu",
                               **cfg))
    tx = sgd(0.5)
    tstate, _ = create_train_state(tm, 0, None, tx, params=sd, device="cpu")
    tstep = make_train_step(tm, tx, moe_aux_weight=0.1, **kw)
    for i in range(2):
        jstate, jloss = jstep(jstate, jnp.asarray(toks[i]),
                              jnp.asarray(labels[i]), jax.random.PRNGKey(i))
        tstate, tloss = tstep(tstate, toks[i], labels[i], i)
        assert abs(float(tloss) - float(jloss)) <= TOL * abs(float(jloss))
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jstate.params))
    got = jax.tree_util.tree_leaves(to_flax(tstate.params))
    assert len(want) == len(got)
    for (path, w), g in zip(want, got):
        assert _rel_err(g, w) <= TOL, jax.tree_util.keystr(path)


def test_aux_weight_enters_the_loss():
    """moe_aux_weight adds weight × the mean of the blocks' aux losses."""
    tm = Transformer(compute_dtype=torch.float32, moe_every=1, device="meta",
                     **CFG)
    sd = init_params(tm, seed=1, device="cpu")
    toks = np.random.default_rng(2).integers(0, 64, (2, 8)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    losses = {}
    for w in (0.0, 1.0):
        state, _ = create_train_state(tm, 0, None, adamw(1e-3), params=sd,
                                      device="cpu")
        _, losses[w] = make_train_step(tm, moe_aux_weight=w)(
            state, toks, labels)
    aux = []
    tm.bind(sd)(torch.from_numpy(toks).long(), moe_aux=aux)
    want = float(losses[0.0]) + float(sum(aux) / len(aux))
    assert abs(float(losses[1.0]) - want) <= 1e-6


def test_zero_step_matches_replicated_at_world_1():
    """An MoE model through ZeRO-1 at world 1 (the flat-gradient
    reduce-scatter, AdamW on one flat tensor, the all-gather) is bitwise
    the replicated step."""
    from tpunet_torch import distributed
    from tpunet_torch.train import (create_zero_train_state,
                                    make_zero_train_step)

    tm = Transformer(compute_dtype=torch.float32, moe_every=2, moe_top_k=2,
                     device="meta", **CFG)
    sd = init_params(tm, seed=4, device="cpu")
    toks = np.random.default_rng(4).integers(0, 64, (2, 4, 8)).astype(
        np.int32)
    rep, _ = create_train_state(tm, 0, None, adamw(1e-3), params=sd,
                                device="cpu")
    rstep = make_train_step(tm)
    distributed.initialize(f"127.0.0.1:{free_port()}", 0, 1)
    try:
        zst, _ = create_zero_train_state(tm, 0, None, adamw(1e-3), params=sd,
                                         device="cpu")
        zstep = make_zero_train_step(tm)
        for x in toks:
            y = np.roll(x, -1, axis=1)
            rep, rl = rstep(rep, x, y)
            zst, zl = zstep(zst, x, y)
            assert float(rl) == float(zl)
    finally:
        distributed.finalize()
    for k in rep.params:
        assert torch.equal(rep.params[k], zst.params[k]), k


def test_half_batch_reference_uses_the_ranks_objective():
    """chip_smoke's single-process reference builds the ranks' own
    objective, aux term included: its per-half losses equal the train
    step's, and its update is the step's on the mean of the halves'
    gradients."""
    sys.path.insert(0, str(REPO))
    try:
        cs = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(REPO))
    tm = Transformer(compute_dtype=torch.float32, moe_every=1, moe_top_k=2,
                     device="meta", **CFG)
    sd = init_params(tm, seed=6, device="cpu")
    rng = np.random.default_rng(6)
    halves = [(x, np.roll(x, -1, axis=1)) for x in
              rng.integers(0, 64, (2, 2, 8)).astype(np.int32)]
    step = make_train_step(tm, donate=False, moe_aux_weight=0.5)
    state, _ = create_train_state(tm, 0, None, adamw(1e-3), params=sd,
                                  device="cpu")
    want = [float(step(state, x, y)[1]) for x, y in halves]
    ref, _ = create_train_state(tm, 0, None, adamw(1e-3), params=sd,
                                device="cpu")
    old = cs.DEVICE
    cs.DEVICE = "cpu"
    try:
        _, losses = cs._half_batch_reference(
            tm, ref, [[halves[0]], [halves[1]]], moe_aux_weight=0.5)
    finally:
        cs.DEVICE = old
    assert losses == [want]


# -- decoding and refusals ---------------------------------------------------


def test_moe_generate_matches_jax_where_the_margin_allows():
    """Greedy generate of an MoE model (the capacity recomputed per call:
    t = b·p at the prefill, b a step): tokens equal JAX's up to the first
    position whose top-2 logit gap is within 1e-4."""
    jm, tree = _flax(1, 2)
    prompt = np.random.default_rng(9).integers(0, 64, (2, 6)).astype(
        np.int32)
    n = 6
    want = np.asarray(jax.jit(functools.partial(
        jax_generate, jm, max_new_tokens=n))(tree, jnp.asarray(prompt)))
    tm = _port(1, 2)
    got = generate(tm, from_flax(tree, tm), torch.from_numpy(prompt),
                   n).numpy()
    np.testing.assert_array_equal(got[:, :6], prompt)
    logits = np.asarray(jax.jit(jm.apply)({"params": tree},
                                          jnp.asarray(want)))
    checked = 0
    for row in range(2):
        for i in range(n):
            pos = prompt.shape[1] + i
            top2 = np.sort(logits[row, pos - 1])[-2:]
            if top2[1] - top2[0] <= 1e-4:
                break
            assert got[row, pos] == want[row, pos], (row, i)
            checked += 1
    assert checked


def test_moe_refusals():
    with pytest.raises(ValueError, match="MoE"):
        _port(2, 1, weight_quant="int8")
    tm = _port(2, 1)
    sd = init_params(tm, seed=0, device="cpu")
    with pytest.raises(ValueError, match="dense model"):
        BatchServer(tm, sd, slots=2, max_len=16, device="cpu")
    dense = Transformer(compute_dtype=torch.float32, device="cpu",
                        **dict(CFG, n_experts=0))
    with pytest.raises(ValueError, match="draft_model must be dense"):
        BatchServer(dense, init_params(dense, seed=0, device="cpu"),
                    slots=2, max_len=16, draft_model=tm, draft_params=sd,
                    device="cpu")
