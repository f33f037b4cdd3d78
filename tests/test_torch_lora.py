"""The port's LoRA and QLoRA (tpunet_torch/models/lora.py, LoraDense,
Transformer(lora_rank=..., lora_alpha=...), the trainer's integer leaves)
against the JAX package's, on the CPU, mirroring tests/test_lora.py.

Tolerances: logits within 1e-5 of flax's (f32, relative to the largest
entry); merged kernels within 1e-6 relative (A·B is one f32 product in
each package, summed in its own order); a QLoRA train step's loss and
params within 1e-5 relative. Grafting, frozen leaves, int8 leaves through
a checkpoint and the two ranks' params are bitwise.
"""

from __future__ import annotations

import functools
import importlib
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from conftest import free_port

import jax
import jax.numpy as jnp
import optax
import torch

from tpunet.models import Transformer as JaxTransformer
from tpunet.models import graft_base as jax_graft
from tpunet.models import lora_mask as jax_lora_mask
from tpunet.models import lora_optimizer as jax_lora_optimizer
from tpunet.models import merge_lora as jax_merge
from tpunet.models import quantize_params as jax_quantize
from tpunet.train import TrainState as JaxTrainState
from tpunet.train import make_train_step as jax_make_train_step
from tpunet_torch import distributed
from tpunet_torch.collectives import Communicator
from tpunet_torch.models import (LoraDense, Transformer, from_flax,
                                 generate, graft_base, init_params,
                                 lora_mask, lora_optimizer, merge_lora,
                                 quantize_params, to_flax)
from tpunet_torch.train import (adamw, create_train_state, fit,
                                make_train_step, sgd)

REPO = Path(__file__).resolve().parent.parent
CFG = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=64)
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


def _toks(seed=0, shape=(2, 12)):
    return np.random.default_rng(seed).integers(0, 64, shape).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _flax_base():
    jm = JaxTransformer(compute_dtype=jnp.float32, **CFG)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    return jm, jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _flax_adapted(quant: bool, alpha):
    """flax's adapted tree over the base (quantised when `quant`), with
    lora_b set off zero so the adapters contribute."""
    jm, base = _flax_base()
    wq = "int8" if quant else None
    am = jm.clone(weight_quant=wq, lora_rank=4, lora_alpha=alpha)
    init = jax.jit(am.init)(jax.random.PRNGKey(2),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    tree = jax_graft(init, jax_quantize(base) if quant else base)
    rng = np.random.default_rng(3)
    tree = jax.tree.map(
        lambda leaf, m: (rng.standard_normal(leaf.shape).astype(np.float32)
                         * 0.05 if m else np.asarray(leaf)),
        tree, jax_lora_mask(tree))
    return am, tree


def _port(**kw):
    return Transformer(compute_dtype=torch.float32, device="cpu", **CFG,
                       **kw)


def test_graft_is_the_identity_bitwise():
    """B = 0 at init, so the grafted adapted model's logits are bitwise
    the base model's; graft_base takes every non-adapter leaf from the
    base and the adapters from the adapted init."""
    base = _port()
    bsd = init_params(base, seed=0, device="cpu")
    am = _port(lora_rank=4)
    init = init_params(am, seed=1, device="cpu")
    sd = graft_base(init, bsd)
    assert set(sd) == set(init)
    assert sd["block0.attn.q.base.weight"] is bsd["block0.attn.q.weight"]
    assert sd["embed"] is bsd["embed"]
    assert sd["block0.attn.q.lora_a"] is init["block0.attn.q.lora_a"]
    assert tuple(sd["block0.attn.q.lora_b"].shape) == (4, 32)
    assert not sd["lm_head.lora_b"].any()
    toks = torch.from_numpy(_toks()).long()
    assert torch.equal(am.bind(sd)(toks), base.bind(bsd)(toks))
    with pytest.raises(ValueError, match="tree mismatch"):
        graft_base(init, {k: v for k, v in bsd.items() if k != "embed"})
    # LoraDense is the dense layer of every projection, lm_head included.
    for m in ("block1.attn.out", "block1.mlp.up", "block1.mlp.down",
              "lm_head"):
        assert isinstance(am.get_submodule(m), LoraDense)


@pytest.mark.parametrize("quant,alpha", [(False, 8.0), (True, None)])
def test_adapted_logits_match_flax(quant, alpha):
    """LoRA (alpha 8 on rank 4: scale 2) and QLoRA (an int8 base, alpha
    None: scale 1) logits within 1e-5 of flax's, the converter round trip
    bitwise, and the masks equal."""
    am, tree = _flax_adapted(quant, alpha)
    toks = _toks(4)
    want = np.asarray(jax.jit(am.apply)({"params": tree}, jnp.asarray(toks)))
    tm = _port(weight_quant="int8" if quant else None, lora_rank=4,
               lora_alpha=alpha)
    sd = from_flax(tree, tm)
    if quant:
        assert sd["block0.attn.q.base.q"].dtype == torch.int8
    got = tm.bind(sd)(torch.from_numpy(toks).long()).detach().numpy()
    assert _rel_err(got, want) <= TOL
    back = dict(jax.tree_util.tree_leaves_with_path(to_flax(sd)))
    for path, w in jax.tree_util.tree_leaves_with_path(tree):
        g = back[path]
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), path
    mask = {jax.tree_util.keystr(p): m for p, m in
            jax.tree_util.tree_leaves_with_path(jax_lora_mask(tree))}
    got_mask = {"".join(f"['{'kernel' if p == 'weight' else p}']"
                        for p in k.split(".")): m
                for k, m in lora_mask(sd).items()}
    assert got_mask == mask and sum(mask.values()) == 2 * 13


def test_merge_lora_matches_jax_and_refuses_int8():
    am, tree = _flax_adapted(False, 8.0)
    want = jax.tree.map(np.asarray, jax_merge(tree, alpha=8.0))
    tm = _port(lora_rank=4, lora_alpha=8.0)
    sd = from_flax(tree, tm)
    merged = merge_lora(sd, alpha=8.0)
    plain = _port()
    assert set(merged) == {n for n, _ in plain.named_parameters()}
    back = dict(jax.tree_util.tree_leaves_with_path(to_flax(merged)))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        assert _rel_err(back[path], w) <= 1e-6, path
    toks = torch.from_numpy(_toks(5)).long()
    assert _rel_err(plain.bind(merged)(toks).detach().numpy(),
                    tm.bind(sd)(toks).detach().numpy()) <= TOL
    _, qtree = _flax_adapted(True, None)
    qsd = from_flax(qtree, _port(weight_quant="int8", lora_rank=4))
    with pytest.raises(ValueError, match="fp base"):
        merge_lora(qsd)


def test_masked_training_moves_only_the_adapters():
    """lora_optimizer(adamw): the loss falls, every lora_b moves off zero,
    and every other leaf (embed, norms, the fp base) is bitwise frozen,
    though it gets a gradient (weight decay touches none of them)."""
    base = _port()
    am = _port(lora_rank=4)
    sd = graft_base(init_params(am, seed=1, device="cpu"),
                    init_params(base, seed=0, device="cpu"))
    before = {k: v.clone() for k, v in sd.items()}
    tx = lora_optimizer(adamw(5e-3), sd)
    state, _ = create_train_state(am, 0, None, tx, params=sd, device="cpu")
    assert len(state.opt_state.param_groups[0]["params"]) == 2 * 13
    step = make_train_step(am)
    toks = _toks(6, (4, 12))
    losses = []
    for _ in range(6):
        state, loss = step(state, toks, np.roll(toks, -1, axis=1))
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    for k, v in state.params.items():
        if lora_mask(sd)[k]:
            assert k.endswith(".lora_a") or v.abs().max() > 0, k
        else:
            assert torch.equal(v.detach(), before[k]), k
    with pytest.raises(ValueError, match="lora"):
        lora_optimizer(adamw(1e-3), base.state_dict())


def test_create_train_state_keeps_integer_leaves():
    """An int8 model's train state keeps its int8 leaves int8 and frozen
    (not f32 master weights), and a step leaves them as they were."""
    qm = _port(weight_quant="int8")
    sd = quantize_params(init_params(_port(), seed=0, device="cpu"))
    state, net = create_train_state(qm, 0, None, sgd(0.1), params=sd,
                                    device="cpu")
    q = state.params["lm_head.q"]
    assert q.dtype == torch.int8 and not q.requires_grad
    assert torch.equal(q, sd["lm_head.q"])
    assert state.params["lm_head.scale"].requires_grad
    assert net.lm_head.q is q
    toks = _toks(2, (2, 8))
    state, _ = make_train_step(qm)(state, toks, np.roll(toks, -1, axis=1))
    assert torch.equal(state.params["lm_head.q"], sd["lm_head.q"])
    assert not torch.equal(state.params["lm_head.scale"],
                           sd["lm_head.scale"])


def _qlora(seed=0):
    """(model, state_dict): the base quantised and grafted under
    weight_quant="int8", lora_rank=4."""
    base = _port()
    qm = _port(weight_quant="int8", lora_rank=4)
    sd = graft_base(init_params(qm, seed=seed + 1, device="cpu"),
                    quantize_params(init_params(base, seed=seed,
                                                device="cpu")))
    return qm, sd


def test_qlora_train_step_matches_jax():
    """One QLoRA step (int8 base, fp adapters) through both packages'
    make_train_step with lora_optimizer(sgd): the loss and every leaf
    within 1e-5 relative, the int8 leaves int8 and bitwise unchanged (JAX
    passes their float0 gradients through; the port takes no gradient of
    an integer leaf). sgd keeps the comparison linear in the gradients
    (see tests/test_torch_moe.py)."""
    am, tree = _flax_adapted(True, None)
    toks = _toks(7, (4, 12))
    labels = np.roll(toks, -1, axis=1)
    jtx = jax_lora_optimizer(optax.sgd(0.5), tree)
    jstate = JaxTrainState(tree, jtx.init(tree), jnp.zeros((), jnp.int32))
    jstate, jloss = jax_make_train_step(am, jtx, donate=False)(
        jstate, jnp.asarray(toks), jnp.asarray(labels),
        jax.random.PRNGKey(0))
    tm = _port(weight_quant="int8", lora_rank=4)
    sd = from_flax(tree, tm)
    state, _ = create_train_state(tm, 0, None,
                                  lora_optimizer(sgd(0.5), sd), params=sd,
                                  device="cpu")
    q0 = state.params["block0.attn.q.base.q"].clone()
    state, loss = make_train_step(tm)(state, toks, labels)
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    q = state.params["block0.attn.q.base.q"]
    assert q.dtype == torch.int8 and not q.requires_grad
    assert torch.equal(q, q0)
    back = dict(jax.tree_util.tree_leaves_with_path(to_flax(state.params)))
    for path, w in jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, jstate.params)):
        assert back[path].dtype == w.dtype, path
        assert _rel_err(back[path], w) <= TOL, jax.tree_util.keystr(path)


def test_qlora_fit_and_checkpoint_keep_int8(tmp_path):
    """fit() with lora_optimizer and a checkpoint directory, then a resume
    into a fresh state: the int8 leaves come back int8 and frozen, the
    adapters and the optimizer state bitwise, and training goes on (the
    JAX package's test_lora_with_fit_and_checkpoint)."""
    qm, sd = _qlora()
    tx = lora_optimizer(adamw(5e-3), sd)
    toks = _toks(8, (2, 12))

    def batches():
        while True:
            yield toks, np.roll(toks, -1, axis=1)

    state, _ = create_train_state(qm, 0, None, tx, params=sd, device="cpu")
    q0 = state.params["block1.mlp.up.base.q"].clone()
    step = make_train_step(qm, accum_steps=2)
    ckpt = str(tmp_path / "ckpt")
    state = fit(state, step, batches(), steps=4, checkpoint_dir=ckpt,
                checkpoint_every=2)
    assert torch.equal(state.params["block1.mlp.up.base.q"], q0)
    trained_b = state.params["block0.attn.q.lora_b"].detach().clone()
    assert trained_b.abs().max() > 0
    _, fresh_sd = _qlora(seed=5)
    fresh, _ = create_train_state(qm, 0, None, tx, params=fresh_sd,
                                  device="cpu")
    resumed = fit(fresh, step, batches(), steps=4, checkpoint_dir=ckpt)
    assert resumed.step == 4
    q = resumed.params["block1.mlp.up.base.q"]
    assert q.dtype == torch.int8 and not q.requires_grad
    assert torch.equal(q, q0)
    assert torch.equal(resumed.params["block0.attn.q.lora_b"], trained_b)
    assert len(resumed.opt_state.param_groups[0]["params"]) == 2 * 13
    more = fit(resumed, step, batches(), steps=5)
    assert not torch.equal(more.params["block0.attn.q.lora_b"], trained_b)


def test_guards():
    """features_only refuses lora_rank (JAX's message); ZeRO-1 refuses an
    int8 base as the JAX step does (both raise ValueError)."""
    from tpunet import distributed as jax_distributed
    from tpunet.train import make_zero_train_step as jax_zero_step
    from tpunet_torch.train import create_zero_train_state

    am = _port(lora_rank=4)
    asd = init_params(am, seed=0, device="cpu")
    with pytest.raises(ValueError, match="lora_rank is incompatible"):
        am.bind(asd)(torch.zeros(1, 4, dtype=torch.long),
                     features_only=True)
    with pytest.raises(ValueError, match="lora_rank is incompatible"):
        make_train_step(am, fused_xent_block=16)(
            create_train_state(am, 0, None, adamw(1e-3), params=asd,
                               device="cpu")[0], _toks(), _toks())
    qm, sd = _qlora()
    distributed.initialize(f"127.0.0.1:{free_port()}", 0, 1)
    try:
        with pytest.raises(ValueError, match="ZeRO-1 needs floating"):
            create_zero_train_state(qm, 0, None, adamw(1e-3), params=sd,
                                    device="cpu")
    finally:
        distributed.finalize()
    # JAX's step fails at its flat gradient vector (float0 leaves have no
    # promotion), before it reads the optimizer state.
    am, tree = _flax_adapted(True, None)
    jax_distributed.initialize(f"127.0.0.1:{free_port()}", 0, 1)
    try:
        x = jnp.zeros((1, 8), jnp.int32)
        jstate = JaxTrainState(tree, optax.sgd(0.1).init(jnp.zeros(1)),
                               jnp.zeros((), jnp.int32))
        with pytest.raises(ValueError):
            jax_zero_step(am, optax.sgd(0.1))(jstate, x, x,
                                              jax.random.PRNGKey(0))
    finally:
        jax_distributed.finalize()


def test_adapted_generate_runs_and_matches_the_base_at_b0():
    """generate with a grafted QLoRA model (B = 0) gives the int8 base
    model's tokens; with trained adapters it runs to a full sequence."""
    qm, sd = _qlora()
    base = _port(weight_quant="int8")
    bsd = {k.replace(".base.", "."): v for k, v in sd.items()
           if "lora_" not in k}
    prompt = torch.from_numpy(_toks(9, (2, 6))).long()
    want = generate(base, bsd, prompt, 5)
    assert torch.equal(generate(qm, sd, prompt, 5), want)
    sd = {k: (torch.full_like(v, 0.05) if k.endswith("lora_b") else v)
          for k, v in sd.items()}
    out = generate(qm, sd, prompt, 5)
    assert out.shape == (2, 11) and int(out.max()) < 64


def _rank_thread(rank, world, port, batches, box, comms):
    """One data-parallel QLoRA rank on this thread, with its own
    communicator standing in for the process-global one."""
    try:
        comm = Communicator(f"127.0.0.1:{port}", rank, world)
        comms.comm = comm
        qm, sd = _qlora()
        state, _ = create_train_state(qm, 0, None,
                                      lora_optimizer(adamw(5e-3), sd),
                                      params=sd, device="cpu")
        step = make_train_step(qm, cross_host=True)
        losses = []
        for x, y in batches:
            state, loss = step(state, x, y)
            losses.append(float(loss))
        comm.close()
        box[rank] = (state.params, losses)
    except Exception as e:  # noqa: BLE001 — reported to the test
        box[rank] = e


def test_two_rank_qlora_step_is_bitwise(monkeypatch):
    """Two data-parallel QLoRA ranks (threads of this process, each with
    its own loopback communicator): the ranks' params are bitwise equal
    to each other and to one process applying the mean of the two
    half-batch gradients (chip_smoke's reference), with the same losses;
    the int8 leaves never enter the all-reduce."""
    comms = threading.local()
    monkeypatch.setattr(distributed, "global_communicator",
                        lambda: comms.comm)
    monkeypatch.setattr(distributed, "is_initialized", lambda: True)
    rank_batches = [[(x, np.roll(x, -1, axis=1))
                     for x in _toks(10 + r, (2, 2, 12))] for r in range(2)]
    port, box = free_port(), {}
    threads = [threading.Thread(target=_rank_thread,
                                args=(r, 2, port, rank_batches[r], box,
                                      comms)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for r in range(2):
        assert not isinstance(box.get(r), Exception), box.get(r)
    (p0, l0), (p1, l1) = box[0], box[1]
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    sys.path.insert(0, str(REPO))
    try:
        cs = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(REPO))
    qm, sd = _qlora()
    ref, _ = create_train_state(qm, 0, None,
                                lora_optimizer(adamw(5e-3), sd), params=sd,
                                device="cpu")
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    _, ref_losses = cs._half_batch_reference(qm, ref, rank_batches)
    for k in p0:
        assert torch.equal(p0[k], ref.params[k]), k
    assert [l0, l1] == [list(x) for x in zip(*ref_losses)]
