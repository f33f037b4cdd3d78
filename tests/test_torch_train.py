"""The port's training slice against the JAX package, on the CPU.

- ``blockwise_cross_entropy``: values and gradients against the JAX
  version (negative labels wrap, labels >= V give NaN);
- a 2-layer d64 Transformer takes 3 adamw steps through the port's
  ``make_train_step`` and the JAX ``make_train_step`` from the same flax
  init and batch: losses and ``to_flax`` params within 1e-5 relative, with
  remat off and on, ``accum_steps=2``, z-loss and the fused cross-entropy;
- checkpoints, ``fit`` (schedule, resume, cadence) and the data pipeline
  (``token_batches`` equals the JAX package's, ``prefetch_to_device`` on the
  CPU).
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import pytest

from conftest import free_port  # noqa: F401  (pins JAX_PLATFORMS=cpu first)

import jax
import jax.numpy as jnp
import optax
import torch

from tpunet.data import TokenDataset as JaxTokenDataset
from tpunet.data import token_batches as jax_token_batches
from tpunet.models import Transformer as JaxTransformer
from tpunet.ops import blockwise_cross_entropy as jax_blockwise_xent
from tpunet.train import create_train_state as jax_create_train_state
from tpunet.train import make_train_step as jax_make_train_step
from tpunet_torch.data import (TokenDataset, pack_documents,
                               prefetch_to_device, token_batches)
from tpunet_torch.models import Transformer, from_flax, to_flax
from tpunet_torch.ops import blockwise_cross_entropy
from tpunet_torch.train import (CheckpointManager, StepAlreadyExistsError,
                                adamw, create_train_state, fit,
                                make_train_step)

CFG = dict(vocab=64, d_model=64, n_layers=2, n_heads=4, d_ff=128)
SMALL = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64)


# -- fused cross-entropy -----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_xent(block):
    def f(feats, kernel, labels):
        def loss(feats, kernel):
            nll, lse = jax_blockwise_xent(feats, kernel, labels,
                                          block_vocab=block, return_lse=True)
            return jnp.nansum(nll) + 0.1 * jnp.sum(lse), (nll, lse)
        return jax.grad(loss, argnums=(0, 1), has_aux=True)(feats, kernel)
    return jax.jit(f)


@pytest.mark.parametrize("block", [7, 16, 50])
def test_blockwise_xent_values_and_grads_match_jax(block):
    rng = np.random.default_rng(block)
    feats = rng.standard_normal((12, 16)).astype(np.float32)
    kernel = (rng.standard_normal((16, 50)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 50, 12).astype(np.int32)
    labels[:3] = [-1, -50, 50]  # wrap, wrap to 0, out of range -> NaN
    (jg_feats, jg_kernel), (jnll, jlse) = _jax_xent(block)(
        jnp.asarray(feats), jnp.asarray(kernel), jnp.asarray(labels))
    tf = torch.from_numpy(feats).requires_grad_()
    tk = torch.from_numpy(kernel).requires_grad_()
    nll, lse = blockwise_cross_entropy(tf, tk, torch.from_numpy(labels),
                                       block_vocab=block, return_lse=True)
    assert torch.isnan(nll[2]) and not torch.isnan(nll[:2]).any()
    g_feats, g_kernel = torch.autograd.grad(
        torch.nansum(nll) + 0.1 * lse.sum(), (tf, tk))
    for got, want in ((nll, jnll), (lse, jlse), (g_feats, jg_feats),
                      (g_kernel, jg_kernel)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def test_blockwise_xent_matches_full_logits_bf16_feats():
    rng = np.random.default_rng(3)
    feats = torch.from_numpy(rng.standard_normal((9, 8)).astype(
        np.float32)).to(torch.bfloat16)
    kernel = torch.from_numpy(rng.standard_normal((8, 30)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 30, 9))
    got = blockwise_cross_entropy(feats, kernel, labels, block_vocab=8)
    logits = feats.float() @ kernel.to(torch.bfloat16).float()
    want = torch.nn.functional.cross_entropy(logits, labels, reduction="none")
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="labels shape"):
        blockwise_cross_entropy(feats, kernel, labels[:4])


# -- the train step against JAX ---------------------------------------------


def _rel_err(a, b) -> float:
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-12))


TRAIN_CASES = {
    "default": dict(),
    "remat": dict(remat=True),
    "accum2": dict(accum_steps=2),
    "z_loss": dict(z_loss=1e-3),
    "fused_xent": dict(fused_xent_block=24),
    "fused_xent_z_loss_remat": dict(fused_xent_block=24, z_loss=1e-3,
                                    remat=True),
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_steps_match_jax(case):
    kw = dict(TRAIN_CASES[case])
    remat = kw.pop("remat", False)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, CFG["vocab"], (3, 4, 16)).astype(np.int32)
    labels = np.roll(toks, -1, axis=2)

    jm = JaxTransformer(compute_dtype=jnp.float32, remat=remat, **CFG)
    jtx = optax.adamw(3e-4)
    jstate, _ = jax_create_train_state(jm, jax.random.PRNGKey(0),
                                       jnp.asarray(toks[0]), jtx)
    jstep = jax_make_train_step(jm, jtx, donate=False, **kw)

    tm = Transformer(compute_dtype=torch.float32, remat=remat,
                     attn_impl="flash", device="meta", **CFG)
    sd = from_flax(jax.tree.map(np.asarray, jstate.params),
                   Transformer(compute_dtype=torch.float32, device="cpu",
                               **CFG))
    tx = adamw(3e-4)
    tstate, _ = create_train_state(tm, 0, torch.from_numpy(toks[0]), tx,
                                   params=sd)
    tstep = make_train_step(tm, tx, **kw)
    for i in range(3):
        jstate, jloss = jstep(jstate, jnp.asarray(toks[i]),
                              jnp.asarray(labels[i]), jax.random.PRNGKey(i))
        tstate, tloss = tstep(tstate, toks[i], labels[i], i)
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert tstate.step == 3
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jstate.params))
    got = jax.tree_util.tree_leaves(to_flax(tstate.params))
    assert len(want) == len(got)
    for (path, w), g in zip(want, got):
        assert _rel_err(g, w) <= 1e-5, jax.tree_util.keystr(path)


def test_remat_keeps_the_gradients_and_rejects_policies():
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, 64, (2, 12)))
    grads = []
    for remat in (False, True):
        m = Transformer(compute_dtype=torch.float32, remat=remat,
                        attn_impl="flash", device="meta", **SMALL)
        state, net = create_train_state(m, 5, toks, adamw(1e-3))
        loss = net(toks, train=True).logsumexp(-1).mean()
        grads.append(torch.autograd.grad(loss, list(state.params.values())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    with pytest.raises(NotImplementedError, match="remat_policy"):
        Transformer(device="meta", remat=True, remat_policy="dots", **SMALL)
    with pytest.raises(ValueError, match="remat_policy"):
        Transformer(device="meta", remat_policy="bogus", **SMALL)


def test_adamw_keeps_optax_defaults_and_bind_trainable():
    m = Transformer(compute_dtype=torch.float32, device="meta", **SMALL)
    state, net = create_train_state(m, 0, torch.zeros(1, 4, dtype=torch.long),
                                    adamw(2e-3))
    (group,) = state.opt_state.param_groups
    assert group["weight_decay"] == 1e-4 and group["eps"] == 1e-8
    assert group["betas"] == (0.9, 0.999) and group["lr"] == 2e-3
    assert len(group["params"]) == len(state.params)
    # The bound module's parameters are the state's tensors themselves.
    for name, p in net.named_parameters():
        assert p is state.params[name] and p.requires_grad
        assert p.dtype == torch.float32
    with pytest.raises(TypeError, match="nn.Parameter"):
        m.bind({k: t.detach() for k, t in state.params.items()},
               trainable=True)


def test_donate_false_leaves_the_callers_state():
    m = Transformer(compute_dtype=torch.float32, device="meta", **SMALL)
    toks = np.random.default_rng(2).integers(0, 64, (2, 8))
    state, _ = create_train_state(m, 0, torch.from_numpy(toks), adamw(1e-2))
    before = {k: t.detach().clone() for k, t in state.params.items()}
    new, _ = make_train_step(m, donate=False)(state, toks, np.roll(toks, -1),
                                              0)
    assert state.step == 0 and new.step == 1
    for k, t in state.params.items():
        assert torch.equal(t, before[k])
    assert any(not torch.equal(new.params[k], before[k]) for k in before)


# -- checkpoints, fit, data ---------------------------------------------------


@pytest.fixture()
def setup(tmp_path):
    path = str(tmp_path / "toks.bin")
    rng = np.random.default_rng(0)
    pack_documents(iter([rng.integers(0, 64, 600).tolist()]), path, vocab=64)
    ds = TokenDataset(path, seq=16, vocab=64)
    model = Transformer(compute_dtype=torch.float32, device="meta", **SMALL)
    tx = adamw(1e-3)
    first, _ = next(token_batches(ds, batch=4, seed=0))
    state, _ = create_train_state(model, 0, torch.from_numpy(first), tx)
    step = make_train_step(model, tx, donate=False)
    return ds, state, step, path


def _batches(ds):
    return token_batches(ds, batch=4, seed=0)


def _same_params(a, b):
    return all(torch.equal(a.params[k], b.params[k]) for k in a.params)


def test_checkpoint_save_restore_retention(setup, tmp_path):
    ds, state, step, _ = setup
    state, _ = step(state, *next(_batches(ds)), 0)
    mgr = CheckpointManager(tmp_path / "ck", max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(s, state)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    with pytest.raises(StepAlreadyExistsError):
        mgr.save(3, state)
    assert mgr.save(3, state, force=True)
    fresh, _ = create_train_state(
        Transformer(compute_dtype=torch.float32, device="meta", **SMALL), 9,
        torch.zeros(1, 4, dtype=torch.long), adamw(1e-3))
    back = mgr.restore_latest(fresh)
    assert back.step == 1 and _same_params(back, state)
    assert not _same_params(fresh, state)  # the target is not modified
    # The optimizer state (moments, step counts) came back too: the next
    # step from the restored state equals the next step from the original.
    x, y = next(itertools.islice(_batches(ds), 1, None))
    a, _ = step(state, x, y, 1)
    b, _ = step(back, x, y, 1)
    assert _same_params(a, b)
    assert not list((tmp_path / "ck").glob(".*.tmp"))
    assert CheckpointManager(tmp_path / "empty").restore_latest(fresh) is None


def test_fit_schedule_cadence_and_exact_resume(setup, tmp_path):
    ds, state, step, _ = setup
    ck = str(tmp_path / "ck")
    straight = fit(state, step, _batches(ds), steps=6)
    assert straight.step == 6
    mid = fit(state, step, _batches(ds), steps=3, checkpoint_dir=ck,
              checkpoint_every=2)
    assert mid.step == 3
    assert CheckpointManager(ck).all_steps() == [2, 3]
    resumed = fit(state, step, _batches(ds), steps=6, checkpoint_dir=ck,
                  skip_batches_on_resume=True)
    assert resumed.step == 6 and _same_params(resumed, straight)
    # A state ahead of the checkpoint is not rolled back.
    again = fit(resumed, step, _batches(ds), steps=6, checkpoint_dir=ck)
    assert again.step == 6


def test_fit_logs_evals_prefetch_and_exhaustion(setup, tmp_path):
    ds, state, step, _ = setup
    seen = []
    out = fit(state, step, _batches(ds), steps=7, log_every=2, eval_every=3,
              eval_fn=lambda st: {"seen_step": st.step}, log_fn=seen.append,
              prefetch=2, prefetch_device="cpu")
    assert out.step == 7
    assert [m["step"] for m in seen if "loss" in m] == [2, 4, 6]
    assert all(np.isfinite(m["loss"]) for m in seen if "loss" in m)
    evals = [m for m in seen if "eval" in m]
    assert [m["step"] for m in evals] == [3, 6, 7]
    assert all(m["eval"]["seen_step"] == m["step"] for m in evals)
    few = list(itertools.islice(_batches(ds), 2))
    assert fit(state, step, iter(few), steps=100).step == 2
    with pytest.warns(UserWarning, match="0 steps"):
        zero = fit(state, step, iter([]), steps=5,
                   checkpoint_dir=str(tmp_path / "ck0"))
    assert zero.step == 0
    assert CheckpointManager(tmp_path / "ck0").latest_step() == 0


@pytest.mark.parametrize("world", [1, 2])
def test_token_batches_match_jax(setup, world):
    _, _, _, path = setup
    ds = TokenDataset(path, seq=16, vocab=64)
    jds = JaxTokenDataset(path, seq=16, vocab=64)
    for rank in range(world):
        got = itertools.islice(token_batches(ds, batch=2, seed=3, rank=rank,
                                             world=world), 40)
        want = itertools.islice(jax_token_batches(jds, batch=2, seed=3,
                                                  rank=rank, world=world), 40)
        for (x, y), (jx, jy) in zip(got, want):
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)


def test_prefetch_to_device_on_cpu():
    src = [(np.full((2, 3), i, np.int32), {"y": np.arange(i, i + 2)})
           for i in range(5)]
    out = list(prefetch_to_device(iter(src), size=2, device="cpu"))
    assert len(out) == 5
    for i, (x, d) in enumerate(out):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        assert torch.equal(x, torch.full((2, 3), i, dtype=torch.int32))
        assert d["y"].tolist() == [i, i + 1]

    def broken():
        yield np.zeros(2)
        raise OSError("disk gone")

    it = prefetch_to_device(broken(), device="cpu")
    next(it)
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    with pytest.raises(ValueError):
        next(prefetch_to_device(iter(src), size=0, device="cpu"))
