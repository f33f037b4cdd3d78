"""The port's flash-attention gradients against the JAX package's custom
VJP, on the same inputs and cotangent.

On the CPU the port's backward runs the plain versions of its dQ and dK/dV
kernels (`flash_attention_dq_plain`, `flash_attention_dkv_plain`) through
its `torch.autograd.Function`; the JAX side runs `jax.vjp` of its
`flash_attention` with 8-row tiles, i.e. the Pallas `_flash_dq_kernel` and
`_flash_dkv_kernel` in interpret mode (or its einsum fallback where the JAX
wrapper takes it: ragged lengths). Tolerances are those of
tests/test_ops.py's gradient tests: 5e-5 in f32, 1e-1 in bf16. The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

from conftest import free_port  # noqa: F401  (pins JAX_PLATFORMS=cpu first)

import jax
import jax.numpy as jnp
import torch

from tpunet.ops.flash_attention import flash_attention as jax_flash
from tpunet_torch.ops.flash_attention import (attention_delta,
                                              flash_attention,
                                              flash_attention_dkv_plain,
                                              flash_attention_dq_plain,
                                              flash_attention_fwd)


def _inputs(seed, b, sq, sk, h, hk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in (
        (b, sq, h, d), (b, sk, hk, d), (b, sk, hk, d), (b, sq, h, d)))


@functools.lru_cache(maxsize=None)
def _jax_vjp(causal, window, dtype):
    def f(q, k, v, g):
        o, vjp = jax.vjp(lambda q, k, v: jax_flash(
            q, k, v, causal, block_q=8, block_k=8, window=window), q, k, v)
        return (o, *vjp(g))
    del dtype  # part of the cache key: one jit per input dtype
    return jax.jit(f)


def _grads_both(q, k, v, g, causal, window, jdtype, tdtype):
    """[o, dq, dk, dv] of the JAX package and of the port, as f32 numpy."""
    want = _jax_vjp(causal, window, str(jdtype))(
        *(jnp.asarray(x, jdtype) for x in (q, k, v, g)))
    ts = [torch.from_numpy(x).to(tdtype).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*ts, causal, window=window)
    got = torch.autograd.grad(out, ts, torch.from_numpy(g).to(tdtype))
    return ([np.asarray(w, np.float32) for w in want],
            [x.detach().float().numpy() for x in (out, *got)])


CASES = (
    [(False, grp, None, s) for grp in (1, 2, 4) for s in (32, 37)]
    + [(True, grp, w, s) for grp in (1, 2, 4) for w in (None, 3)
       for s in (32, 37)]
)


@pytest.mark.parametrize("causal,group,window,seq", CASES)
def test_flash_grads_match_jax(causal, group, window, seq):
    h = 4
    q, k, v, g = _inputs(seq * 10 + group, 2, seq, seq, h, h // group, 8)
    want, got = _grads_both(q, k, v, g, causal, window, jnp.float32,
                            torch.float32)
    for w, x in zip(want, got):
        np.testing.assert_allclose(x, w, atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("causal,group", [(True, 2), (False, 1)])
def test_flash_grads_bf16_match_jax(causal, group):
    q, k, v, g = _inputs(17 + group, 1, 32, 32, 4, 4 // group, 16)
    want, got = _grads_both(q, k, v, g, causal, None, jnp.bfloat16,
                            torch.bfloat16)
    for w, x in zip(want, got):
        np.testing.assert_allclose(x, w, atol=1e-1, rtol=1e-1)


# (sq, sk, causal, window, group, dtype). Non-causal Sq != Sk: the JAX
# wrapper tiles these in its kernels. Causal with a window and
# Sq > Sk + window: queries at qpos >= Sk + window - 1 see no key; the JAX
# wrapper takes its einsum path (causal Sq != Sk), whose softmax over
# all-NEG_INF scores averages V over every key, gives such rows dQ = 0, and
# gives each key dV += dO/Sk from them and no dK.
CROSS_CASES = [
    pytest.param(24, 40, False, None, 2, "float32", id="24-40"),
    pytest.param(40, 24, False, None, 2, "float32", id="40-24"),
    pytest.param(20, 12, True, 2, 1, "float32", id="no-key-w2-g1-f32"),
    pytest.param(20, 12, True, 3, 2, "float32", id="no-key-w3-g2-f32"),
    pytest.param(21, 9, True, 3, 1, "bfloat16", id="no-key-w3-g1-bf16"),
    pytest.param(20, 12, True, 2, 2, "bfloat16", id="no-key-w2-g2-bf16"),
]
TOLS = {"float32": 5e-5, "bfloat16": 1e-1}


@pytest.mark.parametrize("sq,sk,causal,window,group,dtype", CROSS_CASES)
def test_flash_grads_cross_lengths_match_jax(sq, sk, causal, window, group,
                                             dtype):
    """o, dQ, dK and dV with Sq != Sk against the JAX package."""
    q, k, v, g = _inputs(sq + sk, 2, sq, sk, 4, 4 // group, 8)
    want, got = _grads_both(q, k, v, g, causal, window, getattr(jnp, dtype),
                            getattr(torch, dtype))
    if window is not None:
        assert sq - (sk + window - 1) >= 5  # several rows see no key
    for w, x in zip(want, got):
        np.testing.assert_allclose(x, w, atol=TOLS[dtype], rtol=TOLS[dtype])


def test_plain_parts_match_kernel_arguments():
    """The plain dQ and dK/dV versions, called with the forward's (o, lse)
    and delta = rowsum(dO * O), give the autograd gradients."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(5, 1, 21, 21, 4, 2, 8))
    o, lse = flash_attention_fwd(q, k, v, True, 5)
    delta = attention_delta(o, g)
    assert delta.shape == (4, 21) and lse.shape == (4, 21)
    dq = flash_attention_dq_plain(q, k, v, g, lse, delta, True, 5)
    dk, dv = flash_attention_dkv_plain(q, k, v, g, lse, delta, True, 5)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention(*ts, True, window=5), ts, g)
    for a, b in zip((dq, dk, dv), want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_cpu_backward_never_counts_a_launch():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(6, 1, 16, 16, 2, 1, 8))
    ts = [t.requires_grad_() for t in (q, k, v)]
    torch.autograd.grad(flash_attention(*ts, True), ts, g)
    assert flash_attention.flash_dq_launches == 0
    assert flash_attention.flash_dkv_launches == 0
