"""The port's flash-attention gradients against the JAX package's custom
VJP, on the same inputs and cotangent.

On the CPU the port's backward runs the plain versions of its dQ and dK/dV
kernels (`flash_attention_dq_plain`, `flash_attention_dkv_plain`) through
its `torch.autograd.Function`; the JAX side runs `jax.vjp` of its
`flash_attention` with 8-row tiles, i.e. the Pallas `_flash_dq_kernel` and
`_flash_dkv_kernel` in interpret mode (or its einsum fallback where the JAX
wrapper takes it: ragged lengths). Tolerances are those of
tests/test_ops.py's gradient tests: 5e-5 in f32, 1e-1 in bf16; 5e-3 in
f16 (the note at its test). The CUDA kernels themselves are held against
the plain versions on the card by tests/test_torch_kernels_cuda.py and
chip_smoke.py.
"""

from __future__ import annotations

import functools
import sys

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


# (sq, sk, causal, window, group, dtype, d). Non-causal Sq != Sk: the JAX
# wrapper tiles these in its kernels. Causal with a window and
# Sq > Sk + window: queries at qpos >= Sk + window - 1 see no key; the JAX
# wrapper takes its einsum path (causal Sq != Sk), whose softmax over
# all-NEG_INF scores averages V over every key, gives such rows dQ = 0, and
# gives each key dV += dO/Sk from them and no dK. Head dim 256, the widest
# tile of the port's bf16 kernels (32-key dQ steps, the dK/dV kernel that
# splits D between its warpgroups): the plain versions that the card holds
# those kernels to, at seq 37 (off every tile), GQA 2, causal with and
# without a window.
CROSS_CASES = [
    pytest.param(24, 40, False, None, 2, "float32", 8, id="24-40"),
    pytest.param(40, 24, False, None, 2, "float32", 8, id="40-24"),
    pytest.param(20, 12, True, 2, 1, "float32", 8, id="no-key-w2-g1-f32"),
    pytest.param(20, 12, True, 3, 2, "float32", 8, id="no-key-w3-g2-f32"),
    pytest.param(21, 9, True, 3, 1, "bfloat16", 8, id="no-key-w3-g1-bf16"),
    pytest.param(20, 12, True, 2, 2, "bfloat16", 8, id="no-key-w2-g2-bf16"),
    pytest.param(37, 37, True, None, 2, "float32", 256, id="d256-f32"),
    pytest.param(37, 37, True, 5, 2, "float32", 256, id="d256-w5-f32"),
    pytest.param(37, 37, True, None, 2, "bfloat16", 256, id="d256-bf16"),
    pytest.param(37, 37, True, 5, 2, "bfloat16", 256, id="d256-w5-bf16"),
]
TOLS = {"float32": 5e-5, "bfloat16": 1e-1}


@pytest.mark.parametrize("sq,sk,causal,window,group,dtype,d", CROSS_CASES)
def test_flash_grads_cross_lengths_match_jax(sq, sk, causal, window, group,
                                             dtype, d):
    """o, dQ, dK and dV against the JAX package: Sq != Sk, rows that see no
    key, head dim 256."""
    q, k, v, g = _inputs(sq + sk, 2, sq, sk, 4, 4 // group, d)
    want, got = _grads_both(q, k, v, g, causal, window, getattr(jnp, dtype),
                            getattr(torch, dtype))
    if window is not None and sq > sk:
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


# float16: outputs on both sides are rounded to f16 (11 significant bits),
# one unit in the last place is <= 3.9e-3 below |x| = 8, and the JAX kernel
# also rounds P and dS to f16 before its products; hence 5e-3 (bf16's 1e-1
# holds 8 bits).
@pytest.mark.parametrize("causal,group,window", [(True, 2, None),
                                                 (True, 1, 3),
                                                 (False, 4, None)])
def test_flash_grads_f16_match_jax(causal, group, window):
    q, k, v, g = _inputs(31 + group, 2, 32, 32, 4, 4 // group, 16)
    want, got = _grads_both(q, k, v, g, causal, window, jnp.float16,
                            torch.float16)
    for w, x in zip(want, got):
        np.testing.assert_allclose(x, w, atol=5e-3, rtol=5e-3)


@pytest.mark.parametrize("d", [12, 20])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)])
def test_flash_grads_odd_head_dims_match_jax(d, causal, window):
    """Head dims that are not a multiple of 8 (zero-padded to 16 and 24 on
    the card), f32, tests/test_ops.py's 5e-5."""
    q, k, v, g = _inputs(d + 7, 2, 37, 37, 4, 2, d)
    want, got = _grads_both(q, k, v, g, causal, window, jnp.float32,
                            torch.float32)
    for w, x in zip(want, got):
        np.testing.assert_allclose(x, w, atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("d", [3, 12, 20, 300])
def test_head_dim_padding_keeps_the_plain_gradients(d):
    """The backward's pad-and-slice (`_with_head_dim_padded` over q, k, v
    and dO, with 1/sqrt(D) of the true D) through the plain dQ and dK/dV
    versions gives the unpadded gradients (1e-6: f32 sums in another
    order), sliced back to D columns."""
    fa = sys.modules["tpunet_torch.ops.flash_attention"]
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(d, 2, 21, 21, 4, 2, d))
    o, lse = flash_attention_fwd(q, k, v, True, 5)
    delta = attention_delta(o, g)
    before = flash_attention.input_copies
    dq = fa._with_head_dim_padded(flash_attention_dq_plain, (q, k, v, g), lse,
                                  delta, True, 5)
    dk, dv = fa._with_head_dim_padded(flash_attention_dkv_plain,
                                      (q, k, v, g), lse, delta, True, 5)
    assert flash_attention.input_copies - before == 8
    flash_attention.input_copies = before
    want = (flash_attention_dq_plain(q, k, v, g, lse, delta, True, 5),
            *flash_attention_dkv_plain(q, k, v, g, lse, delta, True, 5))
    for got, w in zip((dq, dk, dv), want):
        assert got.shape == w.shape
        torch.testing.assert_close(got, w, atol=1e-6, rtol=1e-6)


# Head dims above 256, where the card runs its wide kernels (300 is padded
# to 304 there; 576 is three 192-column spans of the 16-bit backward and
# five 128-column spans of the f32 one): o, dQ, dK and dV against jax.vjp
# of the JAX package, whose Pallas kernels run at every head dim (its
# einsum where it falls back: causal Sq != Sk). (d, dtype, causal, group,
# window, sq, sk); tolerances as above: 5e-5 f32, bf16
# test_flash_grads_bf16_match_jax's 1e-1, f16 5e-3.
WIDE_CASES = [
    pytest.param(d, dt, causal, group, window, sq, sk,
                 id=f"d{d}-{dt}-{tag}")
    for d in (264, 300, 576) for dt in ("float32", "bfloat16", "float16")
    for causal, group, window, sq, sk, tag in (
        (True, 2, 3, 16, 16, "gqa2-w3"),
        (True, 4, None, 24, 16, "gqa4-sq24-sk16"))]
WIDE_TOLS = {"float32": 5e-5, "bfloat16": 1e-1, "float16": 5e-3}


@pytest.mark.parametrize("d,dtype,causal,group,window,sq,sk", WIDE_CASES)
def test_flash_grads_wide_head_dims_match_jax(d, dtype, causal, group,
                                              window, sq, sk):
    q, k, v, g = _inputs(d + sq, 1, sq, sk, 4, 4 // group, d)
    want, got = _grads_both(q, k, v, g, causal, window, getattr(jnp, dtype),
                            getattr(torch, dtype))
    for w, x in zip(want, got):
        assert x.shape == w.shape
        np.testing.assert_allclose(x, w, atol=WIDE_TOLS[dtype],
                                   rtol=WIDE_TOLS[dtype])
