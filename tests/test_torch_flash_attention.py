"""The port's flash attention against the JAX package's, on the same inputs.

On the CPU the port's `flash_attention` runs its plain version; the JAX
`flash_attention` runs its Pallas kernel in interpret mode with 8-row tiles
(or its reference einsum where the JAX wrapper falls back: ragged lengths,
causal Sq != Sk). Tolerances are those of tests/test_ops.py: 2e-5 in f32,
3e-2 in bf16; and 5e-3 in f16 (F16_TOL's note). The CUDA kernel itself is held against the plain version on
the card by tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest

from conftest import free_port  # noqa: F401  (pins JAX_PLATFORMS=cpu first)

import jax
import jax.numpy as jnp
import torch

from tpunet.ops.flash_attention import NEG_INF
from tpunet.ops.flash_attention import _flash_fwd_impl as jax_fwd_impl
from tpunet.ops.flash_attention import attention_reference as jax_reference
from tpunet.ops.flash_attention import flash_attention as jax_flash
from tpunet_torch.ops.flash_attention import (attention_reference,
                                              flash_attention,
                                              flash_attention_fwd)


def _inputs(seed, b, sq, sk, h, hk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hk, d)).astype(np.float32)
    return q, k, v


def _jax_scores_lse(q, k, causal, window, group):
    """logsumexp over the JAX-side masked scores, (B*H, Sq)."""
    kf = jnp.repeat(jnp.asarray(k), group, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q) / np.sqrt(q.shape[-1]),
                   kf, precision=jax.lax.Precision.HIGHEST)
    if causal:
        sq, sk = s.shape[-2:]
        qp, kp = jnp.arange(sq)[:, None], jnp.arange(sk)[None, :]
        keep = qp >= kp
        if window is not None:
            keep &= (qp - kp) < window
        s = jnp.where(keep, s, NEG_INF)
    return np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(-1, q.shape[1])


CASES = (
    [(False, g, None, s) for g in (1, 2, 4) for s in (32, 37)]
    + [(True, g, w, s) for g in (1, 2, 4) for w in (None, 3)
       for s in (32, 37)]
)


@pytest.mark.parametrize("causal,group,window,seq", CASES)
def test_flash_matches_jax(causal, group, window, seq):
    h = 4
    q, k, v = _inputs(seq * 10 + group, 2, seq, seq, h, h // group, 8)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                     block_q=8, block_k=8, window=window)
    got, lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        lse.numpy(), _jax_scores_lse(q, k, causal, window, group),
        atol=2e-5, rtol=2e-5)
    plain = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal, window=window)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


@pytest.mark.parametrize("sq,sk", [(24, 40), (40, 16)])
def test_flash_cross_lengths_match_jax(sq, sk):
    """Non-causal Sq != Sk (the JAX wrapper tiles these in the kernel)."""
    q, k, v = _inputs(sq + sk, 2, sq, sk, 4, 2, 8)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False,
                     8, 8)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


def test_lse_matches_jax_kernel_lse():
    """Where the JAX kernel runs (even tiling), its own lse equals the
    port's (its TPU layout replicates each row over 8 sublanes)."""
    q, k, v = _inputs(7, 2, 32, 32, 4, 2, 8)
    _, jlse = jax_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           True, 8, 8, None, None)
    _, lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, 0, :],
                               atol=2e-5, rtol=2e-5)


def test_flash_bf16_matches_jax():
    q, k, v = _inputs(11, 1, 64, 64, 4, 2, 32)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = jax_flash(jq, jk, jv, True, 16, 16)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = flash_attention(tq, tk, tv, True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=3e-2, rtol=3e-2)


def test_reference_matches_jax_reference():
    q, k, v = _inputs(13, 2, 20, 20, 2, 2, 8)
    for causal, window in ((False, None), (True, None), (True, 5)):
        want = jax_reference(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v), causal, window)
        got = attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal, window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("kv_heads,causal,window", [
    (3, False, None),   # heads do not divide
    (4, False, 4),      # window without causal
    (4, True, 0),       # window < 1
])
def test_validation_errors_match_jax(kv_heads, causal, window):
    q, k, v = _inputs(3, 1, 16, 16, 4, kv_heads, 8)
    with pytest.raises(ValueError):
        jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                  8, 8, window=window)
    with pytest.raises(ValueError):
        flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal, window=window)


def test_cpu_path_never_counts_a_launch():
    before = flash_attention.kernel_launches
    q, k, v = _inputs(5, 1, 16, 16, 2, 1, 8)
    flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), True)
    flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), False)
    assert flash_attention.kernel_launches == before == 0


# float16: the JAX kernel rounds P to f16 before P.V (Precision.DEFAULT),
# the port's plain version keeps f32 and rounds only its output, so the two
# differ by output rounding: f16 keeps 11 significant bits, one unit in the
# last place is <= 3.9e-3 below |x| = 8, hence 5e-3 (bf16's 3e-2 / 1e-1
# hold 8 bits).
F16_TOL = 5e-3


@pytest.mark.parametrize("causal,group,window", [(True, 2, None),
                                                 (True, 1, 3),
                                                 (False, 4, None)])
def test_flash_f16_matches_jax(causal, group, window):
    q, k, v = _inputs(21 + group, 2, 32, 32, 4, 4 // group, 16)
    jq, jk, jv = (jnp.asarray(x, jnp.float16) for x in (q, k, v))
    want = jax_flash(jq, jk, jv, causal, 8, 8, window=window)
    tq, tk, tv = (torch.from_numpy(x).half() for x in (q, k, v))
    got = flash_attention(tq, tk, tv, causal, window=window)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=F16_TOL, rtol=F16_TOL)


@pytest.mark.parametrize("d", [12, 20])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)])
def test_flash_odd_head_dims_match_jax(d, causal, window):
    """Head dims that are not a multiple of 8 (the kernels run them
    zero-padded to 16 and 24), f32, tests/test_ops.py's 2e-5."""
    q, k, v = _inputs(d + 3, 2, 37, 37, 4, 2, d)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                     8, 8, window=window)
    got, lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        lse.numpy(), _jax_scores_lse(q, k, causal, window, 2),
        atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("d", [3, 12, 20, 8, 300])
def test_head_dim_padding_keeps_the_plain_result(d):
    """`_with_head_dim_padded` zero-pads q, k, v to the next multiple of 8,
    runs with 1/sqrt(D) of the true D and slices back: through the plain
    version it gives the unpadded result (the zero columns add exact zeros;
    1e-6 leaves room for f32 sums taken in another order), counts one input
    copy per padded tensor, and leaves a multiple of 8 untouched."""
    fa = sys.modules["tpunet_torch.ops.flash_attention"]
    q, k, v = (torch.from_numpy(x) for x in _inputs(d, 2, 21, 21, 4, 2, d))
    want, want_lse = fa.flash_attention_plain(q, k, v, True, 5)
    before = flash_attention.input_copies
    got, lse = fa._with_head_dim_padded(fa.flash_attention_plain, (q, k, v),
                                        True, 5)
    assert got.shape == want.shape and lse.shape == want_lse.shape
    assert flash_attention.input_copies - before == (3 if d % 8 else 0)
    flash_attention.input_copies = before
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse, want_lse, atol=1e-6, rtol=1e-6)


def test_kernel_validation_refuses_head_dims_above_256_and_other_dtypes():
    """What stays refused on the card, checked on CPU tensors (the
    validation needs no CUDA tensor): any dtype other than float32, bfloat16
    and float16, as the TPU kernels take no other. Head dims above 256 are
    no longer refused (the wide kernels run them): 264, 512 and 1000 pass
    with every other input the JAX wrapper takes."""
    fa = sys.modules["tpunet_torch.ops.flash_attention"]
    f64 = torch.zeros((1, 4, 2, 8), dtype=torch.float64)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        fa._check_kernel_inputs("flash_dq", f64, f64, f64)
    wide64 = torch.zeros((1, 4, 2, 264), dtype=torch.float64)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        fa._check_kernel_inputs("flash_fwd", wide64, wide64, wide64)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for d in (1, 12, 100, 256, 264, 512, 1000):
            q = torch.zeros((4097, 2, 16, d), dtype=dt)
            kv = torch.zeros((4097, 2, 4, d), dtype=dt)
            assert fa._check_kernel_inputs("flash_dkv", q, kv, kv) == (
                4097, 2, 16, d, 2, 4)


# Head dims above 256, where the card runs its wide kernels (300 is padded
# to 304 there; 576 is two groups of the 16-bit forward's chunks and five
# f32 spans), against the JAX package, which runs its Pallas kernel at
# every head dim (its einsum where it falls back: causal Sq != Sk).
# (d, dtype, causal, group, window, sq, sk); tolerances as above: 2e-5 f32,
# 3e-2 bf16, F16_TOL f16.
WIDE_CASES = [
    pytest.param(d, dt, causal, group, window, sq, sk,
                 id=f"d{d}-{dt}-{tag}")
    for d in (264, 300, 576) for dt in ("float32", "bfloat16", "float16")
    for causal, group, window, sq, sk, tag in (
        (True, 2, 3, 16, 16, "gqa2-w3"),
        (True, 4, None, 24, 16, "gqa4-sq24-sk16"))]
WIDE_TOL = {"float32": 2e-5, "bfloat16": 3e-2, "float16": F16_TOL}


@pytest.mark.parametrize("d,dtype,causal,group,window,sq,sk", WIDE_CASES)
def test_flash_wide_head_dims_match_jax(d, dtype, causal, group, window, sq,
                                        sk):
    q, k, v = _inputs(d + sq, 1, sq, sk, 4, 4 // group, d)
    jq, jk, jv = (jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v))
    want = jax_flash(jq, jk, jv, causal, 8, 8, window=window)
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    got = flash_attention(tq, tk, tv, causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=WIDE_TOL[dtype], rtol=WIDE_TOL[dtype])
