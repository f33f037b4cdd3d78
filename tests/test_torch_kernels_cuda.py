"""The port's CUDA kernels against their plain versions, on the card.

Imports torch only (no JAX), so it runs on the machine with the GPU:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

Without a GPU every test here skips (decided inside the test).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpunet_torch.models import Transformer, init_params
from tpunet_torch.ops.flash_attention import (flash_attention,
                                              flash_attention_fwd,
                                              flash_attention_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; the CPU runs the plain "
                    "versions only")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _inputs(seed, b, sq, sk, h, hk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, sq, h, d), (b, sk, hk, d), (b, sk, hk, d)))


@pytest.mark.parametrize("sq,sk,causal,window,dtype,tol", [
    (137, 137, True, None, torch.float32, 2e-5),    # ragged causal GQA
    (401, 401, True, 128, torch.bfloat16, 3e-2),    # ragged window
    (96, 160, False, None, torch.float32, 2e-5),    # non-causal Sq != Sk
    (64, 64, True, None, torch.float32, 2e-5),      # head dim 64 bucket
    (70, 70, True, 16, torch.bfloat16, 3e-2),       # head dim 256 bucket
])
def test_flash_kernel_matches_plain_version(card, sq, sk, causal, window,
                                            dtype, tol):
    d = {64: 64, 70: 256}.get(sq, 128)
    q, k, v = (torch.from_numpy(x).to(card, dtype)
               for x in _inputs(sq, 2, sq, sk, 16, 4, d))
    before = flash_attention.kernel_launches
    got, lse = flash_attention_fwd(q, k, v, causal, window)
    want, want_lse = flash_attention_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert flash_attention.kernel_launches == before + 1
    assert got.dtype == dtype and lse.shape == (2 * 16, sq)
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert float((lse - want_lse).abs().max()) <= tol


def test_flash_model_on_card_matches_cpu_reference(card):
    """A tiny f32 Transformer: flash on the card vs reference on the CPU."""
    cfg = dict(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
               d_ff=128, compute_dtype=torch.float32)
    meta = Transformer(device="meta", **cfg)
    params = init_params(meta, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (2, 45)))
    ref = Transformer(attn_impl="reference", device="meta", **cfg)
    flash = Transformer(attn_impl="flash", device="meta", **cfg)
    with torch.no_grad():
        want = ref.bind(params)(toks)
        got = flash.bind({k: t.to(card) for k, t in params.items()})(
            toks.to(card))
    assert float((got.cpu() - want).abs().max()) <= 1e-4
