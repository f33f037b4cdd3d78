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
from tpunet_torch.ops.flash_attention import (attention_delta,
                                              flash_attention,
                                              flash_attention_bwd,
                                              flash_attention_dkv_plain,
                                              flash_attention_dq_plain,
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


def _row_err(got, want) -> float:
    """max over rows of |got - want| / |want|, norms over the last dim (one
    position of one head), as chip_smoke.py's row check; a reference row of
    (near) zero norm is held to ROW_FLOOR[want's dtype] of the largest (a
    causal dQ row that sees one key is exactly 0, and bf16 tensor-core
    arithmetic leaves cancellation noise there)."""
    g, w = got.float(), want.float()
    den = w.norm(dim=-1)
    den = den.clamp_min(max(ROW_FLOOR[want.dtype] * float(den.max()), 1e-30))
    return float(((g - w).norm(dim=-1) / den).max())


# chip_smoke.py's limits: the forward's largest error (absolute), and every
# output's row error relative to the row's norm. f16 keeps 11 significant
# bits to bf16's 8, so its limits are bf16's or tighter (chip_smoke.py's
# notes give the reasons).
F16 = torch.float16
FWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2, F16: 1e-2}
ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2, F16: 5e-2}
ROW_FLOOR = {torch.float32: 1e-6, torch.bfloat16: 1e-4, F16: 1e-4}

# Head dims above 256 (the wide kernels: bf16 and f16 on the tensor cores,
# the forward's two warpgroups splitting up to eight 64-column chunks of a
# block (264: 2 + 3, 512: 4 + 4, 576: two blocks of 4 and 5), the backward
# in spans of at most four chunks; f32 on the CUDA cores in clusters of
# span blocks (the forward's 128-column spans: 3 at 264 and 320, 4 at 512,
# 5 at 576, 7 at 800; dQ's 192-column spans in clusters of 2, 4 or 8); 300
# runs zero-padded to 304) at 264, 320, 512 and 576 in all three dtypes
# and 800 and 1160 in f32: GQA-8 with ragged Sq != Sk, the no-key rows (Sq
# 517, Sk 401, window 16), a window, non-causal Sq != Sk; batches of 2 in
# every dtype, among them the head layout of chip_smoke.py's wide path (4
# heads, 1 kv head, D 320). Both the forward and the backward tests run
# them.
WIDE_CASES = [
    (2, 401, 401, 4, 1, 320, True, None, torch.float32),
    (2, 300, 137, 8, 2, 512, False, None, torch.float32),
    (1, 137, 201, 8, 1, 264, True, None, torch.float32),
    (1, 517, 401, 8, 2, 320, True, 16, torch.float32),
    (1, 300, 201, 4, 4, 512, False, None, torch.float32),
    (1, 201, 201, 4, 2, 300, True, None, torch.float32),
    (1, 517, 401, 4, 1, 264, True, 16, torch.bfloat16),
    (2, 401, 137, 8, 1, 320, True, None, torch.bfloat16),
    (1, 300, 300, 4, 2, 512, True, 64, torch.bfloat16),
    (2, 201, 201, 8, 2, 264, True, 128, F16),
    (1, 137, 401, 8, 1, 320, True, None, F16),
    (1, 517, 401, 8, 2, 512, True, 16, F16),
    (1, 300, 201, 8, 2, 576, True, None, torch.float32),
    (1, 201, 137, 4, 2, 800, True, None, torch.float32),
    (2, 201, 300, 4, 1, 576, False, None, torch.bfloat16),
    (1, 517, 401, 4, 2, 576, True, 16, F16),
    # f32 past the clusters' boundary of eight spans (f32_cluster.cuh):
    # ten 128-column spans of the forward and dK/dV, a cluster of 8 and a
    # second whose six blocks past D only help with the scores.
    (1, 300, 201, 4, 1, 1160, True, 64, torch.float32),
]

# The 16-bit wide forward past its one-block width: bf16 D 1040 (17
# chunks, three blocks of 5, 6 and 6).
WIDE_FWD_CASES = [
    (1, 201, 300, 4, 2, 1040, True, None, torch.bfloat16),
]

# (b, sq, sk, h, hk, d, causal, window, dtype). The f32 rows run the CUDA
# cores; the bf16 and f16 rows run the tensor-core kernel (wgmma, TMA) at
# head dims 64/96/128/256, and 8/40/200, which TMA's zero fill pads up to
# the 64/128/256 tiles; GQA groups 1/4/8, ragged lengths off the 128-row
# tiles, windows 16/128, causal with Sq < Sk and Sq > Sk (aligned at
# position 0), and non-causal Sq != Sk. Head dims 12 and 100 (no multiple
# of 8) run zero-padded to 16 and 104.
FWD_CASES = [
    (2, 137, 137, 16, 4, 128, True, None, torch.float32),   # ragged GQA
    (2, 401, 401, 16, 4, 128, True, 128, torch.bfloat16),   # ragged window
    (2, 96, 160, 16, 4, 128, False, None, torch.float32),   # Sq != Sk
    (2, 64, 64, 16, 4, 64, True, None, torch.float32),      # head dim 64
    (2, 70, 70, 16, 4, 256, True, 16, torch.bfloat16),      # head dim 256
    (1, 137, 201, 4, 2, 40, True, None, torch.bfloat16),
    (1, 137, 201, 4, 2, 200, True, None, torch.bfloat16),
    (2, 137, 137, 16, 16, 64, True, None, torch.bfloat16),
    (1, 401, 401, 16, 4, 96, True, None, torch.bfloat16),
    (2, 137, 401, 16, 2, 128, True, None, torch.bfloat16),
    (1, 401, 137, 8, 1, 128, True, None, torch.bfloat16),
    (1, 401, 401, 8, 2, 256, True, 16, torch.bfloat16),
    (2, 300, 300, 16, 4, 128, True, 128, torch.bfloat16),
    (2, 137, 401, 16, 4, 64, False, None, torch.bfloat16),
    (1, 401, 137, 8, 8, 256, False, None, torch.bfloat16),
    # Rows that see no key (qpos >= Sk + window - 1 = 416): o is the mean
    # of V over all keys, lse NEG_INF; two whole 128-row q tiles hold only
    # such rows.
    (1, 517, 401, 16, 4, 128, True, 16, torch.bfloat16),
    (1, 517, 401, 16, 4, 128, True, 16, torch.float32),
    # float16: GQA-8 ragged, the no-key rows, head dim 256, a window.
    (2, 137, 401, 16, 2, 128, True, None, F16),
    (1, 517, 401, 16, 4, 128, True, 16, F16),
    (1, 401, 401, 8, 2, 256, True, 16, F16),
    (2, 300, 300, 16, 4, 64, True, 128, F16),
    # Head dims that are no multiple of 8.
    (2, 137, 137, 16, 4, 12, True, None, torch.float32),
    (1, 201, 300, 8, 2, 100, True, 64, torch.float32),
    (2, 137, 137, 16, 4, 12, True, None, torch.bfloat16),
    (1, 201, 300, 8, 2, 100, True, 64, torch.bfloat16),
    (1, 300, 201, 8, 8, 100, False, None, F16),
] + WIDE_CASES + WIDE_FWD_CASES


@pytest.mark.parametrize("b,sq,sk,h,hk,d,causal,window,dtype", FWD_CASES)
def test_flash_kernel_matches_plain_version(card, b, sq, sk, h, hk, d,
                                            causal, window, dtype):
    q, k, v = (torch.from_numpy(x).to(card, dtype)
               for x in _inputs(sq * 31 + sk + d, b, sq, sk, h, hk, d))
    before = flash_attention.kernel_launches
    got, lse = flash_attention_fwd(q, k, v, causal, window)
    want, want_lse = flash_attention_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert flash_attention.kernel_launches == before + 1
    assert got.dtype == dtype and lse.shape == (b * h, sq)
    assert float((got.float() - want.float()).abs().max()) <= FWD_TOL[dtype]
    assert float((lse - want_lse).abs().max()) <= FWD_TOL[dtype]
    assert _row_err(got, want) <= ROW_TOL[dtype]
    again, again_lse = flash_attention_fwd(q, k, v, causal, window)
    assert torch.equal(got, again) and torch.equal(lse, again_lse)


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


# (b, sq, sk, h, hk, d, causal, window, dtype): head dims 64/128/256, GQA,
# ragged lengths, a window and non-causal Sq != Sk; every bf16 row runs the
# tensor-core dQ and dK/dV: head dims 8/40/64/96/128 (64/128-wide tiles)
# and 136/192/248/256 (the 256-wide tiles: 32-key dQ steps, the dK/dV
# kernel that splits D between its warpgroups), GQA groups 1/4/8, windows
# 16/64/128, causal Sq < Sk and Sq > Sk, non-causal Sq != Sk, lengths off
# the 32/64/128-row tiles; the no-key rows (dQ 0, dV += dO/Sk) at Sq 517 /
# Sk 401 / window 16 in bf16 (D 128, 136, 256), f16 and f32; f16 at head
# dims 64/128/256; head dims 12 and 100 in all three types. Tolerances are
# those of tests/test_ops.py's gradient tests (5e-5 f32, 1e-1 bf16; f16
# 1e-2, chip_smoke.py's), taken relative to max(1, max|reference|), and
# ROW_TOL on every row.
BWD_CASES = [
    (2, 137, 137, 16, 4, 128, True, None, torch.float32),
    (2, 128, 128, 8, 8, 64, True, None, torch.float32),
    (1, 401, 401, 16, 4, 128, True, 128, torch.bfloat16),
    (2, 96, 160, 8, 2, 128, False, None, torch.float32),
    (1, 70, 70, 4, 1, 256, True, 16, torch.bfloat16),
    (1, 160, 96, 4, 2, 64, True, None, torch.float32),
    (2, 256, 256, 16, 16, 128, True, None, torch.bfloat16),
    (1, 137, 201, 4, 2, 8, True, None, torch.bfloat16),
    (1, 137, 201, 4, 2, 40, True, None, torch.bfloat16),
    (2, 137, 137, 16, 16, 64, True, None, torch.bfloat16),
    (1, 401, 401, 16, 4, 128, True, None, torch.bfloat16),
    (2, 137, 401, 16, 2, 64, True, None, torch.bfloat16),
    (1, 401, 137, 8, 1, 128, True, None, torch.bfloat16),
    (1, 401, 401, 8, 2, 128, True, 16, torch.bfloat16),
    (2, 300, 300, 16, 4, 64, True, 128, torch.bfloat16),
    (2, 137, 401, 16, 4, 128, False, None, torch.bfloat16),
    (1, 137, 201, 8, 1, 8, True, None, torch.bfloat16),
    (2, 201, 137, 8, 1, 40, True, None, torch.bfloat16),
    (1, 300, 300, 16, 2, 96, False, None, torch.bfloat16),
    (2, 401, 137, 16, 16, 128, False, None, torch.bfloat16),
    (1, 300, 300, 8, 1, 128, True, 64, torch.bfloat16),
    (1, 517, 401, 16, 4, 128, True, 16, torch.bfloat16),
    (1, 517, 401, 16, 4, 128, True, 16, torch.float32),
    # Head dims 129..256.
    (1, 137, 201, 4, 4, 136, True, None, torch.bfloat16),
    (2, 201, 137, 8, 2, 192, True, None, torch.bfloat16),
    (2, 401, 401, 16, 4, 256, True, None, torch.bfloat16),
    (1, 300, 300, 16, 2, 256, True, 64, torch.bfloat16),
    (1, 201, 300, 8, 2, 248, True, 128, torch.bfloat16),
    (2, 137, 401, 8, 1, 192, False, None, torch.bfloat16),
    (1, 401, 137, 4, 4, 256, False, None, torch.bfloat16),
    (1, 517, 401, 16, 4, 256, True, 16, torch.bfloat16),
    (1, 517, 401, 8, 1, 136, True, 16, torch.bfloat16),
    # float16: GQA-8 ragged, the no-key rows, head dim 256, a window.
    (2, 137, 401, 16, 2, 128, True, None, F16),
    (1, 517, 401, 16, 4, 128, True, 16, F16),
    (1, 300, 300, 16, 2, 256, True, 64, F16),
    (2, 201, 137, 8, 1, 64, True, None, F16),
    # Head dims that are no multiple of 8, and the f32 kernels at 256.
    (2, 137, 137, 16, 4, 12, True, None, torch.float32),
    (1, 201, 300, 8, 2, 100, True, 64, torch.float32),
    (2, 137, 137, 16, 4, 12, True, None, torch.bfloat16),
    (1, 201, 300, 8, 2, 100, True, 64, torch.bfloat16),
    (1, 300, 201, 8, 8, 100, False, None, F16),
    (1, 300, 300, 8, 2, 256, True, 64, torch.float32),
] + WIDE_CASES
BWD_TOL = {torch.float32: 5e-5, torch.bfloat16: 1e-1, F16: 1e-2}


@pytest.mark.parametrize("b,sq,sk,h,hk,d,causal,window,dtype", BWD_CASES)
def test_flash_bwd_kernels_match_plain_versions(card, b, sq, sk, h, hk, d,
                                                causal, window, dtype):
    rng = np.random.default_rng(sq * 7 + d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(card, dtype) for s in (
        (b, sq, h, d), (b, sk, hk, d), (b, sk, hk, d), (b, sq, h, d)))
    o, lse = flash_attention_fwd(q, k, v, causal, window)
    delta = attention_delta(o, do)
    before = (flash_attention.flash_dq_launches,
              flash_attention.flash_dkv_launches)
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal, window)
    torch.cuda.synchronize()
    assert (flash_attention.flash_dq_launches,
            flash_attention.flash_dkv_launches) == (before[0] + 1,
                                                    before[1] + 1)
    want_dq = flash_attention_dq_plain(q, k, v, do, lse, delta, causal,
                                       window)
    want_dk, want_dv = flash_attention_dkv_plain(q, k, v, do, lse, delta,
                                                 causal, window)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == want.dtype and got.shape == want.shape
        ref = want.float()
        scale = max(1.0, float(ref.abs().max()))
        assert float((got.float() - ref).abs().max()) <= BWD_TOL[dtype] * scale
        assert _row_err(got, want) <= ROW_TOL[dtype]
    # No atomics: a second run is bitwise the first.
    again = flash_attention_bwd(q, k, v, o, lse, do, causal, window)
    for x, y in zip((dq, dk, dv), again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("b,sq,sk,h,hk,causal,window", [
    (2, 401, 401, 8, 2, True, None),    # several 128-key steps, GQA-4
    (1, 517, 401, 8, 4, True, 16),      # the no-key rows: dQ 0
    (2, 137, 300, 8, 8, False, None),   # non-causal Sq != Sk, ragged
])
def test_f32_dq_kernel_matches_plain_version(card, d, b, sq, sk, h, hk,
                                             causal, window):
    """flash_dq_f32_kernel (64/128/256-wide tiles) against the plain dQ on
    the same inputs: tests/test_ops.py's 5e-5 relative to max(1, max|ref|),
    ROW_TOL on every row, bitwise equal on a second launch, one launch of
    the dQ entry point."""
    from tpunet_torch.ops.flash_attention import _launch_dq

    rng = np.random.default_rng(d + sq)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(card) for s in (
        (b, sq, h, d), (b, sk, hk, d), (b, sk, hk, d), (b, sq, h, d)))
    o, lse = flash_attention_fwd(q, k, v, causal, window)
    delta = attention_delta(o, do)
    args = (q, k, v, do, lse, delta, causal, window)
    before = flash_attention.flash_dq_launches
    got = _launch_dq(*args)
    want = flash_attention_dq_plain(*args)
    torch.cuda.synchronize()
    assert flash_attention.flash_dq_launches == before + 1
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 5e-5 * scale
    assert _row_err(got, want) <= ROW_TOL[torch.float32]
    if window is not None:  # rows that see no key get dQ 0, exactly
        assert not got[:, sk + window - 1:].any()
    assert torch.equal(got, _launch_dq(*args))


@pytest.mark.parametrize("d", [32, 256])
@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_dq", "flash_dkv"])
def test_flash_tensor_core_kernels_refuse_misaligned_strides(card, kernel, d):
    """TMA takes only 16-byte aligned data and strides: bf16 views whose
    head stride is d + 4 elements (8 bytes off a 16-byte multiple) and
    whose data start 8 bytes off are not given to the kernel as they are.
    The wrapper copies each to a contiguous tensor (one input copy for each
    such argument, counted in input_copies) and launches the same
    tensor-core kernel once, whose output matches the plain version on the
    views."""
    from tpunet_torch.ops.flash_attention import (_launch_dkv, _launch_dq,
                                                  attention_delta)

    w = d + 4
    gen = torch.Generator(device=card).manual_seed(d)
    q, k, v, do = (torch.as_strided(
        torch.randn((1, 64, 8, w), generator=gen, device=card).to(
            torch.bfloat16), (1, 64, 2, d), (64 * 8 * w, 8 * w, w, 1),
        storage_offset=4) for _ in range(4))
    o, lse = flash_attention_fwd(q.contiguous(), k.contiguous(),
                                 v.contiguous(), True)
    delta = attention_delta(o, do)
    args = (q, k, v, do, lse, delta, True, None)
    calls = {"flash_fwd": lambda: flash_attention_fwd(q, k, v, True),
             "flash_dq": lambda: _launch_dq(*args),
             "flash_dkv": lambda: _launch_dkv(*args)}
    plain = {"flash_fwd": lambda: flash_attention_plain(q, k, v, True),
             "flash_dq": lambda: (flash_attention_dq_plain(*args),),
             "flash_dkv": lambda: flash_attention_dkv_plain(*args)}
    counter = {"flash_fwd": "kernel_launches", "flash_dq": "flash_dq_launches",
               "flash_dkv": "flash_dkv_launches"}[kernel]
    copies = flash_attention.input_copies
    launches = getattr(flash_attention, counter)
    got = calls[kernel]()
    got = got if isinstance(got, tuple) else (got,)
    torch.cuda.synchronize()
    assert flash_attention.input_copies - copies == (3 if kernel ==
                                                     "flash_fwd" else 4)
    assert getattr(flash_attention, counter) == launches + 1
    for x, want in zip(got, plain[kernel]()):
        if x.dim() == 4:
            ref = want.float()
            scale = max(1.0, float(ref.abs().max()))
            assert float((x.float() - ref).abs().max()) <= 1e-1 * scale
            assert _row_err(x, want) <= ROW_TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_take_batch_heads_above_65535(card, dtype):
    """B*H = 65,552 (B 4097, H 16), above the 65,535 blocks of grid.y: the
    forward, dQ and dK/dV kernels put B*H on grid.x and match their plain
    versions."""
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (4097, 64, 16, 8)).astype(np.float32)).to(card, dtype)
        for _ in range(4))
    o, lse = flash_attention_fwd(q, k, v, True)
    want_o, want_lse = flash_attention_plain(q, k, v, True)
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, True)
    from tpunet_torch.ops.flash_attention import attention_delta

    delta = attention_delta(o, do)
    want = (flash_attention_dq_plain(q, k, v, do, lse, delta, True),
            *flash_attention_dkv_plain(q, k, v, do, lse, delta, True))
    torch.cuda.synchronize()
    assert float((o.float() - want_o.float()).abs().max()) <= FWD_TOL[dtype]
    assert float((lse - want_lse).abs().max()) <= FWD_TOL[dtype]
    assert _row_err(o, want_o) <= ROW_TOL[dtype]
    for got, w in zip((dq, dk, dv), want):
        ref = w.float()
        scale = max(1.0, float(ref.abs().max()))
        assert float((got.float() - ref).abs().max()) <= BWD_TOL[dtype] * scale
        assert _row_err(got, w) <= ROW_TOL[dtype]


def test_f16_model_with_head_dim_12_on_card_matches_cpu(card):
    """A tiny float16 Transformer with head dim 12 (the inputs the card once
    refused): flash on the card against the reference impl on the CPU,
    within 1e-2 (tests/test_torch_transformer.py's f16 limit)."""
    cfg = dict(vocab=64, d_model=48, n_layers=2, n_heads=4, n_kv_heads=2,
               d_ff=96, compute_dtype=F16)
    params = init_params(Transformer(device="meta", **cfg), seed=0,
                         device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (2, 45)))
    copies = flash_attention.input_copies
    with torch.no_grad():
        want = Transformer(attn_impl="reference", device="meta",
                           **cfg).bind(params)(toks)
        got = Transformer(attn_impl="flash", device="meta", **cfg).bind(
            {k: t.to(card) for k, t in params.items()})(toks.to(card))
    assert flash_attention.input_copies > copies  # the head dim was padded
    assert float((got.float().cpu() - want.float()).abs().max()) <= 1e-2


def test_flash_autograd_on_card_matches_cpu(card):
    """Gradients through `flash_attention` on the card (both backward
    kernels) against the plain route on the CPU, f32."""
    rng = np.random.default_rng(3)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((2, 45, 4, 64), (2, 45, 2, 64), (2, 45, 2, 64),
                            (2, 45, 4, 64)))
    grads = []
    for dev in ("cpu", card):
        xs = [t.to(dev).requires_grad_() for t in (q, k, v)]
        out = flash_attention(*xs, True)
        grads.append(torch.autograd.grad(out, xs, g.to(dev)))
    for a, b in zip(*grads):
        assert float((a - b.cpu()).abs().max()) <= 5e-5


def test_train_step_on_card_matches_cpu(card):
    """One adamw step of a tiny f32 Transformer (flash attention, remat)
    on the card against the same step on the CPU: loss and gradients
    within f32 rounding; after the step every parameter within 2*lr (the
    most one adam step moves an element, whatever its gradient's sign)."""
    from tpunet_torch.train import adamw, create_train_state, make_train_step
    from tpunet_torch.train.trainer import _make_loss_fn, _value_and_grads

    cfg = dict(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
               d_ff=128, compute_dtype=torch.float32, attn_impl="flash",
               remat=True)
    model = Transformer(device="meta", **cfg)
    params = init_params(model, seed=0, device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 64, (2, 45))
    labels = np.roll(toks, -1, axis=1)
    lr = 1e-3
    out = {}
    for dev in ("cpu", card):
        state, net = create_train_state(model, 0, None, adamw(lr),
                                        params=params, device=dev)
        x, y = (torch.as_tensor(a, device=dev) for a in (toks, labels))
        before = flash_attention.flash_dq_launches
        loss, grads = _value_and_grads(net, state.params, x, y,
                                       _make_loss_fn(), None)
        launched = flash_attention.flash_dq_launches - before
        state, step_loss = make_train_step(model)(state, toks, labels, 0)
        out[str(dev)] = (float(loss), {k: g.cpu() for k, g in grads.items()},
                         {k: p.detach().cpu() for k, p in
                          state.params.items()}, launched, float(step_loss))
    cpu, gpu = out["cpu"], out[str(card)]
    assert cpu[3] == 0 and gpu[3] == cfg["n_layers"]
    assert abs(cpu[0] - gpu[0]) <= 1e-5 * abs(cpu[0])
    assert cpu[0] == cpu[4] and gpu[0] == gpu[4]
    for name, g in cpu[1].items():
        scale = max(float(g.abs().max()), 1e-6)
        assert float((gpu[1][name] - g).abs().max()) <= 1e-4 * scale, name
    for name, p in cpu[2].items():
        assert float((gpu[2][name] - p).abs().max()) <= 2 * lr * 1.001, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vgg_on_card_matches_cpu(card, dtype):
    """A tiny VGG (the tiny plan of tests/test_models.py on 16x16 images)
    on the card (cuDNN's NHWC convolutions, cuBLAS) against the same model
    on the CPU: logits and loss; in f32 also the gradients and the params
    after 2 steps of sgd with momentum."""
    from tpunet_torch.models import VGG
    from tpunet_torch.train import (create_train_state, make_train_step, sgd,
                                    synthetic_batch)
    from tpunet_torch.train.trainer import _make_loss_fn, _value_and_grads

    model = VGG(cfg=(8, "M", 16, "M"), num_classes=10, hidden=32,
                image_size=16, compute_dtype=dtype, classifier_dropout=0.0,
                device="meta")
    params = model.init_params(seed=0, device="cpu")
    images, labels = synthetic_batch(np.random.default_rng(4), 4, 16, 10)
    out = {}
    for dev in ("cpu", card):
        state, net = create_train_state(model, 0, None, sgd(5e-2, 0.9),
                                        params=params, device=dev)
        x = torch.as_tensor(images, device=dev)
        y = torch.as_tensor(labels, device=dev).long()
        feats = net.conv0(x.to(dtype).permute(0, 3, 1, 2))
        assert feats.is_contiguous(memory_format=torch.channels_last)
        logits = net(x).detach().cpu()
        loss, grads = _value_and_grads(net, state.params, x, y,
                                       _make_loss_fn(), None)
        step = make_train_step(model)
        for i in range(2):
            state, _ = step(state, images, labels, i)
        out[str(dev)] = (logits, float(loss),
                         {k: g.cpu() for k, g in grads.items()},
                         {k: p.detach().cpu()
                          for k, p in state.params.items()})
    cpu, gpu = out["cpu"], out[str(card)]
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    scale = float(cpu[0].abs().max())
    assert float((gpu[0] - cpu[0]).abs().max()) <= tol * scale
    assert abs(gpu[1] - cpu[1]) <= tol * abs(cpu[1])
    if dtype != torch.float32:
        assert all(torch.isfinite(p).all() for p in gpu[3].values())
        return
    for name, g in cpu[2].items():
        gs = max(float(g.abs().max()), 1e-6)
        assert float((gpu[2][name] - g).abs().max()) <= 1e-4 * gs, name
    for name, p in cpu[3].items():
        ps = max(float(p.abs().max()), 1e-6)
        assert float((gpu[3][name] - p).abs().max()) <= 1e-5 * ps, name


def test_flat_mean_on_card_is_in_place_with_dcn_pmean_bits(card):
    """The replicated step's flat gradient mean on the card: the bits of
    dcn_pmean (f32 and the bf16 cast), and no device buffer beyond the flat
    vector itself (dcn_pmean's path held two more)."""
    from conftest import free_port
    from tpunet_torch import distributed, interop
    from tpunet_torch.train.trainer import _flat_dcn_pmean

    distributed.initialize(f"127.0.0.1:{free_port()}", 0, 1)
    try:
        gen = torch.Generator(device=card).manual_seed(0)
        g = torch.randn(1 << 22, generator=gen, device=card)
        grads = {"a": g[:3 << 20].view(3 << 10, 1 << 10), "b": g[3 << 20:]}
        want32 = interop.dcn_pmean(g)
        want16 = interop.dcn_pmean(g.to(torch.bfloat16)).to(torch.float32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got32 = _flat_dcn_pmean(dict(grads), None, 1)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        got16 = _flat_dcn_pmean(dict(grads), "bf16", 1)
        for got, want in ((got32, want32), (got16, want16)):
            assert got["a"].device.type == "cuda"
            flat = torch.cat([got["a"].reshape(-1), got["b"]])
            assert torch.equal(flat, want)
        assert peak <= g.numel() * 4 + (1 << 20), peak
    finally:
        distributed.finalize()


def test_elastic_crc_check_of_cuda_tensors_and_reduce_into_refusal(
        card, tmp_path):
    """ElasticWorld.crc_check of tensors on the card gives the digest of
    the same tensors on the CPU (by their contiguous host bytes; bf16 and a
    channels-last view included), and transport.reduce_into refuses a CUDA
    tensor with TypeError instead of copying it."""
    from conftest import free_port
    from tpunet_torch import elastic, transport

    gen = torch.Generator(device=card).manual_seed(0)
    params = {"w": torch.randn(64, 32, generator=gen, device=card),
              "b16": torch.randn(100, generator=gen, device=card).to(
                  torch.bfloat16),
              "conv": torch.randn(8, 4, 3, 3, generator=gen, device=card)
              .to(memory_format=torch.channels_last)}
    world = elastic.ElasticWorld(f"127.0.0.1:{free_port()}", 0, 1,
                                 directory=tmp_path)
    world.create()
    try:
        on_card = world.crc_check(list(params.values()))
        on_cpu = world.crc_check([v.cpu() for v in params.values()])
        assert on_card == on_cpu != 0
    finally:
        world.close()
    x = torch.ones(16, device=card)
    host = torch.ones(16)
    for args in ((x, host, host), (host, x, host), (host, host, x)):
        with pytest.raises(TypeError, match="cuda"):
            transport.reduce_into(*args, "f32")
