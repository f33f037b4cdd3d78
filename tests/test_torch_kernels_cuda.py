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
# output's row error relative to the row's norm.
FWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
ROW_FLOOR = {torch.float32: 1e-6, torch.bfloat16: 1e-4}

# (b, sq, sk, h, hk, d, causal, window, dtype). The f32 rows run the CUDA
# cores; the bf16 rows run the tensor-core kernel (wgmma, TMA) at head dims
# 64/96/128/256, and 8/40/200, which TMA's zero fill pads up to the
# 64/128/256 tiles; GQA groups 1/4/8, ragged lengths off the 128-row tiles,
# windows 16/128, causal with Sq < Sk and Sq > Sk (aligned at position 0),
# and non-causal Sq != Sk.
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
]


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
# ragged lengths, a window and non-causal Sq != Sk; every bf16 row with
# D <= 128 runs the tensor-core dQ and dK/dV (head dims 8/40/64/96/128, GQA
# groups 1/4/8, windows 16/128, causal Sq < Sk and Sq > Sk, non-causal);
# the last two rows hold rows that see no key (dQ 0, dV += dO/Sk), in bf16
# and f32. Tolerances are those of tests/test_ops.py's gradient tests (5e-5
# f32, 1e-1 bf16), taken relative to max(1, max|reference|), and ROW_TOL on
# every row.
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
]
BWD_TOL = {torch.float32: 5e-5, torch.bfloat16: 1e-1}


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


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_dq", "flash_dkv"])
def test_flash_tensor_core_kernels_refuse_misaligned_strides(card, kernel):
    """TMA takes only 16-byte aligned data and strides: a bf16 view whose
    head stride is 36 elements (72 bytes) is refused by each tensor-core
    kernel's wrapper, never quietly run another way (no copy, no CUDA-core
    kernel, no plain version), and nothing is launched."""
    from tpunet_torch.ops.flash_attention import _launch_dkv, _launch_dq

    base = torch.zeros((1, 64, 8, 36), dtype=torch.bfloat16, device=card)
    q = torch.as_strided(base, (1, 64, 2, 32), (64 * 8 * 36, 8 * 36, 36, 1),
                         storage_offset=4)
    lse = torch.zeros((2, 64), dtype=torch.float32, device=card)
    calls = {"flash_fwd": lambda: flash_attention_fwd(q, q, q, True),
             "flash_dq": lambda: _launch_dq(q, q, q, q, lse, lse, True, None),
             "flash_dkv": lambda: _launch_dkv(q, q, q, q, lse, lse, True,
                                              None)}
    counters = ("kernel_launches", "flash_dq_launches", "flash_dkv_launches")
    before = [getattr(flash_attention, c) for c in counters]
    with pytest.raises(ValueError, match="16-byte"):
        calls[kernel]()
    assert [getattr(flash_attention, c) for c in counters] == before


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
