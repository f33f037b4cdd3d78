"""Flash attention forward: a hand-written CUDA kernel and its plain version.

`flash_attention(q, k, v, causal, block_q, block_k, interpret, window)`
keeps the JAX package's signature and validation. On a CUDA tensor it
launches the kernel of ``csrc/flash_fwd.cu`` (the Hopper counterpart of the
TPU kernel ``tpunet/ops/flash_attention.py:_flash_kernel``) or raises; on a
CPU tensor it runs `attention_reference`, the plain PyTorch version beside
it. There is no fallback from one to the other.

Differences from the TPU wrapper, all layout rules of the TPU that the card
does not have:
  * no (8, 128) tile legality: `block_q`/`block_k` are accepted for config
    parity and the kernel picks its own tiles; `interpret` is ignored;
  * ragged lengths, causal with Sq != Sk (positions aligned at 0) and any
    block ratio run in the kernel itself instead of falling back to the
    einsum, so prompts of any length (137, 401, ...) reach the kernel;
  * lse is (B*H, Sq) f32, without the TPU's replicated sublanes.

`flash_attention.kernel_launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None  # the bound C entry point, set at the first launch
_count_lock = threading.Lock()  # serving tiers launch from several threads


def _masked_scores(q, k, causal: bool, window: int | None):
    """f32 (B, H, Sq, Sk) scores of q·kᵀ/sqrt(D) with the causal/window
    mask applied as NEG_INF; k carries q's head count."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        qpos = torch.arange(sq, device=s.device)[:, None]
        kpos = torch.arange(sk, device=s.device)[None, :]
        keep = qpos >= kpos
        if window is not None:
            keep &= (qpos - kpos) < window
        s = s.masked_fill(~keep, NEG_INF)
    return s


def attention_reference(q, k, v, causal: bool = False,
                        window: int | None = None):
    """Plain softmax attention, f32 internally. Shapes (B, S, H, D), k/v
    with q's head count. window (requires causal): each query attends only
    the `window` most recent positions including itself."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    p = torch.softmax(_masked_scores(q, k, causal, window), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def _repeat_kv(x, group: int):
    return x.repeat_interleave(group, dim=2) if group > 1 else x


def _gqa_group(q, k) -> int:
    h, hk = q.shape[2], k.shape[2]
    if h % hk:
        raise ValueError(f"q heads {h} not divisible by kv heads {hk}")
    return h // hk


def _bind():
    global _fn
    if _fn is None:
        from tpunet_torch.ops import _build

        fn = _build.load("flash_fwd").tpunet_flash_fwd
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp] * 5 + [i32] * 6 + [i64] * 12
                       + [i32, i32, ctypes.c_float, i32, vp])
        fn.restype = i32
        _fn = fn
    return _fn


def _launch(q, k, v, causal: bool, window: int | None):
    """Run the CUDA kernel; returns (o, lse)."""
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (k.is_cuda and v.is_cuda and k.device == q.device == v.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the flash backward kernels (dQ, dK/dV) belong to the training "
            "slice of the port; run the forward under torch.no_grad()")
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"flash_fwd supports head dims 8..256 in multiples "
                         f"of 8, got {d}")
    if b * h > 65535:
        raise ValueError(f"batch*heads {b * h} exceeds the kernel's grid")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    rc = _bind()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, hk, sq, sk, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(1), o.stride(2),
        int(causal), int(window or 0), 1.0 / math.sqrt(d),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed with cudaError {rc}")
    with _count_lock:
        flash_attention.kernel_launches += 1
    return o, lse


def flash_attention_plain(q, k, v, causal: bool = False,
                          window: int | None = None):
    """The kernel's plain PyTorch version on any device: (o, lse) from
    `attention_reference` over the group-repeated K/V, lse being the
    logsumexp of the masked scores, (B*H, Sq) f32."""
    group = _gqa_group(q, k)
    k_full, v_full = _repeat_kv(k, group), _repeat_kv(v, group)
    o = attention_reference(q, k_full, v_full, causal, window)
    lse = torch.logsumexp(_masked_scores(q, k_full, causal, window), dim=-1)
    return o, lse.reshape(-1, q.shape[1])


def _route(q, k, causal: bool, window: int | None) -> bool:
    """Validate like the JAX wrapper; True when the kernel runs."""
    _gqa_group(q, k)
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal=True and window >= 1")
    if q.is_cuda:
        return True
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    return False


def flash_attention_fwd(q, k, v, causal: bool = False,
                        window: int | None = None):
    """(o, lse) of flash attention: the kernel's outputs on a CUDA tensor,
    the plain version's on a CPU tensor. lse is (B*H, Sq) f32."""
    if _route(q, k, causal, window):
        return _launch(q, k, v, causal, window)
    return flash_attention_plain(q, k, v, causal, window)


def flash_attention(q, k, v, causal: bool = False, block_q: int = 128,
                    block_k: int = 128, interpret: bool | None = None,
                    window: int | None = None):
    """Flash attention. q: (batch, seq, heads, head_dim); k/v may carry
    fewer heads (grouped-query attention, heads % kv_heads == 0), read
    per q head as kv head h // group without a repeated copy. Returns
    q-shaped output. window (requires causal): sliding-window attention.
    block_q/block_k/interpret exist for parity with the JAX signature."""
    del block_q, block_k, interpret
    if _route(q, k, causal, window):
        return _launch(q, k, v, causal, window)[0]
    group = q.shape[2] // k.shape[2]
    return attention_reference(q, _repeat_kv(k, group), _repeat_kv(v, group),
                               causal, window)


flash_attention.kernel_launches = 0
