"""Flash attention: hand-written CUDA kernels and their plain versions.

`flash_attention(q, k, v, causal, block_q, block_k, interpret, window)`
keeps the JAX package's signature, validation and custom VJP. On CUDA
tensors it launches the kernels of ``csrc/flash_fwd.cu`` (the Hopper
counterpart of the TPU kernel ``tpunet/ops/flash_attention.py:
_flash_kernel``) and, in the backward, of ``csrc/flash_bwd.cu``
(``_flash_dq_kernel`` and ``_flash_dkv_kernel``), or raises; on CPU tensors
it runs the plain PyTorch versions beside them. There is no fallback from
one to the other. In bf16 the forward, dQ and dK/dV kernels run on the
tensor cores at every head dim (8..256) and load their tiles by TMA, so
bf16 inputs to any of them need 16-byte aligned data and strides (a
misaligned input is refused, never copied or sent to another kernel); f32
runs on the CUDA cores.

Rows that see no key (causal with a window, qpos >= Sk + window - 1, only
when Sq > Sk) get the JAX reference's answer everywhere: o is the mean of V
over all Sk keys, lse is NEG_INF, dQ is 0, dK gets nothing from the row and
every dV row of its kv head gains dO/Sk.

The gradient is a `torch.autograd.Function`: its forward saves
(q, k, v, o, lse), its backward computes delta = rowsum(dO * O) as a plain
reduction (the TPU wrapper leaves it to XLA too) and runs dQ, then dK/dV.

Differences from the TPU wrapper, all layout rules of the TPU that the card
does not have:
  * no (8, 128) tile legality: `block_q`/`block_k` are accepted for config
    parity and the kernels pick their own tiles; `interpret` is ignored;
  * ragged lengths, causal with Sq != Sk (positions aligned at 0) and any
    block ratio run in the kernels themselves instead of falling back to
    the einsum, so prompts of any length (137, 401, ...) reach them;
  * lse and delta are (B*H, Sq) f32, without the TPU's replicated sublanes.

Launch counters: `flash_attention.kernel_launches` (forward),
`flash_attention.flash_dq_launches` and `flash_attention.flash_dkv_launches`.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fns: dict = {}  # bound C entry points, set at their first launch
_count_lock = threading.Lock()  # serving tiers launch from several threads


def _keep(sq: int, sk: int, causal: bool, window: int | None, device):
    """(Sq, Sk) bool: query i attends key j (positions aligned at 0), or
    None when nothing is masked."""
    if not causal:
        return None
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    keep = qpos >= kpos
    if window is not None:
        keep &= (qpos - kpos) < window
    return keep


def _masked_scores(q, k, causal: bool, window: int | None):
    """f32 (B, H, Sq, Sk) scores of q·kᵀ/sqrt(D) with the causal/window
    mask applied as NEG_INF; k carries q's head count."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    keep = _keep(s.shape[-2], s.shape[-1], causal, window, s.device)
    return s if keep is None else s.masked_fill(~keep, NEG_INF)


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


# C entry point -> (library, number of pointer arguments before the six
# shape ints, number of stride arguments).
_ENTRY = {"tpunet_flash_fwd": ("flash_fwd", 5, 12),
          "tpunet_flash_bwd_dq": ("flash_bwd", 7, 12),
          "tpunet_flash_bwd_dkv": ("flash_bwd", 8, 12)}


def _bind(name: str = "tpunet_flash_fwd"):
    if name not in _fns:
        from tpunet_torch.ops import _build

        lib, n_ptr, n_stride = _ENTRY[name]
        fn = getattr(_build.load(lib), name)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp] * n_ptr + [i32] * 6 + [i64] * n_stride
                       + [i32, i32, ctypes.c_float, i32, vp])
        fn.restype = i32
        _fns[name] = fn
    return _fns[name]


def _check_kernel_inputs(name, q, k, v):
    """Validation shared by the three kernels' wrappers; returns the
    (b, sq, h, d, sk, hk) shape."""
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (k.is_cuda and v.is_cuda and k.device == q.device == v.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"{name} supports head dims 8..256 in multiples "
                         f"of 8, got {d}")
    if b * h > 65535:
        raise ValueError(f"batch*heads {b * h} exceeds the kernel's grid")
    return b, sq, h, d, sk, hk


def _unit_stride(*ts):
    return tuple(t if t.stride(-1) == 1 else t.contiguous() for t in ts)


def _check_tma(name, *ts):
    """The bf16 tensor-core kernels load tiles by TMA, which takes only
    16-byte aligned base pointers and strides (8 bf16 elements); raise on
    anything else. A dim of extent 1 is never stepped, so its stride is
    free. (Unrolled: this runs on every serving-size call.)"""
    for t in ts:
        (b, s, h, _), st = t.shape, t.stride()
        if (t.data_ptr() % 16 or (b > 1 and st[0] % 8)
                or (s > 1 and st[1] % 8) or (h > 1 and st[2] % 8)):
            raise ValueError(
                f"{name}: bf16 tensors need 16-byte aligned data and "
                f"strides for TMA, got strides {t.stride()} at "
                f"0x{t.data_ptr():x}")


def _count(name: str) -> None:
    with _count_lock:
        setattr(flash_attention, name, getattr(flash_attention, name) + 1)


def _launch(q, k, v, causal: bool, window: int | None):
    """Run the CUDA forward kernel; returns (o, lse)."""
    b, sq, h, d, sk, hk = _check_kernel_inputs("flash_fwd", q, k, v)
    q, k, v = _unit_stride(q, k, v)
    if q.dtype == torch.bfloat16:
        _check_tma("flash_fwd", q, k, v)
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
    _count("kernel_launches")
    return o, lse


def _bwd_args(q, k, v, do, lse, delta, causal, window):
    """The arguments the two backward entry points share, after their
    output pointers: shapes, the four input tensors' strides, mask, scale,
    dtype code and stream."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    return ([b, h, hk, sq, sk, d]
            + [t.stride(i) for t in (q, k, v, do) for i in range(3)]
            + [int(causal), int(window or 0), 1.0 / math.sqrt(d),
               _DTYPE_CODES[q.dtype],
               torch.cuda.current_stream(q.device).cuda_stream])


def _launch_dq(q, k, v, do, lse, delta, causal: bool, window: int | None):
    """Run the dQ kernel; returns dQ (B, Sq, H, D) in q's dtype."""
    _check_kernel_inputs("flash_dq", q, k, v)
    q, k, v, do = _unit_stride(q, k, v, do)
    if q.dtype == torch.bfloat16:
        _check_tma("flash_dq", q, k, v, do)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    rc = _bind("tpunet_flash_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_bwd_args(q, k, v, do, lse, delta, causal, window))
    if rc != 0:
        raise RuntimeError(f"flash_dq launch failed with cudaError {rc}")
    _count("flash_dq_launches")
    return dq


def _launch_dkv(q, k, v, do, lse, delta, causal: bool, window: int | None):
    """Run the dK/dV kernel; returns (dK, dV), (B, Sk, Hkv, D) in k's and
    v's dtype, each kv head summed over its GQA group inside the kernel."""
    _check_kernel_inputs("flash_dkv", q, k, v)
    q, k, v, do = _unit_stride(q, k, v, do)
    if q.dtype == torch.bfloat16:
        _check_tma("flash_dkv", q, k, v, do)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    rc = _bind("tpunet_flash_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_bwd_args(q, k, v, do, lse, delta, causal, window))
    if rc != 0:
        raise RuntimeError(f"flash_dkv launch failed with cudaError {rc}")
    _count("flash_dkv_launches")
    return dk, dv


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


def _bwd_plain_parts(q, k, v, do, lse, delta, causal, window):
    """f32 (p, ds, k_full) over the group-repeated K/V, (B, H, Sq, Sk):
    P = exp(S - lse) and dS = P * (dP - delta) * scale with dP = dO . V^T,
    dS = 0 on every masked entry (the mask blocks the gradient, as
    `jnp.where` does in the JAX reference). A row that sees no key (causal
    with a window, qpos >= Sk + window - 1) has the softmax of Sk equal
    NEG_INF scores: P = 1/Sk on every key, so o is the mean of V, dV_k
    gains dO/Sk, and dQ and dK get nothing from it. (exp(S - lse) would
    give 1 there: in f32, lse = NEG_INF + log(Sk) rounds to NEG_INF.)"""
    group = _gqa_group(q, k)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    k_full, v_full = _repeat_kv(k, group), _repeat_kv(v, group)
    s = _masked_scores(q, k_full, causal, window)
    p = torch.exp(s - lse.reshape(b, h, sq, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v_full.float())
    ds = p * (dp - delta.reshape(b, h, sq, 1)) / math.sqrt(d)
    keep = _keep(sq, sk, causal, window, q.device)
    if keep is not None:
        no_key = ~keep.any(-1, keepdim=True)
        p = torch.where(keep, p, no_key.float() / sk)
        ds = torch.where(keep, ds, 0.0)
    return p, ds, k_full


def flash_attention_dq_plain(q, k, v, do, lse, delta, causal: bool = False,
                             window: int | None = None):
    """The dQ kernel's plain PyTorch version on any device: dQ = dS . K in
    q's dtype. lse and delta are (B*H, Sq) f32."""
    _, ds, k_full = _bwd_plain_parts(q, k, v, do, lse, delta, causal, window)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k_full.float()).to(q.dtype)


def flash_attention_dkv_plain(q, k, v, do, lse, delta, causal: bool = False,
                              window: int | None = None):
    """The dK/dV kernel's plain PyTorch version on any device:
    dV = P^T . dO and dK = dS^T . Q, summed over each kv head's GQA group,
    in k's and v's dtype."""
    p, ds, _ = _bwd_plain_parts(q, k, v, do, lse, delta, causal, window)
    b, sk, hk, d = k.shape
    group = q.shape[2] // hk
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dk = dk.reshape(b, sk, hk, group, d).sum(3)
    dv = dv.reshape(b, sk, hk, group, d).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(o, do):
    """delta = rowsum(dO * O) in f32, (B*H, Sq): the softmax-jacobian term
    both backward kernels read."""
    b, sq, h, _ = o.shape
    delta = (do.float() * o.float()).sum(-1)  # (B, Sq, H)
    return delta.permute(0, 2, 1).reshape(b * h, sq).contiguous()


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


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = False,
                        window: int | None = None):
    """(dq, dk, dv) of flash attention from the forward's (o, lse): the
    kernels' outputs on CUDA tensors, the plain versions' on CPU tensors."""
    delta = attention_delta(o, do)
    if q.is_cuda:
        dq = _launch_dq(q, k, v, do, lse, delta, causal, window)
        dk, dv = _launch_dkv(q, k, v, do, lse, delta, causal, window)
        return dq, dk, dv
    dq = flash_attention_dq_plain(q, k, v, do, lse, delta, causal, window)
    dk, dv = flash_attention_dkv_plain(q, k, v, do, lse, delta, causal,
                                       window)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the JAX package's custom VJP (`_flash_fwd`,
    `_flash_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_attention_fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                         ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, block_q: int = 128,
                    block_k: int = 128, interpret: bool | None = None,
                    window: int | None = None):
    """Flash attention. q: (batch, seq, heads, head_dim); k/v may carry
    fewer heads (grouped-query attention, heads % kv_heads == 0), read
    per q head as kv head h // group without a repeated copy. Returns
    q-shaped output. window (requires causal): sliding-window attention.
    Differentiable: the backward runs the dQ and dK/dV kernels on the card.
    block_q/block_k/interpret exist for parity with the JAX signature."""
    del block_q, block_k, interpret
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        # Inference (serving): the forward alone, no autograd node.
        return flash_attention_fwd(q, k, v, causal, window)[0]
    _route(q, k, causal, window)
    return _FlashAttention.apply(q, k, v, causal, window)


flash_attention.kernel_launches = 0
flash_attention.flash_dq_launches = 0
flash_attention.flash_dkv_launches = 0
