"""Flash attention: hand-written CUDA kernels and their plain versions.

`flash_attention(q, k, v, causal, block_q, block_k, interpret, window)`
keeps the JAX package's signature, validation and custom VJP. On CUDA
tensors it launches the kernels of ``csrc/flash_fwd.cu`` (the Hopper
counterpart of the TPU kernel ``tpunet/ops/flash_attention.py:
_flash_kernel``) and, in the backward, of ``csrc/flash_bwd.cu``
(``_flash_dq_kernel`` and ``_flash_dkv_kernel``), or raises; on CPU tensors
it runs the plain PyTorch versions beside them. There is no fallback from
one to the other. bf16 and f16 run on the tensor cores (wgmma, tiles
loaded by TMA) and f32 on the CUDA cores (exact f32 FMA), at every head
dim. Above head dim 256 the output's columns are split into spans and the
scores are formed once for several of them: the forward's two consumer
warpgroups share one q tile and swap their partial scores
(`flash_fwd_wide_bf16_kernel`), the f32 span blocks of a tile run as a
thread-block cluster (`flash_fwd_wide_f32_kernel`,
`flash_dq_wide_f32_kernel`, `flash_dkv_wide_f32_kernel`), and each 16-bit
backward span block forms them itself (`flash_dq_wide_bf16_kernel`,
`flash_dkv_wide_bf16_kernel`). Any head dim and any batch * heads run.

What the kernels need, the wrapper makes (each copy adds one to
`flash_attention.input_copies`; the model's own calls make none):
  * a head dim that is not a multiple of 8 is zero-padded to the next one
    (q, k, v and, in the backward, dO), run with the scale of the true
    head dim, and the outputs are sliced back (`_with_head_dim_padded`);
  * an input whose head dim is not contiguous, or whose data or strides
    are not 16-byte aligned (TMA and 16-byte cp.async take no other), is
    copied to a contiguous tensor and run by the same kernel.

Rows that see no key (causal with a window, qpos >= Sk + window - 1, only
when Sq > Sk) get the JAX reference's answer everywhere: o is the mean of V
over all Sk keys, lse is NEG_INF, dQ is 0, dK gets nothing from the row and
every dV row of its kv head gains dO/Sk.

The gradient is a `torch.autograd.Function`: its forward saves
(q, k, v, o, lse), its backward computes delta = rowsum(dO * O) as a plain
reduction (the TPU wrapper leaves it to XLA too) and runs dQ, then dK/dV.

Differences from the TPU wrapper:
  * no (8, 128) tile legality: `block_q`/`block_k` are accepted for config
    parity and the kernels pick their own tiles; `interpret` is ignored;
  * ragged lengths, causal with Sq != Sk (positions aligned at 0) and any
    block ratio run in the kernels themselves instead of falling back to
    the einsum, so prompts of any length (137, 401, ...) reach them;
  * lse and delta are (B*H, Sq) f32, without the TPU's replicated sublanes.
Like the TPU kernels, which take f32, bf16 and f16 only, the card refuses
any other dtype (`_check_kernel_inputs`, TypeError) before a launch; the
CPU path takes it.

Counters: `flash_attention.kernel_launches` (forward),
`flash_attention.flash_dq_launches`, `flash_attention.flash_dkv_launches`
and `flash_attention.input_copies`.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
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


def _masked_scores(q, k, causal: bool, window: int | None, scale=None):
    """f32 (B, H, Sq, Sk) scores of q·kᵀ·scale (by default 1/sqrt(D)) with
    the causal/window mask applied as NEG_INF; k carries q's head count."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    keep = _keep(s.shape[-2], s.shape[-1], causal, window, s.device)
    return s if keep is None else s.masked_fill(~keep, NEG_INF)


def attention_reference(q, k, v, causal: bool = False,
                        window: int | None = None, scale=None):
    """Plain softmax attention, f32 internally. Shapes (B, S, H, D), k/v
    with q's head count. window (requires causal): each query attends only
    the `window` most recent positions including itself. scale: of the
    scores, 1/sqrt(D) by default."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    p = torch.softmax(_masked_scores(q, k, causal, window, scale), dim=-1)
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
    """The shape and dtype validation of the three kernels' wrappers, on
    tensors of any device; returns the (b, sq, h, d, sk, hk) shape. Raises
    TypeError for a dtype other than float32, bfloat16 and float16 (or
    mixed dtypes), and ValueError for k/v shapes that do not match q or an
    empty head dim. Every head dim from 1 up runs."""
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32, bfloat16 or float16 q/k/v "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if d < 1:
        raise ValueError(f"{name} needs a head dim of at least 1, got {d}")
    return b, sq, h, d, sk, hk


def _check_device(*ts) -> None:
    if not all(t.is_cuda and t.device == ts[0].device for t in ts):
        raise ValueError("q, k and v must lie on one CUDA device")


def _count(name: str, n: int = 1) -> None:
    with _count_lock:
        setattr(flash_attention, name, getattr(flash_attention, name) + n)


def _aligned(*ts):
    """The inputs as the kernels load them (TMA for bf16/f16, 16-byte
    cp.async for f32): unit stride in D and 16-byte aligned data and
    strides. Any other tensor is copied to a contiguous one, counted in
    input_copies. A dim of extent 1 is never stepped, so its stride is
    free. (Unrolled: this runs on every serving-size call.)"""
    out = []
    for t in ts:
        (b, s, h, _), st, unit = t.shape, t.stride(), 16 // t.element_size()
        if (st[3] != 1 or t.data_ptr() % 16 or (b > 1 and st[0] % unit)
                or (s > 1 and st[1] % unit) or (h > 1 and st[2] % unit)):
            t = t.clone(memory_format=torch.contiguous_format)
            _count("input_copies")
        out.append(t)
    return out


def _with_head_dim_padded(fn, ts, *args):
    """fn(*ts, *args, scale=1/sqrt(D)) with the (B, S, H, D) tensors `ts`
    zero-padded in D to the next multiple of 8 (one copy each, counted in
    input_copies) and every 4-d output sliced back to its first D columns.
    Zero columns add nothing to q·kᵀ and give zero output, dQ, dK and dV
    columns, which are dropped; the scale stays that of the true D. A D
    that is a multiple of 8 passes through untouched."""
    d = ts[0].shape[-1]
    pad = -d % 8
    if pad:
        ts = [torch.nn.functional.pad(t, (0, pad)) for t in ts]
        _count("input_copies", len(ts))
    out = fn(*ts, *args, scale=1.0 / math.sqrt(d))
    if not pad:
        return out
    if isinstance(out, tuple):
        return tuple(x[..., :d] if x.dim() == 4 else x for x in out)
    return out[..., :d]


def _launch(q, k, v, causal: bool, window: int | None):
    """Run the CUDA forward kernel; returns (o, lse)."""
    _check_kernel_inputs("flash_fwd", q, k, v)
    _check_device(q, k, v)
    return _with_head_dim_padded(_launch_fwd, (q, k, v), causal, window)


def _launch_fwd(q, k, v, causal, window, scale):
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    q, k, v = _aligned(q, k, v)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    rc = _bind()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, hk, sq, sk, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(1), o.stride(2),
        int(causal), int(window or 0), scale,
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed with cudaError {rc}")
    _count("kernel_launches")
    return o, lse


def _bwd_args(q, k, v, do, causal, window, scale):
    """The arguments the two backward entry points share, after their
    output pointers: shapes, the four input tensors' strides, mask, scale,
    dtype code and stream."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    return ([b, h, hk, sq, sk, d]
            + [t.stride(i) for t in (q, k, v, do) for i in range(3)]
            + [int(causal), int(window or 0), scale, _DTYPE_CODES[q.dtype],
               torch.cuda.current_stream(q.device).cuda_stream])


def _launch_dq(q, k, v, do, lse, delta, causal: bool, window: int | None):
    """Run the dQ kernel; returns dQ (B, Sq, H, D) in q's dtype."""
    _check_kernel_inputs("flash_dq", q, k, v)
    _check_device(q, k, v, do)
    return _with_head_dim_padded(_launch_dq_kernel, (q, k, v, do), lse,
                                 delta, causal, window)


def _launch_dq_kernel(q, k, v, do, lse, delta, causal, window, scale):
    q, k, v, do = _aligned(q, k, v, do)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    rc = _bind("tpunet_flash_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_bwd_args(q, k, v, do, causal, window, scale))
    if rc != 0:
        raise RuntimeError(f"flash_dq launch failed with cudaError {rc}")
    _count("flash_dq_launches")
    return dq


def _launch_dkv(q, k, v, do, lse, delta, causal: bool, window: int | None):
    """Run the dK/dV kernel; returns (dK, dV), (B, Sk, Hkv, D) in k's and
    v's dtype, each kv head summed over its GQA group inside the kernel."""
    _check_kernel_inputs("flash_dkv", q, k, v)
    _check_device(q, k, v, do)
    return _with_head_dim_padded(_launch_dkv_kernel, (q, k, v, do), lse,
                                 delta, causal, window)


def _launch_dkv_kernel(q, k, v, do, lse, delta, causal, window, scale):
    q, k, v, do = _aligned(q, k, v, do)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    rc = _bind("tpunet_flash_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_bwd_args(q, k, v, do, causal, window, scale))
    if rc != 0:
        raise RuntimeError(f"flash_dkv launch failed with cudaError {rc}")
    _count("flash_dkv_launches")
    return dk, dv


def flash_attention_plain(q, k, v, causal: bool = False,
                          window: int | None = None, scale=None):
    """The kernel's plain PyTorch version on any device: (o, lse) from
    `attention_reference` over the group-repeated K/V, lse being the
    logsumexp of the masked scores, (B*H, Sq) f32. scale: of the scores,
    1/sqrt(D) by default."""
    group = _gqa_group(q, k)
    k_full, v_full = _repeat_kv(k, group), _repeat_kv(v, group)
    o = attention_reference(q, k_full, v_full, causal, window, scale)
    lse = torch.logsumexp(_masked_scores(q, k_full, causal, window, scale),
                          dim=-1)
    return o, lse.reshape(-1, q.shape[1])


def _bwd_plain_parts(q, k, v, do, lse, delta, causal, window, scale=None):
    """f32 (p, ds, k_full) over the group-repeated K/V, (B, H, Sq, Sk):
    P = exp(S - lse) and dS = P * (dP - delta) * scale with dP = dO . V^T,
    dS = 0 on every masked entry (the mask blocks the gradient, as
    `jnp.where` does in the JAX reference). A row that sees no key (causal
    with a window, qpos >= Sk + window - 1) has the softmax of Sk equal
    NEG_INF scores: P = 1/Sk on every key, so o is the mean of V, dV_k
    gains dO/Sk, and dQ and dK get nothing from it. (exp(S - lse) would
    give 1 there: in f32, lse = NEG_INF + log(Sk) rounds to NEG_INF.)
    scale: of the scores, 1/sqrt(D) by default."""
    group = _gqa_group(q, k)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    k_full, v_full = _repeat_kv(k, group), _repeat_kv(v, group)
    s = _masked_scores(q, k_full, causal, window, scale)
    p = torch.exp(s - lse.reshape(b, h, sq, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v_full.float())
    ds = p * (dp - delta.reshape(b, h, sq, 1)) * scale
    keep = _keep(sq, sk, causal, window, q.device)
    if keep is not None:
        no_key = ~keep.any(-1, keepdim=True)
        p = torch.where(keep, p, no_key.float() / sk)
        ds = torch.where(keep, ds, 0.0)
    return p, ds, k_full


def flash_attention_dq_plain(q, k, v, do, lse, delta, causal: bool = False,
                             window: int | None = None, scale=None):
    """The dQ kernel's plain PyTorch version on any device: dQ = dS . K in
    q's dtype. lse and delta are (B*H, Sq) f32; scale as in
    `_bwd_plain_parts`."""
    _, ds, k_full = _bwd_plain_parts(q, k, v, do, lse, delta, causal, window,
                                     scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k_full.float()).to(q.dtype)


def flash_attention_dkv_plain(q, k, v, do, lse, delta, causal: bool = False,
                              window: int | None = None, scale=None):
    """The dK/dV kernel's plain PyTorch version on any device:
    dV = P^T . dO and dK = dS^T . Q, summed over each kv head's GQA group,
    in k's and v's dtype; scale as in `_bwd_plain_parts`."""
    p, ds, _ = _bwd_plain_parts(q, k, v, do, lse, delta, causal, window,
                                scale)
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
flash_attention.input_copies = 0
