"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold it to its plain
versions.

    python3 chip_smoke.py [--seed N]

Phases (each raises on failure; the script then exits non-zero):
  card     nvidia-smi name and power limit, torch and CUDA versions
  build    libtpunet.so (make) and every csrc/*.cu kernel (nvcc, always
           rebuilt), in parallel from the sources of this checkout;
           ptxas's registers and spills per kernel function, and the count
           of tensor-core instructions (HGMMA, HMMA) per function from
           cuobjdump -sass. Fails if a bf16 flash_fwd, or D <= 128
           flash_dq or flash_dkv, function has no HGMMA, no ptxas report or
           spills
  kernels  flash_fwd against its plain version on the card at the serving
           shapes (B=1 and 8, S=512, 16 heads, 4 kv heads, D=128, causal,
           bf16 and f32), the training shape (B=4, S=2048, 16 kv heads,
           bf16), a ragged length (401), a window (128), non-causal
           Sq != Sk, bf16 head dims 64, 96 and 256 with GQA-8 and ragged
           Sq != Sk, and rows that see no key (Sq 517, Sk 401, window 16,
           bf16 and f32); each also bitwise equal on a second launch;
           then the backward kernels flash_dq and flash_dkv against theirs
           at the training shape (bf16 and f32), GQA (4 kv heads), a
           ragged length (401), a window (128), non-causal Sq 384 / Sk 512,
           bf16 D=64 with GQA-8, bf16 D=256 (the CUDA-core branches) and
           the no-key rows in bf16 and f32. Each output is held to a limit
           on its largest error and to one on every row's error relative
           to that row's norm, and must be finite; each bf16 dQ and dK/dV
           row also shows that the row check sees two planted faults (dQ:
           a k tile or the right kv head left out; dK/dV: a q tile or a GQA
           head left out). Errors, kernel time, bound, plain time and the
           time of scaled_dot_product_attention (its backward alone for
           the backward kernels; with an explicit boolean mask where there
           is a window), and the time of attention_delta at the training
           shape
  model    the 735M GQA Transformer (d2048, 12 layers, 16 heads, 4 kv
           heads, ff 8192, vocab 32000) on a 512-token prompt, flash impl
           against reference impl, in f32 and bf16
  serve    Router + PrefillEngine on this thread and a DecodeWorker on a
           thread, over loopback libtpunet comms, slots 8, max_len 1024:
           8 greedy requests of 64 tokens. On the f32 KV wire (the serving
           path; flash_fwd's launches are counted over exactly this run)
           the tokens must equal a single-host BatchServer's; on the int8
           wire the codec's wire ratio is read over a reset() window.
  train    the training path: the 735M MHA Transformer (d2048, 12 layers,
           16 heads, ff 8192, vocab 32000; bf16 compute, f32 master
           weights, flash attention, remat), adamw 3e-4, global batch
           8 x 2048 over 2 data-parallel ranks spawned on this card and
           joined by loopback tpunet_torch.distributed. fit() takes 4
           steps on a packed stream of token ramps read through
           prefetch_to_device; the gradients are averaged by the DCN
           all-reduce on the f32 wire. Every kernel counter is zeroed just
           before fit() and read just after, in each rank. The ranks' final
           params must be bitwise equal to each other and to a single
           process that applies the mean of the two half-batch gradients,
           and the loss must be finite and falling. One more step on a
           bf16-wire communicator with grad_compression="bf16" must leave
           the ranks bitwise equal, with a codec wire ratio of 0.5.
Then one JSON line describing each kernel (launches from the train phase,
tensor-core instructions of the function the bf16 D=128 path runs) and,
last, the device line.

TF32 is off throughout (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 are False), so f32 references are true f32.
Weights are random, drawn from --seed at the flax initialisers' scales.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

# Deterministic cuBLAS across the two serving threads' handles and across
# the training ranks and their single-process reference.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

DEVICE = "cuda"
MODEL_735M = dict(vocab=32000, d_model=2048, n_layers=12, n_heads=16,
                  n_kv_heads=4, d_ff=8192, mlp_impl="gelu")
# The headline training configuration of benchmarks/tpu_headline.py: MHA.
MODEL_TRAIN = dict(vocab=32000, d_model=2048, n_layers=12, n_heads=16,
                   d_ff=8192, mlp_impl="gelu")
TRAIN_RANKS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 4, 2048, 4, 3e-4
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense bf16 tensor cores
              torch.float32: 67e12}     # f32 outside the tensor cores
TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-5}
# Backward tolerances of tests/test_ops.py's gradient tests, relative to
# max(1, max|reference|).
BWD_TOL = {torch.bfloat16: 1e-1, torch.float32: 5e-5}
# A second check that scales with each output row (one position of one head,
# over D): the row's error norm over the reference row's norm. The limits
# sit between the largest reading of sound runs and the smallest reading of
# the planted faults (_planted_dq_faults, _planted_dkv_faults); PERF.md
# gives both. A row of (near) zero reference norm is held to ROW_FLOOR of
# the largest row instead of its own norm: a dQ row that sees one key is 0
# exactly (dP = delta there), and the cancellation leaves noise of up to
# 7e-7 of the largest row in bf16 on the tensor cores (PERF.md).
ROW_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-4}
ROW_FLOOR = {torch.bfloat16: 1e-4, torch.float32: 1e-6}
DKV_TILE = (128, 64)  # flash_dkv_bf16_kernel's k rows and q rows a step
DQ_TILE = (128, 64)   # flash_dq_bf16_kernel's q rows and keys a step
COUNTERS = {"flash_fwd": "kernel_launches", "flash_dq": "flash_dq_launches",
            "flash_dkv": "flash_dkv_launches"}
# Kernel functions that must issue wgmma (bf16 forward, bf16 dQ and dK/dV
# to D = 128), and the function each kernel runs on the bf16 D = 128 main
# path, by the _short names of csrc/*.cu's instantiations.
TENSOR_CORE_KERNELS = ("flash_fwd_bf16_kernel<", "flash_dq_bf16_kernel<",
                       "flash_dkv_bf16_kernel<")
MAIN_PATH_FUNCTIONS = {"flash_fwd": "flash_fwd_bf16_kernel<128,128>",
                       "flash_dq": "flash_dq_bf16_kernel<128>",
                       "flash_dkv": "flash_dkv_bf16_kernel<128>"}
SASS: dict = {}  # the build phase's tensor-core census, by _short name
BF16, F32 = torch.bfloat16, torch.float32
# Kernel cases, (b, sq, sk, hk, causal, window, dtype, d) with 16 q heads;
# the first of each list is the training shape, which the kernels line
# reports. Rows that see no key: Sq 517, Sk 401, window 16 (qpos >= 416).
FWD_CASES = (
    [(4, 2048, 2048, 16, True, None, BF16, 128)]
    + [c for dt in (BF16, F32) for c in (
        (1, 512, 512, 4, True, None, dt, 128),   # serving
        (8, 512, 512, 4, True, None, dt, 128),
        (1, 401, 401, 4, True, None, dt, 128),   # ragged
        (1, 512, 512, 4, True, 128, dt, 128),    # window
        (2, 384, 512, 4, False, None, dt, 128))]
    # The tensor-core kernel's other head dims, GQA-8 and ragged Sq != Sk.
    + [(2, 401, 517, 2, True, None, BF16, 64),
       (2, 137, 300, 2, True, 64, BF16, 96),
       (1, 300, 401, 2, False, None, BF16, 256),
       (1, 517, 401, 2, True, None, BF16, 256)]
    + [(1, 517, 401, 4, True, 16, dt, 128) for dt in (BF16, F32)])
BWD_CASES = [
    (4, 2048, 2048, 16, True, None, BF16, 128),
    (4, 2048, 2048, 16, True, None, F32, 128),
    (1, 2048, 2048, 4, True, None, BF16, 128),
    (1, 401, 401, 4, True, None, BF16, 128),
    (1, 1024, 1024, 16, True, 128, BF16, 128),
    (2, 384, 512, 4, False, None, BF16, 128),
    (2, 384, 512, 4, False, None, F32, 128),
    (2, 401, 300, 2, True, None, BF16, 64),
    (1, 1024, 1024, 4, True, None, BF16, 256),  # the CUDA-core bf16 branches
    (1, 517, 401, 4, True, 16, BF16, 128),
    (1, 517, 401, 4, True, 16, F32, 128)]


def log(phase: str, **fields) -> None:
    print(f"{phase}: " + json.dumps(fields, default=str), flush=True)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn over `iters` launches, after a warmup."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_card() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    log("card", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))


def phase_build() -> None:
    from tpunet_torch import _native
    from tpunet_torch.ops import _build

    times, errors = {}, []

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
        times[name] = round(time.perf_counter() - t0, 3)

    # Every kernel library is rebuilt, so ptxas reports on each function.
    jobs = [("libtpunet.so", _native.build_native)] + [
        (f"lib{n}.so", lambda n=n: _build.build(n, force=True))
        for n in _build.sources()]
    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    ptxas = _ptxas_report(_build.build_logs)
    SASS.update(_tensor_core_census(_build))
    log("build", seconds=times, ptxas=ptxas, tensor_core_instrs=SASS)
    tc = [f for f in SASS if f.startswith(TENSOR_CORE_KERNELS)]
    missing = [f for f in tc if SASS[f]["HGMMA"] == 0]
    unreported = [f for f in tc if f not in ptxas]
    spills = [f for f in tc if f in ptxas and ptxas[f]["spill_bytes"]]
    if not tc or missing or unreported or spills:
        raise AssertionError(f"tensor-core kernels without HGMMA {missing}, "
                             f"without a ptxas report {unreported} or with "
                             f"register spills {spills}")


def _short(fn: str) -> str:
    """A mangled kernel instantiation as name<args>, e.g.
    flash_fwd_bf16_kernel<128,128>, flash_dq_kernel<bf16,128,64,64>."""
    m = re.search(r"(?<=\d)(flash_\w+?_kernel)I(.+?)EEv", fn)
    if not m:
        return fn
    args = m.group(2).replace("13__nv_bfloat16", "bf16,").replace("Li", "")
    args = args.replace("E", ",").strip(",")
    if args.startswith("f"):
        args = "f32," + args[1:]
    return f"{m.group(1)}<{args}>"


def _ptxas_report(logs: dict) -> dict:
    """{kernel: {"registers": n, "spill_bytes": n}} from nvcc's -Xptxas -v
    output. Registers are the launch allocation; the tensor-core kernels'
    consumer warpgroups raise theirs to 232 with setmaxnreg."""
    out, fn = {}, None
    for text in logs.values():
        for ln in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                fn = _short(m.group(1))
                out[fn] = {"registers": None, "spill_bytes": 0}
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m and fn:
                out[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m and fn:
                out[fn]["registers"] = int(m.group(1))
    return out


def _cuobjdump() -> str:
    """cuobjdump from the CUDA toolkit, else the copy Triton ships."""
    for root in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        cand = Path(root) / "bin" / "cuobjdump"
        if root and cand.exists():
            return str(cand)
    import importlib.util

    spec = importlib.util.find_spec("triton")
    if spec and spec.origin:
        cand = (Path(spec.origin).parent / "backends" / "nvidia" / "bin"
                / "cuobjdump")
        if cand.exists():
            return str(cand)
    raise RuntimeError("cuobjdump not found")


def _tensor_core_census(build) -> dict:
    """{kernel function: {"HGMMA": n, "HMMA": n}} from each kernel
    library's SASS: wgmma issues as HGMMA, mma.sync as HMMA."""
    census = {}
    for name in build.sources():
        lib = build.BUILD_DIR / f"lib{name}.so"
        sass = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        fn = None
        for ln in sass.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                fn = _short(m.group(1))
                census[fn] = {"HGMMA": 0, "HMMA": 0}
            elif fn and "HGMMA" in ln:
                census[fn]["HGMMA"] += 1
            elif fn and "HMMA" in ln:
                census[fn]["HMMA"] += 1
    return census


def _tensor_core_instrs(kernel: str) -> int:
    """HGMMA + HMMA instructions of the instantiation that the main path
    runs (bf16, D = 128)."""
    c = SASS[MAIN_PATH_FUNCTIONS[kernel]]
    return c["HGMMA"] + c["HMMA"]


def _pairs(sq, sk, causal, window) -> int:
    """Unmasked (q, k) pairs of one (batch, head)."""
    if not causal:
        return sq * sk
    qp = np.arange(sq)[:, None]
    kp = np.arange(sk)[None, :]
    keep = qp >= kp
    if window is not None:
        keep &= (qp - kp) < window
    return int(keep.sum())


def _bound(flops, nbytes, dtype) -> dict:
    """The least time the card could take: the larger of the operations
    over the peak rate of their type and the bytes over HBM's rate."""
    t_flops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=max(t_flops, t_bytes) * 1e3,
                bound_by="operations" if t_flops >= t_bytes else "bytes")


def _attention_work(kind, b, sq, sk, h, hk, d, causal, window, dtype):
    """(flops, bytes) one kernel must do on these inputs; each input read
    once, each output written once. Per unmasked (q, k) pair: the forward
    4*D flops (q.k and p.v), dQ 6*D (q.k, dO.v, dS.k), dK/dV 8*D (q.k,
    dO.v, P^T.dO, dS^T.q)."""
    pair_flops = {"flash_fwd": 4, "flash_dq": 6, "flash_dkv": 8}[kind] * d
    item = torch.tensor([], dtype=dtype).element_size()
    q_bytes, kv_bytes = b * sq * h * d * item, b * sk * hk * d * item
    rows_f32 = b * h * sq * 4  # one f32 per query row: lse, delta
    if kind == "flash_fwd":  # q, k, v in; o, lse out
        nbytes = 2 * q_bytes + 2 * kv_bytes + rows_f32
    elif kind == "flash_dq":  # q, k, v, dO, lse, delta in; dQ out
        nbytes = 3 * q_bytes + 2 * kv_bytes + 2 * rows_f32
    else:  # q, k, v, dO, lse, delta in; dK, dV out
        nbytes = 2 * q_bytes + 4 * kv_bytes + 2 * rows_f32
    return pair_flops * b * h * _pairs(sq, sk, causal, window), nbytes


def _row_err(got, want, floor=None) -> float:
    """max over rows of |got - want| / |want|, norms over the last dim; a
    reference row of (near) zero norm is held to `floor` (by default
    ROW_FLOOR[want's dtype]) of the largest."""
    g, w = got.float(), want.float()
    floor = ROW_FLOOR[want.dtype] if floor is None else floor
    den = w.norm(dim=-1)
    den = den.clamp_min(max(floor * float(den.max()), 1e-30))
    return float(((g - w).norm(dim=-1) / den).max())


def _planted_dkv_faults(q, k, v, do, lse, delta, causal, window, got,
                        want) -> dict:
    """Readings of two dK/dV faults, planted in the kernel's own outputs by
    taking away the exact f32 contribution of the work they skip: the row
    check's (_row_err) and the max-error check's (largest error over
    max(1, max|ref|), which BWD_TOL bounds). The faults:
      q_tile_start: every k tile after the first skips its first q tile
                    (a causal loop start one tile late);
      gqa_head:     the last q head of each GQA group is left out."""
    from tpunet_torch.ops.flash_attention import _bwd_plain_parts

    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    group = h // hk
    p, ds, _ = _bwd_plain_parts(q, k, v, do, lse, delta, causal, window)
    bk, bq = DKV_TILE
    tile = torch.zeros((sq, sk), device=q.device)
    for k0 in range(bk, sk, bk):
        q0 = (k0 // bq) * bq if causal else 0
        tile[q0:q0 + bq, k0:k0 + bk] = 1
    masks = {"q_tile_start": tile[None, None]}
    if group > 1:
        heads = (torch.arange(h, device=q.device) % group) == group - 1
        masks["gqa_head"] = heads.float()[None, :, None, None]
    out = {}
    for name, mask in masks.items():
        row_err, max_err = 0.0, 0.0
        for g, w, x, y in zip(got, want, (ds, p), (q, do)):
            part = torch.einsum("bhqk,bqhd->bkhd", x * mask, y.float())
            bad = g.float() - part.reshape(b, sk, hk, group, d).sum(3)
            row_err = max(row_err, _row_err(bad, w))
            w = w.float()
            max_err = max(max_err, float((bad - w).abs().max())
                          / max(1.0, float(w.abs().max())))
        out[name] = dict(row_err=row_err, max_err=max_err)
    return out


def _planted_dq_faults(q, k, v, do, lse, delta, causal, window, got,
                       want) -> dict:
    """Readings of two dQ faults, planted in the kernel's own output as
    _planted_dkv_faults does: the row check's and the max-error check's.
    The faults:
      last_k_tile: every 128-row q tile leaves out the last 64-key tile its
                   loop visits (a causal loop end one tile early): the exact
                   f32 dS.K of that tile is taken away;
      kv_head:     every q head reads the next kv head's K and V
                   ((h // group + 1) % Hkv): the exact f32 change of dQ that
                   this makes is added.
    got and want are 1-tuples (dQ), as the row loop holds them."""
    from tpunet_torch.ops.flash_attention import _bwd_plain_parts

    (got,), (want,) = got, want
    sq, sk = q.shape[1], k.shape[1]
    _, ds, k_full = _bwd_plain_parts(q, k, v, do, lse, delta, causal, window)
    bq, bk = DQ_TILE
    n_kt = -(-sk // bk)
    tile = torch.zeros((sq, sk), device=q.device)
    for q0 in range(0, sq, bq):
        kt_end = min(n_kt, -(-(q0 + bq) // bk)) if causal else n_kt
        tile[q0:q0 + bq, (kt_end - 1) * bk:kt_end * bk] = 1
    bad = {"last_k_tile": got.float() - torch.einsum(
        "bhqk,bkhd->bqhd", ds * tile, k_full.float())}
    del tile
    if k.shape[2] > 1:
        kr, vr = k.roll(-1, dims=2), v.roll(-1, dims=2)
        _, ds_w, k_w = _bwd_plain_parts(q, kr, vr, do, lse, delta, causal,
                                        window)
        bad["kv_head"] = got.float() + torch.einsum(
            "bhqk,bkhd->bqhd", ds_w, k_w.float()) - torch.einsum(
            "bhqk,bkhd->bqhd", ds, k_full.float())
        del ds_w, k_w
    w = want.float()
    scale = max(1.0, float(w.abs().max()))
    return {name: dict(row_err=_row_err(x, want),
                       max_err=float((x - w).abs().max()) / scale)
            for name, x in bad.items()}


def _sdpa_inputs(q, k, v, causal, window):
    """(q, k, v, kwargs) for scaled_dot_product_attention in its (B, H, S,
    D) layout: is_causal and GQA where there is no window; with a window an
    explicit boolean mask and K/V repeated to q's heads beforehand (outside
    any timed call), since masked calls may not take GQA."""
    from tpunet_torch.ops.flash_attention import _keep

    if window is None:
        kw = dict(is_causal=causal, enable_gqa=True)
    else:
        group = q.shape[2] // k.shape[2]
        k, v = (x.repeat_interleave(group, dim=2) for x in (k, v))
        kw = dict(attn_mask=_keep(q.shape[1], k.shape[1], causal, window,
                                  q.device))
    return (*(x.transpose(1, 2) for x in (q, k, v)), kw)


def _qkv(gen, b, sq, sk, h, hk, d, dt, n_q=1):
    """Random q (and n_q - 1 more q-shaped tensors), k, v on the card."""
    qs = [torch.randn((b, sq, h, d), generator=gen, device=DEVICE).to(dt)
          for _ in range(n_q)]
    k = torch.randn((b, sk, hk, d), generator=gen, device=DEVICE).to(dt)
    v = torch.randn((b, sk, hk, d), generator=gen, device=DEVICE).to(dt)
    return (*qs, k, v)


def _case(b, sq, sk, hk, causal, window, dt) -> dict:
    return dict(b=b, sq=sq, sk=sk, h=16, hk=hk, causal=causal, window=window,
                dtype=str(dt).replace("torch.", ""))


def phase_kernels(seed: int) -> dict:
    """flash_fwd's rows; returns the training shape's row."""
    import torch.nn.functional as F

    from tpunet_torch.ops.flash_attention import (flash_attention_fwd,
                                                  flash_attention_plain)

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    h = 16
    rows = []
    for b, sq, sk, hk, causal, window, dt, d in FWD_CASES:
        q, k, v = _qkv(gen, b, sq, sk, h, hk, d, dt)
        o, lse = flash_attention_fwd(q, k, v, causal, window)
        o_ref, lse_ref = flash_attention_plain(q, k, v, causal, window)
        again = flash_attention_fwd(q, k, v, causal, window)
        torch.cuda.synchronize()
        deterministic = torch.equal(o, again[0]) and torch.equal(lse, again[1])
        err_o = float((o.float() - o_ref.float()).abs().max())
        err_lse = float((lse - lse_ref).abs().max())
        row_err = _row_err(o, o_ref)
        finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
        ok = (err_o <= TOL[dt] and err_lse <= TOL[dt]
              and row_err <= ROW_TOL[dt] and deterministic and finite)
        row = dict(kernel="flash_fwd",
                   **_case(b, sq, sk, hk, causal, window, dt), d=d,
                   err_o=err_o, err_lse=err_lse, tol=TOL[dt],
                   row_err=row_err, row_tol=ROW_TOL[dt],
                   deterministic=deterministic, finite=finite, ok=ok,
                   ms=cuda_ms(lambda: flash_attention_fwd(q, k, v, causal,
                                                          window)),
                   plain_ms=cuda_ms(lambda: flash_attention_plain(
                       q, k, v, causal, window)),
                   **_bound(*_attention_work("flash_fwd", b, sq, sk, h, hk,
                                             d, causal, window, dt), dt))
        qt, kt, vt, kw = _sdpa_inputs(q, k, v, causal, window)
        row["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw))
        del qt, kt, vt, kw
        rows.append(row)
        log("kernels", **row)
        del q, k, v, o, lse, o_ref, lse_ref, again
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_fwd disagrees with its plain version: "
                             f"{bad}")
    return rows[0]  # the training shape: B=4, S=2048, MHA, bf16, causal


def _sdpa_backward_ms(q, k, v, do, causal, window) -> float:
    """Time of scaled_dot_product_attention's backward alone (dQ, dK and dV
    together) on the same inputs and cotangent."""
    import torch.nn.functional as F

    qt, kt, vt, kw = _sdpa_inputs(q, k, v, causal, window)
    qt, kt, vt = (x.detach().requires_grad_() for x in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qt, kt, vt, **kw)
    dot = do.transpose(1, 2)
    return cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                               retain_graph=True))


def phase_bwd_kernels(seed: int) -> dict:
    """flash_dq's and flash_dkv's rows; returns {kernel: training-shape
    row}."""
    from tpunet_torch.ops.flash_attention import (_launch_dkv, _launch_dq,
                                                  attention_delta,
                                                  flash_attention_dkv_plain,
                                                  flash_attention_dq_plain,
                                                  flash_attention_fwd)

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 1)
    h = 16
    rows, main = [], {}
    launch = {"flash_dq": _launch_dq, "flash_dkv": _launch_dkv}
    plain = {"flash_dq": flash_attention_dq_plain,
             "flash_dkv": flash_attention_dkv_plain}
    # The check must see these faults, or it proves nothing.
    planters = {"flash_dq": _planted_dq_faults,
                "flash_dkv": _planted_dkv_faults}
    for b, sq, sk, hk, causal, window, dt, d in BWD_CASES:
        q, do, k, v = _qkv(gen, b, sq, sk, h, hk, d, dt, n_q=2)
        o, lse = flash_attention_fwd(q, k, v, causal, window)
        delta = attention_delta(o, do)
        if not rows:  # delta = rowsum(dO * O), a plain reduction
            item = q.element_size()
            log("delta", **_case(b, sq, sk, hk, causal, window, dt), d=d,
                ms=cuda_ms(lambda: attention_delta(o, do)),
                **_bound(2 * b * h * sq * d, 2 * b * sq * h * d * item
                         + b * h * sq * 4, torch.float32))
        args = (q, k, v, do, lse, delta, causal, window)
        got = {"flash_dq": (_launch_dq(*args),),
               "flash_dkv": _launch_dkv(*args)}
        want = {"flash_dq": (flash_attention_dq_plain(*args),),
                "flash_dkv": flash_attention_dkv_plain(*args)}
        torch.cuda.synchronize()
        library = _sdpa_backward_ms(q, k, v, do, causal, window)
        for name in ("flash_dq", "flash_dkv"):
            err, scale, row_err, tight = 0.0, 1.0, 0.0, 0.0
            for g, w in zip(got[name], want[name]):
                err = max(err, float((g.float() - w.float()).abs().max()))
                scale = max(scale, float(w.float().abs().max()))
                row_err = max(row_err, _row_err(g, w))
                # Reported, not held: the f32 floor shows the cancellation
                # noise of rows that are exactly 0 (ROW_FLOOR's note).
                tight = max(tight, _row_err(g, w, ROW_FLOOR[torch.float32]))
            finite = all(bool(torch.isfinite(g).all()) for g in got[name])
            again = launch[name](*args)
            deterministic = all(torch.equal(x, y) for x, y in zip(
                got[name], again if isinstance(again, tuple) else (again,)))
            del again
            planted = {}
            if dt == torch.bfloat16:
                planted = planters[name](*args, got[name], want[name])
            ok = (err <= BWD_TOL[dt] * scale and row_err <= ROW_TOL[dt]
                  and all(x["row_err"] > ROW_TOL[dt]
                          for x in planted.values())
                  and deterministic and finite)
            row = dict(kernel=name, **_case(b, sq, sk, hk, causal, window, dt),
                       d=d, max_abs_err=err, ref_scale=scale,
                       tol=BWD_TOL[dt] * scale, row_err=row_err,
                       row_tol=ROW_TOL[dt], row_err_f32_floor=tight,
                       planted_fault_row_err=planted,
                       ok=ok, deterministic=deterministic, finite=finite,
                       ms=cuda_ms(lambda: launch[name](*args)),
                       plain_ms=cuda_ms(lambda: plain[name](*args)),
                       **_bound(*_attention_work(name, b, sq, sk, h, hk, d,
                                                 causal, window, dt), dt),
                       library_ms=library)
            rows.append(row)
            log("kernels", **row)
            main.setdefault(name, row)
        del q, do, k, v, o, lse, delta, args, got, want
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"a backward kernel disagrees with its plain "
                             f"version: {bad}")
    return main


def _prompts(seed: int, n: int, vocab: int):
    rng = np.random.default_rng(seed)
    lens = rng.choice(np.arange(128, 513), size=n, replace=False)
    if all(x % 64 == 0 for x in lens):
        lens[0] -= 1
    return [rng.integers(0, vocab, int(x)).astype(np.int32) for x in lens]


def phase_model(seed: int):
    from tpunet_torch.models import Transformer, init_params

    meta = Transformer(compute_dtype=torch.float32, device="meta",
                       **MODEL_735M)
    p32 = init_params(meta, seed=seed, device=DEVICE)
    n_params = sum(t.numel() for t in p32.values())
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, MODEL_735M["vocab"], (1, 512)), device=DEVICE)
    out = {}
    for dt, min_agree in ((torch.float32, 0.99), (torch.bfloat16, 0.9)):
        params = {k: (t if k.endswith(".scale") else t.to(dt))
                  for k, t in p32.items()}
        logits = {}
        for impl in ("flash", "reference"):
            m = Transformer(compute_dtype=dt, attn_impl=impl, device="meta",
                            **MODEL_735M).bind(params)
            with torch.no_grad():
                logits[impl] = m(tokens)
        err = float((logits["flash"] - logits["reference"]).abs().max())
        agree = float((logits["flash"].argmax(-1)
                       == logits["reference"].argmax(-1)).float().mean())
        finite = bool(torch.isfinite(logits["flash"]).all())
        scale = float(logits["reference"].abs().max())
        name = str(dt).replace("torch.", "")
        log("model", dtype=name, params=n_params, max_abs_logit_err=err,
            max_abs_logit=scale, argmax_agreement=agree, finite=finite)
        if not finite or agree < min_agree or (
                dt == torch.float32 and err > 1e-3):
            raise AssertionError(f"{name} flash forward disagrees with the "
                                 f"reference impl: err {err}, agreement "
                                 f"{agree}")
        out[name] = params
        del logits
    return out["bfloat16"]


def _serve_tier(model, params, prompts, max_new, kv_codec, count=None):
    """One frontend (this thread) + one decode rank (a thread) over
    loopback comms. `count` runs just before the first submit (the kernel
    counters are zeroed there) and just after the last result."""
    from tpunet_torch import serve

    lsock = serve.Router.listen("127.0.0.1:0")
    addr = "127.0.0.1:%d" % lsock.getsockname()[1]
    box = {}

    def decode_main():
        try:
            worker = serve.connect_decode(addr, model, params, slots=8,
                                          max_len=1024, kv_codec=kv_codec,
                                          device=DEVICE)
            try:
                worker.serve()
            finally:
                worker.close()
        except BaseException as e:  # noqa: BLE001 — surfaced below
            box["err"] = e

    th = threading.Thread(target=decode_main, daemon=True)
    th.start()
    pe = serve.PrefillEngine(model, params, max_len=1024, device=DEVICE)
    router = serve.Router(pe, kv_codec=kv_codec)
    try:
        router.accept_ranks(lsock, 1)
        lsock.close()
        if count:
            count("start")
        t0 = time.perf_counter()
        ids = [router.submit(p, max_new) for p in prompts]
        results = router.run(timeout=600)
        wall = time.perf_counter() - t0
        if count:
            count("stop")
    finally:
        router.shutdown()
        th.join(timeout=120)
        router.close()
    if "err" in box:
        raise box["err"]
    if th.is_alive():
        raise RuntimeError("decode worker did not exit")
    return [results[i] for i in ids], router, wall


def _latency(router, ntok: int, wall: float) -> dict:
    """TTFT/TPOT medians from the router's per-request samples, the decode
    rate of the concurrent streams (sum over requests of 1/TPOT) and the
    end-to-end rate (tokens over the tier's wall time)."""
    ttft, tpot = router.samples["ttft"], router.samples["tpot"]
    return {"ttft_p50_ms": float(np.percentile(ttft, 50)) / 1e3,
            "tpot_p50_ms": float(np.percentile(tpot, 50)) / 1e3,
            "decode_tokens_per_s": float(sum(1e6 / t for t in tpot)),
            "tokens": ntok, "wall_s": wall, "tokens_per_s": ntok / wall}


def phase_serve(seed: int, params_bf16) -> int:
    from tpunet_torch import telemetry
    from tpunet_torch.models import BatchServer, Transformer
    from tpunet_torch.ops.flash_attention import flash_attention

    model = Transformer(compute_dtype=torch.bfloat16, attn_impl="flash",
                        device="meta", **MODEL_735M)
    prompts = _prompts(seed + 2, 8, model.vocab)
    max_new = 64
    # Single-host reference first (it also warms every shape the tier runs).
    srv = BatchServer(model, params_bf16, slots=8, max_len=1024,
                      device=DEVICE)
    sids = [srv.submit(p, max_new) for p in prompts]
    t0 = time.perf_counter()
    single = srv.run()
    single_wall = time.perf_counter() - t0
    single = [single[i] for i in sids]

    counts = {}

    def count(event):
        if event == "start":
            flash_attention.kernel_launches = 0
        else:
            counts["flash_fwd"] = flash_attention.kernel_launches

    telemetry.reset()
    tier, router, wall = _serve_tier(model, params_bf16, prompts, max_new,
                                     "f32", count)
    same = all(np.array_equal(a, b) for a, b in zip(tier, single))
    ntok = sum(len(t) for t in tier)
    log("serve", kv_codec="f32", prompt_lens=[len(p) for p in prompts],
        max_new=max_new, bitwise_equal_single_host=same,
        flash_fwd_launches=counts["flash_fwd"],
        **_latency(router, ntok, wall), single_host_wall_s=single_wall,
        single_host_tokens_per_s=ntok / single_wall, router=router.stats)
    if not same or any(len(t) != max_new for t in tier):
        raise AssertionError("f32-wire tier tokens differ from the "
                             "single-host BatchServer's")
    if counts["flash_fwd"] <= 0:
        raise AssertionError("the serving path never launched flash_fwd")

    telemetry.reset()
    tier8, router8, wall8 = _serve_tier(model, params_bf16, prompts, max_new,
                                        "int8")
    m = telemetry.metrics()
    ratio = next(iter(m["tpunet_codec_wire_ratio"].values()))
    agree = float(np.mean([np.mean(a == b) for a, b in zip(tier8, single)]))
    log("serve", kv_codec="int8", codec_wire_ratio=ratio,
        token_agreement_with_f32=agree,
        **_latency(router8, sum(len(t) for t in tier8), wall8))
    if abs(ratio - 0.25390625) > 1e-6 or any(len(t) != max_new
                                             for t in tier8):
        raise AssertionError(f"int8 tier: wire ratio {ratio}")
    return counts["flash_fwd"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ramp_data(seed: int) -> str:
    """A learnable token stream: ramps (t, t+1, ...) of random starts and
    lengths, packed into a flat file under build/ by pack_documents; about
    48 windows of TRAIN_SEQ + 1 tokens."""
    from tpunet_torch.data import pack_documents

    vocab = MODEL_TRAIN["vocab"]
    rng = np.random.default_rng(seed + 3)
    docs, total = [], 0
    while total < 48 * TRAIN_SEQ + 1:
        n = int(rng.integers(64, 1024))
        docs.append((int(rng.integers(0, vocab)) + np.arange(n)) % vocab)
        total += n
    path = Path(__file__).resolve().parent / "build" / "chip_smoke"
    path.mkdir(parents=True, exist_ok=True)
    path = str(path / "ramps.bin")
    pack_documents(iter(docs), path, vocab=vocab)
    return path


def _train_setup(seed: int):
    """(model, tx, state) of the headline training configuration; the f32
    master weights come from `seed`, identically in every process."""
    from tpunet_torch.models import Transformer
    from tpunet_torch.train import adamw, create_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = Transformer(compute_dtype=torch.bfloat16, attn_impl="flash",
                        remat=True, device="meta", **MODEL_TRAIN)
    tx = adamw(TRAIN_LR)
    state, _ = create_train_state(model, seed, None, tx, device=DEVICE)
    return model, tx, state


def _params_crc(params: dict) -> int:
    """CRC32C of the flat f32 params, in state_dict order."""
    from tpunet_torch.transport import crc32c

    crc = 0
    for t in params.values():
        crc = crc32c(t.detach().cpu().numpy(), crc)
    return crc


def _train_batches(path: str, rank: int, seed: int):
    from tpunet_torch.data import TokenDataset, token_batches

    ds = TokenDataset(path, seq=TRAIN_SEQ, vocab=MODEL_TRAIN["vocab"])
    return token_batches(ds, TRAIN_BATCH, rank=rank, world=TRAIN_RANKS,
                         seed=seed)


def _train_rank_body(rank: int, ports, path: str, seed: int) -> dict:
    from tpunet_torch import distributed, interop, telemetry
    from tpunet_torch.ops.flash_attention import flash_attention
    from tpunet_torch.train import fit, make_train_step

    distributed.initialize(f"127.0.0.1:{ports[0]}", rank, TRAIN_RANKS)
    model, tx, state = _train_setup(seed)
    step = make_train_step(model, tx, cross_host=True)
    logs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    interop.dcn_reduce_stats_reset()
    for attr in COUNTERS.values():
        setattr(flash_attention, attr, 0)
    t0 = time.perf_counter()
    state = fit(state, step, _train_batches(path, rank, seed),
                steps=TRAIN_STEPS, log_every=1, log_fn=logs.append,
                prefetch=2, prefetch_device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: getattr(flash_attention, a) for n, a in COUNTERS.items()}
    out = dict(rank=rank, params=sum(t.numel() for t in state.params.values()),
               losses=[m["loss"] for m in logs],
               step_s=[1.0 / m["steps_per_s"] for m in logs], fit_wall_s=wall,
               launches=launches, all_reduce=interop.dcn_reduce_stats(),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               crc=_params_crc(state.params))
    distributed.finalize()

    # One more step with bf16 on the wire: the trainer ships f32 and the
    # ring halves it at the hops.
    distributed.initialize(f"127.0.0.1:{ports[1]}", rank, TRAIN_RANKS,
                           wire_dtype="bf16")
    step16 = make_train_step(model, tx, cross_host=True,
                             grad_compression="bf16")
    x, y = next(_train_batches(path, rank, seed + 1))
    telemetry.reset()
    state, loss16 = step16(state, x, y, 0)
    m = telemetry.metrics()
    out.update(bf16_loss=float(loss16), bf16_crc=_params_crc(state.params),
               bf16_wire_ratio=next(iter(
                   m["tpunet_codec_wire_ratio"].values())))
    distributed.finalize()
    return out


def _train_rank(rank: int, ports, path: str, seed: int, q) -> None:
    """Entry point of a spawned training rank; reports to `q`."""
    try:
        q.put((rank, "OK", _train_rank_body(rank, ports, path, seed)))
    except Exception:  # noqa: BLE001 — reported to the parent
        q.put((rank, "FAIL", traceback.format_exc()))


def _train_reference(path: str, seed: int):
    """The same steps in one process: each rank's half-batch gradients
    computed apart, then (g0 + g1) / 2 applied. Returns (params CRC,
    per-step [loss of rank 0's half, loss of rank 1's half])."""
    from tpunet_torch.train.trainer import _make_loss_fn, _value_and_grads

    model, _, state = _train_setup(seed)
    loss_fn = _make_loss_fn()
    batches = [list(itertools.islice(_train_batches(path, r, seed),
                                     TRAIN_STEPS)) for r in range(TRAIN_RANKS)]
    losses = []
    for i in range(TRAIN_STEPS):
        net = model.bind(state.params, trainable=True)
        halves, step_losses = [], []
        for r in range(TRAIN_RANKS):
            x, y = (torch.as_tensor(a, device=DEVICE).long()
                    for a in batches[r][i])
            loss, grads = _value_and_grads(net, state.params, x, y, loss_fn,
                                           None)
            halves.append(grads)
            step_losses.append(float(loss))
        for n, p in state.params.items():
            p.grad = (halves[0][n] + halves[1][n]) / 2
        del halves
        state.opt_state.step()
        for p in state.params.values():
            p.grad = None
        losses.append(step_losses)
    return _params_crc(state.params), losses


def _mfu_flops_per_token(n_params: int) -> float:
    """Analytic train FLOPs per token of benchmarks/tpu_headline.py: 6 per
    matmul parameter (the embedding table is a lookup and excluded) plus
    attention's 12 * L * S * d."""
    cfg = MODEL_TRAIN
    n_matmul = n_params - cfg["vocab"] * cfg["d_model"]
    return 6 * n_matmul + 12 * cfg["n_layers"] * TRAIN_SEQ * cfg["d_model"]


def phase_train(seed: int) -> dict:
    """The training path on TRAIN_RANKS spawned ranks; returns the summed
    kernel launch counts of the ranks' fit() runs."""
    import multiprocessing as mp

    path = _ramp_data(seed)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    ports = (_free_port(), _free_port())
    procs = [ctx.Process(target=_train_rank, args=(r, ports, path, seed, q))
             for r in range(TRAIN_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    res = {}
    try:
        for _ in procs:
            rank, status, payload = q.get(timeout=900)
            if status != "OK":
                raise RuntimeError(f"training rank {rank} failed:\n{payload}")
            res[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    ranks_wall = time.perf_counter() - t0
    ref_crc, ref_losses = _train_reference(path, seed)
    torch.cuda.empty_cache()

    ranks = [res[r] for r in range(TRAIN_RANKS)]
    n_params = ranks[0]["params"]
    steady = float(np.mean([np.mean(r["step_s"][1:]) for r in ranks]))
    tokens_per_rank = TRAIN_BATCH * TRAIN_SEQ / steady
    flops_tok = _mfu_flops_per_token(n_params)
    global_loss = [float(np.mean(x)) for x in zip(*(r["losses"]
                                                      for r in ranks))]
    rank_losses = [list(x) for x in zip(*(r["losses"] for r in ranks))]
    summary = dict(
        params=n_params, ranks=TRAIN_RANKS, batch_per_rank=TRAIN_BATCH,
        seq=TRAIN_SEQ, steps=TRAIN_STEPS, losses=global_loss,
        rank_losses=rank_losses, reference_losses=ref_losses,
        step_s=[r["step_s"] for r in ranks], steady_step_s=steady,
        tokens_per_s_per_rank=tokens_per_rank,
        tokens_per_s=tokens_per_rank * TRAIN_RANKS,
        flops_per_token=flops_tok,
        mfu=tokens_per_rank * TRAIN_RANKS * flops_tok
        / PEAK_FLOPS[torch.bfloat16],
        peak_mem_gb_per_rank=[r["peak_mem_gb"] for r in ranks],
        all_reduce=[r["all_reduce"] for r in ranks],
        all_reduce_s_per_step=[r["all_reduce"]["seconds"] / TRAIN_STEPS
                               for r in ranks],
        fit_wall_s=[r["fit_wall_s"] for r in ranks], ranks_wall_s=ranks_wall,
        launches=[r["launches"] for r in ranks],
        crc=[r["crc"] for r in ranks], reference_crc=ref_crc,
        bf16_wire_ratio=[r["bf16_wire_ratio"] for r in ranks],
        bf16_crc=[r["bf16_crc"] for r in ranks],
        bf16_loss=[r["bf16_loss"] for r in ranks])
    log("train", **summary)
    if len(set(summary["crc"])) != 1:
        raise AssertionError("the data-parallel ranks' params differ")
    if summary["crc"][0] != ref_crc or rank_losses != ref_losses:
        raise AssertionError("the ranks differ from the single-process "
                             "half-batch-mean reference")
    if not all(np.isfinite(global_loss)) or global_loss[-1] >= global_loss[0]:
        raise AssertionError(f"loss not finite and falling: {global_loss}")
    if len(set(summary["bf16_crc"])) != 1 or any(
            r != 0.5 for r in summary["bf16_wire_ratio"]):
        raise AssertionError("bf16-wire step: ranks differ or wire ratio "
                             f"{summary['bf16_wire_ratio']} != 0.5")
    launches = {n: sum(r["launches"][n] for r in ranks) for n in COUNTERS}
    layer_steps = TRAIN_RANKS * TRAIN_STEPS * MODEL_TRAIN["n_layers"]
    want = {"flash_fwd": 2 * layer_steps, "flash_dq": layer_steps,
            "flash_dkv": layer_steps}
    if launches != want:
        raise AssertionError(f"kernel launches on the train path {launches}, "
                             f"expected {want}")
    return launches


def _kernel_entry(name, source, replaces, launches, row, err_key) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row[err_key], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "tensor_core_instrs": _tensor_core_instrs(name)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import tpunet_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_card()
    phase_build()
    fwd_row = phase_kernels(args.seed)
    bwd_rows = phase_bwd_kernels(args.seed)
    params = phase_model(args.seed)
    phase_serve(args.seed, params)
    del params
    torch.cuda.empty_cache()
    launches = phase_train(args.seed)
    src = "tpunet_torch/csrc/"
    print(json.dumps({"kernels": [
        _kernel_entry("flash_fwd", src + "flash_fwd.cu",
                      "tpunet/ops/flash_attention.py:73",
                      launches["flash_fwd"], fwd_row, "err_o"),
        _kernel_entry("flash_dq", src + "flash_bwd.cu",
                      "tpunet/ops/flash_attention.py:136",
                      launches["flash_dq"], bwd_rows["flash_dq"],
                      "max_abs_err"),
        _kernel_entry("flash_dkv", src + "flash_bwd.cu",
                      "tpunet/ops/flash_attention.py:183",
                      launches["flash_dkv"], bwd_rows["flash_dkv"],
                      "max_abs_err")]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
