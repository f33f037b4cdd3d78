"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold it to its plain
versions.

    python3 chip_smoke.py [--seed N]

Phases (each raises on failure; the script then exits non-zero):
  card     nvidia-smi name and power limit, torch and CUDA versions
  build    libtpunet.so (make) and every csrc/*.cu kernel (nvcc), built in
           parallel from the sources of this checkout
  kernels  flash_fwd against its plain version on the card at the serving
           shapes (B=1 and 8, S=512, 16 heads, 4 kv heads, D=128, causal,
           bf16 and f32), a ragged length (401), a window (128) and
           non-causal Sq != Sk; errors, kernel time, bound, plain time and
           scaled_dot_product_attention's time
  model    the 735M GQA Transformer (d2048, 12 layers, 16 heads, 4 kv
           heads, ff 8192, vocab 32000) on a 512-token prompt, flash impl
           against reference impl, in f32 and bf16
  serve    Router + PrefillEngine on this thread and a DecodeWorker on a
           thread, over loopback libtpunet comms, slots 8, max_len 1024:
           8 greedy requests of 64 tokens. On the f32 KV wire (the main
           path; kernel launch counts are read over exactly this run) the
           tokens must equal a single-host BatchServer's; on the int8 wire
           the codec's wire ratio is read over a reset() window.
Then one JSON line describing each kernel and, last, the device line.

TF32 is off throughout (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 are False), so f32 references are true f32.
Weights are random, drawn from --seed at the flax initialisers' scales.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

# Deterministic cuBLAS across the two serving threads' handles.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

DEVICE = "cuda"
MODEL_735M = dict(vocab=32000, d_model=2048, n_layers=12, n_heads=16,
                  n_kv_heads=4, d_ff=8192, mlp_impl="gelu")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense bf16 tensor cores
              torch.float32: 67e12}     # f32 outside the tensor cores
TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-5}


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

    jobs = [("libtpunet.so", _native.build_native)] + [
        (f"lib{n}.so", lambda n=n: _build.build(n)) for n in _build.sources()]
    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    ptxas = [ln.strip() for log_ in _build.build_logs.values()
             for ln in log_.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", seconds=times, ptxas=ptxas)


def _attention_work(b, sq, sk, h, hk, d, causal, window, dtype):
    """(flops, bytes) the attention must do on these inputs: 4*B*H*D per
    unmasked (q, k) pair; each input read once, each output written once."""
    qp = np.arange(sq)[:, None]
    kp = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep = qp >= kp
        if window is not None:
            keep &= (qp - kp) < window
    pairs = int(keep.sum())
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * sq * h * d + 2 * b * sk * hk * d) * item + b * h * sq * 4
    return 4 * b * h * d * pairs, nbytes


def phase_kernels(seed: int) -> dict:
    import torch.nn.functional as F

    from tpunet_torch.ops.flash_attention import (flash_attention_fwd,
                                                  flash_attention_plain)

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        cases += [(1, 512, 512, True, None, dt), (8, 512, 512, True, None, dt),
                  (1, 401, 401, True, None, dt), (1, 512, 512, True, 128, dt),
                  (2, 384, 512, False, None, dt)]
    h, hk, d = 16, 4, 128
    rows = []
    for b, sq, sk, causal, window, dt in cases:
        q = torch.randn((b, sq, h, d), generator=gen, device=DEVICE).to(dt)
        k = torch.randn((b, sk, hk, d), generator=gen, device=DEVICE).to(dt)
        v = torch.randn((b, sk, hk, d), generator=gen, device=DEVICE).to(dt)
        o, lse = flash_attention_fwd(q, k, v, causal, window)
        o_ref, lse_ref = flash_attention_plain(q, k, v, causal, window)
        torch.cuda.synchronize()
        err_o = float((o.float() - o_ref.float()).abs().max())
        err_lse = float((lse - lse_ref).abs().max())
        ok = err_o <= TOL[dt] and err_lse <= TOL[dt]
        flops, nbytes = _attention_work(b, sq, sk, h, hk, d, causal, window,
                                        dt)
        t_flops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / HBM_BYTES_PER_S
        row = dict(b=b, sq=sq, sk=sk, causal=causal, window=window,
                   dtype=str(dt).replace("torch.", ""), err_o=err_o,
                   err_lse=err_lse, tol=TOL[dt], ok=ok,
                   ms=cuda_ms(lambda: flash_attention_fwd(q, k, v, causal,
                                                          window)),
                   plain_ms=cuda_ms(lambda: flash_attention_plain(
                       q, k, v, causal, window)),
                   bound_ms=max(t_flops, t_bytes) * 1e3,
                   bound_by="operations" if t_flops >= t_bytes else "bytes",
                   library_ms=None)
        if window is None:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            row["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True))
        rows.append(row)
        log("kernels", **row)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_fwd disagrees with its plain version: "
                             f"{bad}")
    return rows[0]  # the main path's shape: B=1, S=512, bf16, causal


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
    main_row = phase_kernels(args.seed)
    params = phase_model(args.seed)
    launches = phase_serve(args.seed, params)
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "tpunet_torch/csrc/flash_fwd.cu",
        "replaces": "tpunet/ops/flash_attention.py:73",
        "launches": launches, "max_abs_err": main_row["err_o"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
