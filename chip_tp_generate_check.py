"""Tensor-parallel greedy decoding against one process, on one card.

    python3 chip_tp_generate_check.py [--news 32 64]

chip_smoke.py's mesh6c (a) inputs (the serve configuration at 6 of its
12 layers from seed 0, 4 prompts cut to one length): 4 ranks over {dp: 2,
mdl: 2} on this card, each dp rank's 2 rows through ``generate`` under
TP, against one process's ``generate`` of the same 2 rows, in f32 and in
bf16, for each count of new tokens (the decode cache is prompt + new
tokens long). The f32 tokens must be equal on every rank (the exit code
says whether they were); the bf16 ones are reported, with each
reference's own agreement across the counts (a bf16 near-tie may part
either way). Prints one JSON line; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

DTYPES = ("float32", "bfloat16")


def _generate_all(model_kw: dict, params: dict, prompts, news, mesh=None):
    """{"<dtype>/<new>": tokens} of `prompts` for every dtype and count."""
    import torch

    from tpunet_torch.models import Transformer, generate

    out = {}
    for dt in DTYPES:
        model = Transformer(compute_dtype=getattr(torch, dt),
                            attn_impl="flash", mesh=mesh, device="meta",
                            **model_kw)
        p = {k: v.float() if dt == "float32" else v
             for k, v in params.items()}
        if mesh is not None:
            p = model.local_params(p)
        x = torch.as_tensor(prompts, device="cuda")
        for n in news:
            out[f"{dt}/{n}"] = generate(model, p, x, n).cpu().numpy()
    return out


def _rank(rank: int, port: int, news, q) -> None:
    import torch

    import chip_smoke as cs
    from tpunet_torch import distributed
    from tpunet_torch.parallel import make_named_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(f"127.0.0.1:{port}", rank, 4)
    mesh = make_named_mesh({"dp": 2, "mdl": 2})
    cfg = cs._mesh6c_serve_model()
    prompts = cs._mesh6c_prompts(0, cfg["vocab"])
    dp = mesh.axis_index("dp")
    out = _generate_all(dict(cfg, tp_axis="mdl"), cs._bf16_checkpoint(0, cfg),
                        prompts[2 * dp:2 * dp + 2], news, mesh)
    mesh.close()
    distributed.finalize()
    q.put((rank, dp, out))


def _first_difference(a, b) -> str:
    diff = np.argwhere(a != b)
    return ("equal" if not len(diff)
            else f"row {diff[0][0]} col {diff[0][1]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--news", type=int, nargs="+", default=[32, 64])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_tp_generate_check: no CUDA device", file=sys.stderr)
        return 2
    import multiprocessing as mp

    import chip_smoke as cs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = cs._free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, args.news, q))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        got = [q.get(timeout=600) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    cfg = cs._mesh6c_serve_model()
    full = cs._bf16_checkpoint(0, cfg)
    prompts = cs._mesh6c_prompts(0, cfg["vocab"])
    ref = [_generate_all(cfg, full, prompts[2 * d:2 * d + 2], args.news)
           for d in range(2)]
    report = {"card": card.strip(), "prompt_len": int(prompts.shape[1]),
              "seconds": time.perf_counter() - t0, "ranks": {},
              "references_across_news": {}}
    ok = True
    for rank, dp, out in sorted(got, key=lambda g: g[0]):
        row = {k: _first_difference(v, ref[dp][k]) for k, v in out.items()}
        ok &= all(row[f"float32/{n}"] == "equal" for n in args.news)
        report["ranks"][rank] = row
    short = min(args.news)
    for dt in DTYPES:
        for n in args.news:
            report["references_across_news"][f"{dt}/{short} vs {n}"] = [
                _first_difference(r[f"{dt}/{short}"],
                                  r[f"{dt}/{n}"][:, :r[f"{dt}/{short}"]
                                                 .shape[1]]) for r in ref]
    report["f32_equal"] = ok
    print(json.dumps(report), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
