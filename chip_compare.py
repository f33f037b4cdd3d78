"""Compare the flash-attention kernels of this checkout with those of another
checkout, on one NVIDIA GPU.

    python3 chip_compare.py OTHER_CHECKOUT

Builds OTHER_CHECKOUT/tpunet_torch/csrc/flash_fwd.cu and flash_bwd.cu
beside this checkout's kernels and runs both builds' entry points through
this checkout's wrappers on the same causal inputs (both C interfaces take
the same arguments): in bf16 the forward, dQ and dK/dV at the training
shape (B4 S2048 H16 D128) and at head dim 256 (B2 S2048 H16), and dQ and
dK/dV at B1 S2048 GQA-4 D128 and B1 S1024 GQA-4 D256; in f32 the forward,
dQ and dK/dV at the training shape, and dQ at D64 (B4 S2048) and D256 (B2
S2048); at head dim 320 (the wide kernels) in bf16, f16 and f32 the
forward, dQ and dK/dV at B1 S1024 H16 GQA-4 and at the wide path's shape,
B2 S1024 H4 with one kv head; and the wide forward alone in bf16, f16 and
f32 at D512 (B1 Sq517 Sk401 H16 GQA-4, window 16: rows that see no key)
and D576 (B1 S1024 H16 GQA-4). Each side's device time (the mean of 20
launches) is taken ten times, in pairs that alternate which side runs
first. For each case and kernel it prints one JSON line: whether the two
builds' outputs are bitwise equal, each side's median and quartiles, and
in how many pairs this checkout was faster; and for each case one line
with the time of scaled_dot_product_attention on the same inputs (its
forward, and where the case times dQ and dK/dV its whole backward alone)
and the backend it ran. Exits non-zero without a GPU.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
ALL = ("flash_fwd", "flash_dq", "flash_dkv")
CASES = [  # kernels, dtype, b, sq, sk, h, hk, d, window (all causal)
    (ALL, BF16, 4, 2048, 2048, 16, 16, 128, None),
    (("flash_dq", "flash_dkv"), BF16, 1, 2048, 2048, 16, 4, 128, None),
    (ALL, BF16, 2, 2048, 2048, 16, 16, 256, None),
    (("flash_dq", "flash_dkv"), BF16, 1, 1024, 1024, 16, 4, 256, None),
    (ALL, F32, 4, 2048, 2048, 16, 16, 128, None),
    (("flash_dq",), F32, 4, 2048, 2048, 16, 16, 64, None),
    (("flash_dq",), F32, 2, 2048, 2048, 16, 16, 256, None),
] + [c for dt in (BF16, F16, F32) for c in (
    (ALL, dt, 1, 1024, 1024, 16, 4, 320, None),
    (ALL, dt, 2, 1024, 1024, 4, 1, 320, None),
    (("flash_fwd",), dt, 1, 517, 401, 16, 4, 512, 16),
    (("flash_fwd",), dt, 1, 1024, 1024, 16, 4, 576, None))]
PAIRS = 10  # timings of each side, alternating which runs first
ENTRIES = {"flash_fwd": "tpunet_flash_fwd",
           "flash_dq": "tpunet_flash_bwd_dq",
           "flash_dkv": "tpunet_flash_bwd_dkv"}
LIBS = {"flash_fwd": "flash_fwd", "flash_dq": "flash_bwd",
        "flash_dkv": "flash_bwd"}


def _build_other(checkout: Path, out_dir: Path, name: str) -> ctypes.CDLL:
    """nvcc of the other checkout's csrc/<name>.cu, with the flags of this
    checkout's build."""
    from tpunet_torch.ops import _build

    src = checkout / "tpunet_torch" / "csrc" / f"{name}.cu"
    lib = out_dir / f"lib{name}_other.so"
    res = subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17",
                          "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                          str(lib), str(src)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    return ctypes.CDLL(str(lib))


@contextlib.contextmanager
def _entry(fa, name: str, fn):
    """This checkout's wrappers call `fn` for the C entry point `name`."""
    mine = fa._fns[name]
    fa._fns[name] = fn
    try:
        yield
    finally:
        fa._fns[name] = mine


def _compare(fa, chip_smoke, kernel, entry, other_fn, run) -> dict:
    """Bitwise equality of the two builds' outputs and their timings in
    alternating pairs."""
    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    this_out = as_tuple(run())
    with _entry(fa, entry, other_fn):
        other_out = as_tuple(run())
    torch.cuda.synchronize()
    equal = all(torch.equal(x, y) for x, y in zip(this_out, other_out))
    ms = {"other": [], "this": []}
    for pair in range(PAIRS):
        order = ("other", "this") if pair % 2 == 0 else ("this", "other")
        for side in order:
            ctx = (_entry(fa, entry, other_fn) if side == "other"
                   else contextlib.nullcontext())
            with ctx:
                ms[side].append(chip_smoke.cuda_ms(run, 20))
    wins = sum(t < o for t, o in zip(ms["this"], ms["other"]))
    return {"kernel": kernel, "bitwise_equal": equal,
            "median_ms": {k: statistics.median(x) for k, x in ms.items()},
            "quartiles_ms": {k: statistics.quantiles(x, n=4)[::2]
                             for k, x in ms.items()},
            "this_faster_pairs": [wins, PAIRS]}


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    fa = importlib.import_module("tpunet_torch.ops.flash_attention")
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: _build_other(Path(sys.argv[1]).resolve(), Path(tmp),
                                   name) for name in set(LIBS.values())}
        other_fns = {}
        for kernel, entry in ENTRIES.items():
            mine = fa._bind(entry)
            fn = getattr(libs[LIBS[kernel]], entry)
            fn.argtypes, fn.restype = mine.argtypes, mine.restype
            other_fns[entry] = fn
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        for kernels, dt, b, sq, sk, h, hk, d, window in CASES:
            q, do = (torch.randn((b, sq, h, d), generator=gen, device="cuda")
                     .to(dt) for _ in range(2))
            k, v = (torch.randn((b, sk, hk, d), generator=gen, device="cuda")
                    .to(dt) for _ in range(2))
            o, lse = fa.flash_attention_fwd(q, k, v, True, window)
            args = (q, k, v, do, lse, fa.attention_delta(o, do), True,
                    window)
            runs = {"flash_fwd": lambda: fa._launch(q, k, v, True, window),
                    "flash_dq": lambda: fa._launch_dq(*args),
                    "flash_dkv": lambda: fa._launch_dkv(*args)}
            case = {"dtype": str(dt).replace("torch.", ""), "b": b,
                    "sq": sq, "sk": sk, "h": h, "hk": hk, "d": d,
                    "causal": True, "window": window}
            for kernel in kernels:
                entry = ENTRIES[kernel]
                row = _compare(fa, chip_smoke, kernel, entry,
                               other_fns[entry], runs[kernel])
                print(json.dumps({**row, **case}), flush=True)
            print(json.dumps({
                "kernel": "sdpa", **case,
                "forward": chip_smoke._library(q, k, v, True, window),
                "backward": (chip_smoke._library(q, k, v, True, window, do)
                             if kernels != ("flash_fwd",) else None)}),
                flush=True)
            del q, do, k, v, o, lse, args
    return 0


if __name__ == "__main__":
    sys.exit(main())
