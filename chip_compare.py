"""Compare the flash-attention backward kernels of this checkout with those
of another checkout, on one NVIDIA GPU.

    python3 chip_compare.py OTHER_CHECKOUT

Builds OTHER_CHECKOUT/tpunet_torch/csrc/flash_bwd.cu beside this
checkout's kernels and runs both builds' dQ and dK/dV entry points through
this checkout's wrappers on the same bf16 causal inputs: the training shape
(B4 S2048 H16 D128), GQA-4 at B1 S2048 D128, and head dim 256 at B2 S2048
H16 and B1 S1024 GQA-4. Each side's device time (the mean of 20
launches) is taken ten times, in pairs that alternate which side runs
first. For each case and kernel it prints one JSON line: whether the two
builds' outputs are bitwise equal, each side's median and quartiles, and
in how many pairs this checkout was faster. Exits non-zero without a GPU.
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

CASES = [  # b, s, h, hk, d
    (4, 2048, 16, 16, 128),
    (1, 2048, 16, 4, 128),
    (2, 2048, 16, 16, 256),
    (1, 1024, 16, 4, 256),
]
PAIRS = 10  # timings of each side, alternating which runs first
ENTRIES = {"flash_dq": "tpunet_flash_bwd_dq",
           "flash_dkv": "tpunet_flash_bwd_dkv"}


def _build_other(checkout: Path, out_dir: Path) -> ctypes.CDLL:
    """nvcc of the other checkout's flash_bwd.cu, with the flags of this
    checkout's build."""
    from tpunet_torch.ops import _build

    src = checkout / "tpunet_torch" / "csrc" / "flash_bwd.cu"
    lib = out_dir / "libflash_bwd_other.so"
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


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    fa = importlib.import_module("tpunet_torch.ops.flash_attention")
    other_fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        other = _build_other(Path(sys.argv[1]).resolve(), Path(tmp))
        for entry in ENTRIES.values():
            mine = fa._bind(entry)
            fn = getattr(other, entry)
            fn.argtypes, fn.restype = mine.argtypes, mine.restype
            other_fns[entry] = fn
        launch = {"flash_dq": fa._launch_dq, "flash_dkv": fa._launch_dkv}
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        for b, s, h, hk, d in CASES:
            q, do = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                     .bfloat16() for _ in range(2))
            k, v = (torch.randn((b, s, hk, d), generator=gen, device="cuda")
                    .bfloat16() for _ in range(2))
            o, lse = fa.flash_attention_fwd(q, k, v, True, None)
            args = (q, k, v, do, lse, fa.attention_delta(o, do), True, None)
            for kernel, entry in ENTRIES.items():
                run = launch[kernel]
                this_out = run(*args)
                with _entry(fa, entry, other_fns[entry]):
                    other_out = run(*args)
                torch.cuda.synchronize()
                outs = [x if isinstance(x, tuple) else (x,)
                        for x in (this_out, other_out)]
                equal = all(torch.equal(x, y) for x, y in zip(*outs))
                ms = {"other": [], "this": []}
                for pair in range(PAIRS):
                    order = ("other", "this") if pair % 2 == 0 else (
                        "this", "other")
                    for side in order:
                        ctx = (_entry(fa, entry, other_fns[entry])
                               if side == "other"
                               else contextlib.nullcontext())
                        with ctx:
                            ms[side].append(chip_smoke.cuda_ms(
                                lambda: run(*args), 20))
                wins = sum(t < o for t, o in zip(ms["this"], ms["other"]))
                print(json.dumps({
                    "kernel": kernel, "b": b, "s": s, "h": h, "hk": hk,
                    "d": d, "causal": True, "bitwise_equal": equal,
                    "median_ms": {k_: statistics.median(x)
                                  for k_, x in ms.items()},
                    "quartiles_ms": {k_: statistics.quantiles(x, n=4)[::2]
                                     for k_, x in ms.items()},
                    "this_faster_pairs": [wins, PAIRS]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
