"""Build the port's CUDA kernels into plain-C shared libraries for ctypes.

Each ``csrc/<name>.cu`` is compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/tpunet_torch/lib<name>.so csrc/<name>.cu

into ``build/tpunet_torch/`` at the repo root (the ``build/`` entry of
``.gitignore`` covers it), and rebuilt when the source is newer than the
library. The sources include no PyTorch header, so a build takes seconds.
A file lock serialises concurrent builders; the library is written under a
temporary name and renamed into place, so no process loads a half-written
file. Nothing here runs at import time: the CPU-only test environment has
no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpunet_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_loaded: dict[str, ctypes.CDLL] = {}
_mu = threading.Lock()
build_logs: dict[str, str] = {}  # name -> nvcc's -Xptxas -v report


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        cand = Path(root) / "bin" / "nvcc"
        if root and cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build(name: str) -> Path:
    """Compile csrc/<name>.cu if its library is missing or stale; returns
    the library path."""
    src = CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
                return lib
            tmp = lib.with_name(f".{lib.name}.{os.getpid()}")
            cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                   "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
                   str(src)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src.name}:\n"
                                   f"{res.stdout}\n{res.stderr}")
            build_logs[name] = res.stderr
            os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and memoize the kernel library `name`."""
    with _mu:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]


def sources() -> list[str]:
    """Every kernel source of the package, by library name."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))
