"""The port stands alone: nothing under tpunet_torch/ (nor chip_smoke.py,
chip_compare.py, chip_broadcast_soak.py and chip_tp_generate_check.py)
imports JAX, flax, optax, orbax or the JAX package,
importing the port leaves them out of sys.modules, and its entry points
refuse to fall back to the CPU when no GPU is present."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tpunet")


def _port_files():
    return sorted((REPO / "tpunet_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "chip_compare.py",
        REPO / "chip_broadcast_soak.py", REPO / "chip_tp_generate_check.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_import_leaves_jax_and_tpunet_unloaded():
    code = ("import sys, tpunet_torch, tpunet_torch.serve, "
            "tpunet_torch.models, tpunet_torch.ops, tpunet_torch.elastic, "
            "tpunet_torch.train.elastic\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(','.join(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_entry_points_raise_without_a_gpu(monkeypatch):
    """device=None means the GPU; on a machine without one every entry
    point raises instead of quietly running on the CPU."""
    from tpunet_torch.models import (BatchServer, Transformer, generate,
                                     init_cache, init_params)
    from tpunet_torch.serve import PrefillEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dict(vocab=16, d_model=16, n_layers=1, n_heads=2, d_ff=16,
               compute_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transformer(**cfg)
    tm = Transformer(device="cpu", **cfg)
    sd = init_params(tm, seed=0, device="cpu")
    for call in (lambda: init_params(tm, seed=0),
                 lambda: init_cache(tm, 1, 8),
                 lambda: BatchServer(tm, sd, slots=1, max_len=8),
                 lambda: PrefillEngine(tm, sd, max_len=8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    out = generate(tm, sd, np.zeros((1, 3), np.int32), 2)
    assert out.device.type == "cpu"  # follows the parameters it was given


def test_training_entry_points_raise_without_a_gpu(monkeypatch):
    """The training slice's entry points resolve device=None to the GPU
    too: without one, create_train_state and prefetch_to_device raise at
    the call instead of quietly running on the CPU."""
    from tpunet_torch.data import prefetch_to_device
    from tpunet_torch.models import Transformer
    from tpunet_torch.train import adamw, create_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = Transformer(device="cpu", vocab=16, d_model=16, n_layers=1,
                     n_heads=2, d_ff=16, compute_dtype=torch.float32)
    tokens = np.zeros((2, 8), np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(tm, 0, tokens, adamw(1e-3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prefetch_to_device(iter([tokens]))
    state, _ = create_train_state(tm, 0, tokens, adamw(1e-3), device="cpu")
    assert next(iter(state.params.values())).device.type == "cpu"
    batch = next(prefetch_to_device(iter([tokens]), device="cpu"))
    assert batch.device.type == "cpu" and batch.shape == (2, 8)


def test_vgg_entry_points_raise_without_a_gpu(monkeypatch):
    """VGG, vgg16, VGG's init_params and create_train_state with a VGG
    resolve device=None to the GPU and raise without one."""
    from tpunet_torch.models import VGG, vgg16
    from tpunet_torch.models.vgg import init_params
    from tpunet_torch.train import create_train_state, sgd, synthetic_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dict(cfg=(8, "M"), num_classes=4, hidden=8, image_size=8,
               compute_dtype=torch.float32)
    images, _ = synthetic_batch(np.random.default_rng(0), 2, 8, 4)
    meta = VGG(device="meta", **cfg)
    for call in (lambda: VGG(**cfg), lambda: vgg16(),
                 lambda: init_params(meta, seed=0),
                 lambda: meta.init_params(seed=0),
                 lambda: create_train_state(meta, 0, images, sgd(0.1))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    state, net = create_train_state(meta, 0, images, sgd(0.1), device="cpu")
    assert next(iter(state.params.values())).device.type == "cpu"
    assert net(torch.from_numpy(images)).shape == (2, 4)
