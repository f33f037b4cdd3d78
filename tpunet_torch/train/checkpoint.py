"""Checkpoint / resume for training state: the port of
``tpunet/train/checkpoint.py``.

The orbax store is replaced by one ``torch.save`` file per step,
``<directory>/<step>.pt``, holding {params, opt_state, step}: the f32
parameters, the optimizer's ``state_dict()`` (AdamW moments and step
counts) and the step. A file is written under a temporary name and renamed
into place, so a reader never sees half of one. ``max_to_keep`` keeps the
newest steps and deletes the rest. Saving a step that exists raises
``StepAlreadyExistsError`` unless ``force=True``, which overwrites it.
Saves are synchronous, so ``wait_until_finished`` has nothing to wait for.
"""

from __future__ import annotations

import inspect
import os
import re
from pathlib import Path
from typing import Any

import torch
from torch import nn

from tpunet_torch.train.trainer import TrainState

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


class StepAlreadyExistsError(ValueError):
    """A checkpoint of this step exists and `force` was not given."""


class CheckpointManager:
    """Usage:
        mgr = CheckpointManager(dir, max_to_keep=3)
        mgr.save(state.step, state)                # during training
        state = mgr.restore_latest(state) or state # at startup; `state` is
                                                   # a fresh state giving
                                                   # structure and device
    """

    def __init__(self, directory: str | Path, max_to_keep: int | None = 3):
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self._max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self._dir / f"{int(step)}.pt"

    def save(self, step: int, state: TrainState, force: bool = False) -> bool:
        path = self._path(step)
        if path.exists() and not force:
            raise StepAlreadyExistsError(
                f"checkpoint for step {step} already exists in {self._dir}")
        payload = {"params": {k: t.detach() for k, t in state.params.items()},
                   "opt_state": state.opt_state.state_dict(),
                   "step": int(state.step)}
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)
        if self._max_to_keep is not None:
            for old in self.all_steps()[:-self._max_to_keep]:
                self._path(old).unlink(missing_ok=True)
        return True

    def restore(self, step: int, target: TrainState) -> TrainState:
        """Restore a specific step into NEW tensors on the target's device
        and a new optimizer of the target's kind; `target` is not
        modified."""
        dev = next(iter(target.params.values())).device
        payload = torch.load(self._path(step), map_location=dev,
                             weights_only=True)
        if set(payload["params"]) != set(target.params):
            raise KeyError("checkpoint parameters differ from the target's")
        params = {k: nn.Parameter(payload["params"][k].to(
            target.params[k].dtype)) for k in target.params}
        # `defaults` may hold keys the constructor does not take (AdamW's
        # decoupled_weight_decay); load_state_dict restores the groups'
        # hyperparameters anyway.
        kind = type(target.opt_state)
        accepted = inspect.signature(kind.__init__).parameters
        opt = kind(list(params.values()),
                   **{k: v for k, v in target.opt_state.defaults.items()
                      if k in accepted})
        opt.load_state_dict(payload["opt_state"])
        return TrainState(params, opt, int(payload["step"]))

    def restore_latest(self, target: TrainState) -> TrainState | None:
        """Resume from the newest checkpoint, or None if none exists."""
        step = self.latest_step()
        return None if step is None else self.restore(step, target)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in self._dir.iterdir()
                      if (m := _STEP_FILE.match(f.name)))

    def wait_until_finished(self) -> None:
        """Saves are synchronous; nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open."""

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
