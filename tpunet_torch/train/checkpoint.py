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

A ZeRO state (``create_zero_train_state``) keeps its optimizer shard apart:
``<step>.pt`` holds the params (replicated: every rank writes the same
file), the step and the shard's world, with no optimizer state, and each
rank writes its shard's ``state_dict()`` to
``<step>.zero-<rank>-of-<world>.pt``, so ranks that share a directory lose
no shard. Restoring a ZeRO checkpoint into a state of another world size
(or another rank) raises: a world change invalidates the sharded state
(the elastic caveat of ``make_zero_train_step``).

A replicated state off a mesh in a world of more than one rank
(``tpunet_torch.distributed``) is one state on every rank, and its ranks
may share a directory or keep one each (a host's disk). Each step is
saved once a directory: every rank calls ``save``, the lowest rank that
sees a directory writes ``<step>.pt`` there (and applies ``max_to_keep``),
and every rank returns once the files are in place, so a restore on any
rank reads its directory's file. Which ranks share a directory is found
once a manager, collectively: each rank drops a probe file named by a
nonce of rank 0 and its rank, and a rank that sees a lower rank's probe
leaves the writing to it. Whether a step exists is any rank's view, given
to every rank, so a second save of a step raises StepAlreadyExistsError
on every rank or on none; ``has`` is a collective for such a state, and
``latest_step(state)`` is rank 0's view on every rank, so ``fit()``
resumes every rank at one step. (The JAX package's processes are not one
``jax.distributed`` world, so each of its orbax managers writes a full
checkpoint of its own, and two of them in one directory would collide.)

A state over a mesh (``parallel.mesh``; either kind) holds this rank's
BLOCKS, which differ across the mesh, so its files carry the mesh
coordinates and the host: ``<step>.mesh-dp=0,mdl=1,host=0.pt`` and, for
ZeRO, ``<step>.mesh-dp=0,mdl=1,host=0.zero-<host>-of-<hosts>.pt`` (the
shard's index in its DCN group). Each rank of a mesh writes files of its
own, so ranks that share a directory never write one file (a step's file
that a peer wrote first would make a save raise StepAlreadyExistsError).
The payload records the mesh's shape and the coordinates, and a restore
into another shape or other coordinates raises, as a ZeRO restore into
another host count does. A replicated state restores into fewer hosts
(its blocks do not depend on the host count; each host reads its own
file) and raises for a host that wrote none. This is the other way round
from orbax, whose store is free of the layout (it gathers each leaf and
re-slices it on restore): that would make every save a collective over
the mesh that gathers the whole model on each rank, where a file of one's
own position is written by each rank alone, from what it holds.

``save_pytree`` / ``restore_pytree`` save and restore one tree in one file:
a ``TrainState`` (replicated or ZeRO) or nested dicts, lists and tuples of
tensors, numpy arrays and scalars; restore takes the structure, dtypes and
devices from its target.
"""

from __future__ import annotations

import inspect
import os
import re
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from tpunet_torch import distributed
from tpunet_torch.train.trainer import TrainState, _zero_layout

_STEP_FILE = re.compile(r"^(\d+)(?:\.mesh-[^.]*)?\.pt$")


class StepAlreadyExistsError(ValueError):
    """A checkpoint of this step exists and `force` was not given."""


def _zero_geometry(opt) -> dict | None:
    """{rank, world, n} of a ZeRO optimizer shard, None for a replicated
    optimizer."""
    return opt.param_groups[0].get("zero")


def _layout(opt) -> dict | None:
    """{mesh, coords, host} of a state over a mesh (which blocks it holds:
    the mesh's shape and this rank's coordinates; and its host), None off
    a mesh."""
    group = opt.param_groups[0]
    src = group.get("zero") or group.get("mesh")
    if src is None or "mesh" not in src:
        return None
    return {"mesh": dict(src["mesh"]), "coords": dict(src["coords"]),
            "host": int(src["host"])}


def _tag(layout: dict | None) -> str:
    """The file-name infix of a mesh layout: ".mesh-dp=0,mdl=1,host=0"."""
    if layout is None:
        return ""
    return ".mesh-" + ",".join(
        f"{a}={c}" for a, c in (*layout["coords"].items(),
                                ("host", layout["host"])))


def _check_layout(saved: dict | None, target_opt) -> None:
    """Raise unless a checkpoint holds the blocks the target holds: the
    same mesh shape and coordinates, or both off a mesh."""
    def blocks(layout):
        return layout and {k: layout[k] for k in ("mesh", "coords")}

    saved, want = blocks(saved), blocks(_layout(target_opt))
    if saved != want:
        raise ValueError(
            f"the checkpoint holds the blocks of {saved or 'no mesh'} and "
            f"the target those of {want or 'no mesh'}: a mesh state "
            "restores only into the same mesh shape and coordinates")


def _world(state: TrainState):
    """The world's communicator when `state` is one replicated state on
    every rank of a world of more than one (off a mesh, not ZeRO), whose
    steps are saved once a directory; None otherwise."""
    if (_zero_geometry(state.opt_state) is not None
            or _layout(state.opt_state) is not None
            or not distributed.is_initialized()):
        return None
    comm = distributed.global_communicator()
    return comm if comm.world_size > 1 else None


def _atomic_save(payload, path: Path) -> None:
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _state_payload(state: TrainState, with_opt: bool = True) -> dict:
    payload = {"params": {k: t.detach() for k, t in state.params.items()},
               "opt_state": (state.opt_state.state_dict() if with_opt
                             else None),
               "step": int(state.step)}
    zero = _zero_geometry(state.opt_state)
    if zero is not None:
        payload["zero"] = {"world": zero["world"], "n": zero["n"]}
    payload["layout"] = _layout(state.opt_state)
    return payload


def _check_zero(saved: dict | None, target_opt) -> None:
    """Raise unless a checkpoint's shard geometry ({world, n}, and rank
    where it has one) fits the target optimizer's."""
    want = _zero_geometry(target_opt)
    if (saved is None) != (want is None):
        kinds = {True: "a ZeRO (sharded) state", False: "a replicated state"}
        raise ValueError(f"the checkpoint holds {kinds[saved is not None]}, "
                         f"the target is {kinds[want is not None]}")
    if saved is not None and any(saved[k] != want[k] for k in saved):
        raise ValueError(
            f"the checkpoint's optimizer shard is {saved} and the target's "
            f"{want}: a world change invalidates the sharded optimizer "
            "state; rebuild it with create_zero_train_state and restore "
            "the params alone")


def _new_optimizer(target_opt, params: list):
    """An optimizer of the target's kind and hyperparameters over
    `params`. `defaults` may hold keys the constructor does not take
    (AdamW's decoupled_weight_decay); load_state_dict restores the groups'
    hyperparameters anyway."""
    kind = type(target_opt)
    accepted = inspect.signature(kind.__init__).parameters
    return kind(params, **{k: v for k, v in target_opt.defaults.items()
                           if k in accepted})


def _restore_state(payload: dict, opt_payload: dict,
                   target: TrainState) -> TrainState:
    """A NEW TrainState from saved params and optimizer state, on the
    target's device and of the target's optimizer kind and layout (a ZeRO
    target gets params laid out as views of one flat buffer and its
    optimizer over this rank's slice, as create_zero_train_state lays
    them out); `target` is not modified."""
    if set(payload["params"]) != set(target.params):
        raise KeyError("checkpoint parameters differ from the target's")
    _check_layout(payload.get("layout"), target.opt_state)
    _check_zero(opt_payload["param_groups"][0].get("zero"), target.opt_state)
    zero = _zero_geometry(target.opt_state)
    dev = next(iter(target.params.values())).device
    if zero is None:
        # Integer leaves (an int8 base) come back int8 and frozen.
        params = {k: nn.Parameter(
            payload["params"][k].to(dev, target.params[k].dtype),
            requires_grad=target.params[k].is_floating_point())
            for k in target.params}
        # Over the target optimizer's own leaves, in its order: all of
        # them, or the adapters alone (models.lora.lora_optimizer).
        ids = {id(t): k for k, t in target.params.items()}
        names = [ids[id(t)] for g in target.opt_state.param_groups
                 for t in g["params"]]
        opt = _new_optimizer(target.opt_state, [params[k] for k in names])
    else:
        params, shard = _zero_layout(
            {k: payload["params"][k] for k in target.params}, zero["rank"],
            zero["world"], dev)
        opt = _new_optimizer(target.opt_state, [shard])
    opt.load_state_dict(opt_payload)
    return TrainState(params, opt, int(payload["step"]))


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
        # Whether this rank writes a world-replicated state's steps here:
        # found by the first save or has() of one (`_writes`).
        self._writer: bool | None = None

    def _path(self, step: int, state: TrainState) -> Path:
        """The step's file of `state`'s layout."""
        return self._dir / f"{int(step)}{_tag(_layout(state.opt_state))}.pt"

    def _shard_path(self, step: int, state: TrainState) -> Path:
        zero = _zero_geometry(state.opt_state)
        return self._dir / (f"{int(step)}{_tag(_layout(state.opt_state))}"
                            f".zero-{zero['rank']}-of-{zero['world']}.pt")

    def _writes(self, comm) -> bool:
        """Whether this rank writes a world-replicated state's steps into
        its directory: no lower rank sees the directory. Each rank drops a
        probe named by rank 0's nonce and its rank, and looks for the
        lower ranks' probes. A collective, once a manager."""
        if self._writer is None:
            nonce = np.frombuffer(os.urandom(8), np.uint64).copy()
            nonce = int(comm.broadcast(nonce)[0])
            mine = self._dir / f".probe-{nonce:016x}-{comm.rank}"
            mine.touch()
            comm.barrier()
            self._writer = not any(
                (self._dir / f".probe-{nonce:016x}-{r}").exists()
                for r in range(comm.rank))
            comm.barrier()
            mine.unlink()
        return self._writer

    def _found(self, step: int, state: TrainState) -> bool:
        zero = _zero_geometry(state.opt_state)
        return self._path(step, state).exists() and (
            zero is None or self._shard_path(step, state).exists())

    def has(self, step: int, state: TrainState) -> bool:
        """Whether `state`'s checkpoint of `step` exists: the step's file
        of its layout, and for a ZeRO state this rank's shard (other ranks
        may have written the step's file already). For a world-replicated
        state (``_world``) it is a COLLECTIVE that every rank calls: True
        on every rank when any rank's directory holds the step."""
        found = self._found(step, state)
        world = _world(state)
        if world is not None:
            found = bool(world.all_reduce(np.array([found], np.int32),
                                          op="max")[0])
        return found

    def save(self, step: int, state: TrainState, force: bool = False) -> bool:
        """Save `step`; a step that exists raises StepAlreadyExistsError
        unless `force`. A world-replicated state is saved once a
        directory, with every rank calling (a collective): it raises on
        every rank or on none, and every rank returns True once the files
        are in place."""
        world = _world(state)
        if not force and self.has(step, state):
            raise StepAlreadyExistsError(
                f"checkpoint for step {step} already exists in {self._dir}")
        if world is None or self._writes(world):
            self._write(step, state)
        if world is not None:
            world.barrier()
        return True

    def _write(self, step: int, state: TrainState) -> None:
        zero = _zero_geometry(state.opt_state)
        if zero is not None:
            # The shard first: a step's file never names a shard that was
            # not written.
            _atomic_save(state.opt_state.state_dict(),
                         self._shard_path(step, state))
        _atomic_save(_state_payload(state, with_opt=zero is None),
                     self._path(step, state))
        if self._max_to_keep is not None:
            for old in self.all_steps()[:-self._max_to_keep]:
                for f in (self._dir / f"{old}.pt",
                          *self._dir.glob(f"{old}.*.pt")):
                    f.unlink(missing_ok=True)

    def restore(self, step: int, target: TrainState) -> TrainState:
        """Restore a specific step into NEW tensors on the target's device
        and a new optimizer of the target's kind (and, for a ZeRO target,
        its shard geometry); `target` is not modified. A mesh target reads
        the file of its own coordinates; one of another mesh shape, or
        none, raises."""
        dev = next(iter(target.params.values())).device
        path = self._path(step, target)
        if not path.exists():
            have = sorted(f.name for f in self._dir.glob(f"{int(step)}.*")
                          if _STEP_FILE.match(f.name))
            raise FileNotFoundError(
                f"no checkpoint of step {step} for the target's layout "
                f"({path.name}) in {self._dir}; it holds {have}")
        payload = torch.load(path, map_location=dev, weights_only=True)
        _check_zero(payload.get("zero"), target.opt_state)
        zero = _zero_geometry(target.opt_state)
        if zero is None:
            opt_payload = payload["opt_state"]
        else:
            shard = self._shard_path(step, target)
            if not shard.exists():
                raise FileNotFoundError(
                    f"no optimizer shard {shard.name} for step {step} in "
                    f"{self._dir}")
            opt_payload = torch.load(shard, map_location=dev,
                                     weights_only=True)
        return _restore_state(payload, opt_payload, target)

    def restore_latest(self, target: TrainState) -> TrainState | None:
        """Resume from the newest checkpoint, or None if none exists (for
        a world-replicated target, rank 0's newest on every rank)."""
        step = self.latest_step(target)
        return None if step is None else self.restore(step, target)

    def latest_step(self, state: TrainState | None = None) -> int | None:
        """The newest step here, or None. Given a world-replicated
        `state`, a collective: rank 0's newest, on every rank (a rank
        whose directory lacks it raises on restore)."""
        steps = self.all_steps()
        latest = steps[-1] if steps else None
        world = None if state is None else _world(state)
        if world is not None:
            got = world.broadcast(np.array(
                [-1 if latest is None else latest], np.int64))[0]
            latest = None if got < 0 else int(got)
        return latest

    def all_steps(self) -> list[int]:
        return sorted({int(m.group(1)) for f in self._dir.iterdir()
                       if (m := _STEP_FILE.match(f.name))})

    def wait_until_finished(self) -> None:
        """Saves are synchronous; nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open."""

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


# -- one-shot trees -----------------------------------------------------------


def _to_payload(tree):
    if isinstance(tree, TrainState):
        return _state_payload(tree)
    if isinstance(tree, dict):
        return {k: _to_payload(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_payload(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, np.generic):
        return tree.item()
    if tree is None or isinstance(tree, (bool, int, float, complex, str)):
        return tree
    raise TypeError(f"save_pytree cannot save a {type(tree).__name__}")


def _from_payload(saved, target, where: str):
    if isinstance(target, TrainState):
        return _restore_state(saved, saved["opt_state"], target)
    if isinstance(target, dict):
        if set(saved) != set(target):
            raise KeyError(f"{where or 'the tree'}: saved keys "
                           f"{sorted(saved)} differ from the target's "
                           f"{sorted(target)}")
        return type(target)((k, _from_payload(saved[k], v, f"{where}[{k!r}]"))
                            for k, v in target.items())
    if isinstance(target, (list, tuple)):
        if len(saved) != len(target):
            raise ValueError(f"{where or 'the tree'}: {len(saved)} saved "
                             f"items, the target has {len(target)}")
        items = [_from_payload(s, t, f"{where}[{i}]")
                 for i, (s, t) in enumerate(zip(saved, target))]
        if isinstance(target, tuple) and hasattr(target, "_fields"):
            return type(target)(*items)
        return type(target)(items)
    if isinstance(target, torch.Tensor):
        out = saved.to(target.device, target.dtype)
        if isinstance(target, nn.Parameter):
            return nn.Parameter(out, requires_grad=target.requires_grad)
        return out
    if isinstance(target, np.ndarray):
        return saved.numpy().astype(target.dtype, copy=False)
    if isinstance(target, np.generic):
        return type(target)(saved)
    return saved


def save_pytree(path: str | Path, tree: Any) -> None:
    """One-shot save of `tree` (no manager, no retention) to the file
    `path`. A ZeRO state's file records its shard's (rank, world), and a
    mesh state's its mesh shape and coordinates: such ranks save to paths
    of their own (a restore of another rank's file raises)."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    _atomic_save(_to_payload(tree), path)


def restore_pytree(path: str | Path, target: Any) -> Any:
    """One-shot restore; `target` supplies the structure, dtypes and
    devices (and, for a TrainState, the optimizer kind and shard layout)
    and is not modified."""
    saved = torch.load(Path(path).absolute(), map_location="cpu",
                       weights_only=True)
    return _from_payload(saved, target, "")
