"""High-level training loop: data -> step -> checkpoint -> resume.

The port of ``tpunet/train/fit.py``, with the same loop semantics: the run
counts ``state.step`` toward a TOTAL schedule, resumes from a checkpoint
only when it is ahead of the given state, discards already-consumed
batches before prefetching when asked, reads the loss to the host only at
log steps, evaluates on a cadence and once at the end, and always leaves a
final checkpoint when a directory is configured.
"""

from __future__ import annotations

import time
import warnings
from typing import Any, Callable, Iterable

import numpy as np

from tpunet_torch.train.checkpoint import CheckpointManager
from tpunet_torch.train.trainer import TrainState


def _fold_in(rng: int, step: int) -> int:
    """A per-step seed derived from (rng, step), jax.random.fold_in's
    role."""
    return int(np.random.SeedSequence((int(rng), int(step))).generate_state(
        1)[0])


def fit(state: TrainState, train_step: Callable, batches: Iterable, *,
        steps: int, rng: int = 0, checkpoint_dir: str | None = None,
        checkpoint_every: int = 0, max_to_keep: int = 3, log_every: int = 0,
        log_fn: Callable[[dict[str, Any]], None] | None = None,
        eval_every: int = 0,
        eval_fn: Callable[[TrainState], dict[str, Any]] | None = None,
        skip_batches_on_resume: bool = False, prefetch: int = 0,
        prefetch_device=None) -> TrainState:
    """Run optimizer steps until ``state.step == steps``.

    train_step: ``make_train_step(...)``-style (state, inputs, labels, rng)
        -> (state, loss).
    batches: yields (inputs, labels); `prefetch=k` wraps the stream in
        ``tpunet_torch.data.prefetch_to_device(size=k,
        device=prefetch_device)`` AFTER any resume skip.
    rng: seed folded with the step counter into each step's rng argument.
    log_fn: called with {"step", "loss", "steps_per_s"} every `log_every`
        steps (default print) and, when eval_fn is set, with
        {"step", "eval": {...}} at eval points.
    skip_batches_on_resume: when resuming at step k, first discard k
        batches so a deterministic stream lines up with the interrupted
        run.
    """
    mgr = (CheckpointManager(checkpoint_dir, max_to_keep=max_to_keep)
           if checkpoint_dir else None)
    prefetched = None
    try:
        if mgr is not None:
            # Adopt the checkpoint only when it is AHEAD of the caller's
            # state: a newer state the caller restored elsewhere must not be
            # rolled back by an older local checkpoint.
            latest = mgr.latest_step(state)
            if latest is not None and latest > int(state.step):
                state = mgr.restore(latest, state)

        def _default_log(m):
            if "eval" in m:
                print(f"[fit] step {m['step']} eval {m['eval']}", flush=True)
            else:
                print(f"[fit] step {m['step']} loss {m['loss']:.4f} "
                      f"({m['steps_per_s']:.2f} steps/s)", flush=True)

        log = log_fn or _default_log
        it = iter(batches)
        done = int(state.step)
        start_step = done
        window_start = done
        last_eval_step = -1
        if skip_batches_on_resume and done:
            for _ in range(done):
                next(it, None)
        if prefetch > 0:
            from tpunet_torch.data import prefetch_to_device

            it = prefetched = prefetch_to_device(it, size=prefetch,
                                                 device=prefetch_device)
        t0 = time.perf_counter()
        while done < steps:
            try:
                inputs, labels = next(it)
            except StopIteration:
                break  # finite dataset exhausted before the schedule
            state, loss = train_step(state, inputs, labels,
                                     _fold_in(rng, done))
            done += 1
            if log_every and done % log_every == 0:
                value = float(loss)  # host transfer = the sync point
                dt = time.perf_counter() - t0
                log({"step": done, "loss": value,
                     "steps_per_s": (done - window_start) / dt
                     if dt > 0 else 0.0})
                t0 = time.perf_counter()
                window_start = done
            if (eval_fn is not None and eval_every
                    and done % eval_every == 0 and done < steps):
                log({"step": done, "eval": eval_fn(state)})
                last_eval_step = done
                t0 = time.perf_counter()
                window_start = done
            if (mgr is not None and checkpoint_every
                    and done % checkpoint_every == 0):
                mgr.save(done, state)
        if eval_fn is not None and done > start_step and done != last_eval_step:
            log({"step": done, "eval": eval_fn(state)})
        if mgr is not None:
            if done == start_step and start_step < steps:
                warnings.warn(
                    f"fit() ran 0 steps (state.step={done}, steps={steps}): "
                    "the batch stream was empty; ensuring a checkpoint "
                    "exists for the current state", stacklevel=2)
            if not mgr.has(done, state):
                mgr.save(done, state, force=True)
            mgr.wait_until_finished()
    finally:
        if prefetched is not None:
            # Stop the prefetch thread now, also when a step raised (a comm
            # failure that elastic training recovers from): it must not
            # hold batches, or wait on a full queue, past this call.
            prefetched.close()
        if mgr is not None:
            mgr.close()
    return state
