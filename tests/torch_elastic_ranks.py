"""Spawned workers and their supervisor for ``test_torch_elastic.py`` and
``test_torch_telemetry.py``, in a module that imports no JAX, so the ranks
start in a few seconds. Every worker reports through its queue before it
finalizes its communicator or exits; the supervisor never waits on a
process's natural exit (a survivor can deadlock at interpreter exit): it
joins each with a short timeout and then kills it."""

from __future__ import annotations

import os
import queue as queue_mod
import signal
import time
from pathlib import Path

import numpy as np

NPARAMS = 64
STEPS = 14
# Member 2 SIGKILLs itself at step 3 (shrink 3 -> 2); member 3 asks to join
# once the job has checkpointed step 6 (grow 2 -> 3).
FLAGSHIP_SPEC = ("churn:at_step=3:rank=2:action=kill;"
                 "churn:at_step=6:rank=3:action=join")
# The fit worker's victim: member 1, killed after it logs step 3.
FIT_KILL_SPEC = "churn:at_step=3:rank=1:action=kill"
FIT_STEPS = 6
TINY = dict(vocab=32, d_model=16, n_layers=2, n_heads=2, d_ff=32)


def _fail(q, key, exc: BaseException) -> None:
    import traceback

    q.put((key, (f"FAIL {type(exc).__name__}: {exc}",
                 traceback.format_exc()[-1200:])))


def _rendezvous_env() -> None:
    """A replacement that read a stale generation probes a dead port and
    must give up fast (connect retry), while the survivors parked at the
    new generation wait longer than that probe (bootstrap timeout)."""
    os.environ["TPUNET_BOOTSTRAP_TIMEOUT_MS"] = "30000"
    os.environ["TPUNET_CONNECT_RETRY_MS"] = "2000"


def _churn_env(spec: str) -> None:
    os.environ["TPUNET_FAULT_SPEC"] = spec
    _rendezvous_env()
    # Detection bounded by the watchdog and keepalive, not by TCP.
    os.environ["TPUNET_PROGRESS_TIMEOUT_MS"] = "10000"
    os.environ["TPUNET_KEEPALIVE_IDLE_S"] = "3"
    os.environ["TPUNET_KEEPALIVE_INTVL_S"] = "2"
    os.environ["TPUNET_KEEPALIVE_CNT"] = "2"


def _grad(step: int, rank: int) -> np.ndarray:
    rng = np.random.default_rng(7 * step + rank)
    return rng.standard_normal(NPARAMS).astype(np.float32)


def _latest_step(ckpt: Path) -> int:
    steps = [int(p.stem.split("_")[1]) for p in ckpt.glob("step_*.npy")]
    return max(steps, default=-1)


def expected_shrink_params(world: int, die_step: int) -> np.ndarray:
    """The shrink run's trajectory: steps before `die_step` averaged over
    `world` ranks, the rest over the re-ranked survivors (world - 1)."""
    params = np.zeros(NPARAMS, np.float32)
    for step in range(STEPS):
        w = world if step < die_step else world - 1
        g = np.sum([_grad(step, r) for r in range(w)], axis=0,
                   dtype=np.float32) / w
        params = params - 0.1 * g
    return params


def supervise(worker, world: int, victim: int | None, dirpath: str,
              deadline_s: float, respawn: bool = True) -> tuple[dict, dict]:
    """Spawn `world` workers, worker(member, world, port, q, dirpath, die);
    the victim (die=True) reports on a queue of its own, since a process
    SIGKILLed while writing to a multiprocessing queue can wedge it. With
    `respawn`, restart the victim once it has died by SIGKILL (without
    die). Returns ({member: payload}, {"victim_exitcode", "respawned"})."""
    import multiprocessing as mp

    from conftest import free_port

    _rendezvous_env()
    try:
        ctx = mp.get_context("spawn")
        q, vq = ctx.Queue(), ctx.Queue()
        port = free_port()
        procs = {m: ctx.Process(target=worker, args=(
            m, world, port, vq if m == victim else q, dirpath, m == victim))
            for m in range(world)}
        for p in procs.values():
            p.start()
        expected = (set(range(world)) if respawn or victim is None
                    else set(range(world)) - {victim})
        info = {"victim_exitcode": None, "respawned": False}
        results: dict = {}
        deadline = time.time() + deadline_s
        try:
            while expected - results.keys() and time.time() < deadline:
                for qq in (q, vq):
                    try:
                        key, payload = qq.get(timeout=0.25)
                        results[key] = payload
                    except queue_mod.Empty:
                        pass
                if (victim is not None and info["victim_exitcode"] is None
                        and not procs[victim].is_alive()):
                    procs[victim].join()
                    info["victim_exitcode"] = procs[victim].exitcode
                    if victim in results:  # it failed instead of dying
                        break
                    if respawn and procs[victim].exitcode == -signal.SIGKILL:
                        procs[victim] = ctx.Process(target=worker, args=(
                            victim, world, port, q, dirpath, False))
                        procs[victim].start()
                        info["respawned"] = True
        finally:
            for p in procs.values():
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
        return results, info
    finally:
        os.environ.pop("TPUNET_BOOTSTRAP_TIMEOUT_MS", None)
        os.environ.pop("TPUNET_CONNECT_RETRY_MS", None)


# -- fit() under run_elastic ---------------------------------------------------


def _tiny_batches(comm_rank: int):
    s = 0
    while True:
        rng = np.random.default_rng((123 + comm_rank, s))
        toks = rng.integers(0, TINY["vocab"], (2, 8)).astype(np.int32)
        yield toks, np.roll(toks, -1, axis=1)
        s += 1


def fit_worker(member: int, world: int, port: int, q, dirpath: str,
               die: bool) -> None:
    """fit() of a tiny Transformer with adamw under run_elastic, each member
    checkpointing every 2 steps into its own directory; on (re)entry every
    member restores the most advanced member's checkpoint. The victim is
    killed by the churn script when it logs step 3."""
    try:
        _rendezvous_env()
        if die:
            os.environ["TPUNET_FAULT_SPEC"] = FIT_KILL_SPEC
        import torch

        from tpunet_torch.elastic import churn_action, churn_pending
        from tpunet_torch.models import Transformer
        from tpunet_torch.train import (CheckpointManager, adamw,
                                        create_train_state, fit,
                                        make_train_step, read_generation,
                                        run_elastic)
        from tpunet_torch.transport import crc32c

        torch.set_num_threads(1)
        base = Path(dirpath)
        model = Transformer(compute_dtype=torch.float32, device="meta",
                            **TINY)
        tx = adamw(1e-2)
        losses: dict = {}

        def restore_most_advanced(state):
            best, best_dir = -1, None
            for d in sorted(base.glob("ckpt_m*")):
                latest = CheckpointManager(d).latest_step()
                if latest is not None and latest > best:
                    best, best_dir = latest, d
            if best_dir is None:
                return state
            return CheckpointManager(best_dir).restore(best, state)

        def log(m):
            losses[m["step"]] = m["loss"]
            if churn_action(m["step"], member) == "kill":
                os.kill(os.getpid(), signal.SIGKILL)

        def train_once(comm, gen):
            state, _ = create_train_state(model, 0, None, tx, device="cpu")
            state = restore_most_advanced(state)
            step = make_train_step(model, tx, cross_host=True)
            state = fit(state, step, _tiny_batches(comm.rank),
                        steps=FIT_STEPS,
                        checkpoint_dir=str(base / f"ckpt_m{member}"),
                        checkpoint_every=2, max_to_keep=1, log_every=1,
                        log_fn=log, skip_batches_on_resume=True, prefetch=2,
                        prefetch_device="cpu")
            return state, comm.world_size, gen

        state, final_world, gen = run_elastic(
            train_once, coordinator=f"127.0.0.1:{port}", rank=member,
            world_size=world, directory=dirpath, max_restarts=3)
        crc = 0
        for t in state.params.values():
            crc = crc32c(t.detach().contiguous().numpy(), crc)
        q.put((member, ("OK", crc, int(state.step), final_world, gen,
                        read_generation(dirpath), churn_pending(), losses)))
    except Exception as e:  # noqa: BLE001 — reported to the parent
        _fail(q, member, e)


# -- the shrink policy ----------------------------------------------------------


def shrink_worker(member: int, world: int, port: int, q, dirpath: str,
                  die: bool) -> None:
    """No replacement comes: survivors re-rank and continue at world - 1.
    Gradients key off comm.rank, so the trajectory is analytic."""
    try:
        from tpunet_torch.train.elastic import run_elastic

        ckpt = Path(dirpath)

        def train_once(comm, gen):
            w, r = comm.world_size, comm.rank
            latest = _latest_step(ckpt)
            params = (np.load(ckpt / f"step_{latest}.npy") if latest >= 0
                      else np.zeros(NPARAMS, np.float32))
            for step in range(latest + 1, STEPS):
                if die and step == 5:
                    os.kill(os.getpid(), signal.SIGKILL)
                g = comm.all_reduce(_grad(step, r)) / w
                params = params - 0.1 * g
                if r == 0:
                    tmp = ckpt / f".step_{step}.tmp.npy"
                    np.save(tmp, params)
                    os.replace(tmp, ckpt / f"step_{step}.npy")
                comm.barrier()  # the checkpoint is visible before anyone moves
            return params, w, latest + 1

        params, final_world, resumed_at = run_elastic(
            train_once, coordinator=f"127.0.0.1:{port}", rank=member,
            world_size=world, directory=dirpath, max_restarts=3,
            allow_shrink=True, shrink_grace_s=3.0, min_world=2)
        q.put((member, ("OK", params.tolist(), final_world, resumed_at)))
    except Exception as e:  # noqa: BLE001
        _fail(q, member, e)


# -- ElasticWorld: kill -> shrink -> join -> grow --------------------------------


def flagship_worker(member_id: int, world_size: int, port: int, q,
                    dirpath: str, joiner: bool) -> None:
    try:
        _churn_env(FLAGSHIP_SPEC)
        from tpunet_torch import _native, elastic, telemetry

        ckpt = Path(dirpath)
        if joiner:
            # The joiner arms the script itself (no engine exists yet to do
            # so), then asks to enter once the job's checkpointed step
            # reaches the scripted at_step.
            _native.check(_native.load().tpunet_c_fault_inject(
                FLAGSHIP_SPEC.encode()), "fault_inject")
            while True:
                latest = _latest_step(ckpt)
                if latest >= 0 and \
                        elastic.churn_action(latest, member_id) == "join":
                    break
                time.sleep(0.1)

        def train_once(world, comm):
            while True:
                latest = _latest_step(ckpt)
                if latest >= 0:
                    params = np.load(ckpt / f"step_{latest}.npy")
                    start = latest + 1
                else:
                    params = np.zeros(NPARAMS, np.float32)
                    start = 0
                if world.stats["rewires"]:
                    world.crc_check(params)  # after EVERY rewire
                restart = False
                for step in range(start, STEPS):
                    if world.churn_action(step) == "kill":
                        os.kill(os.getpid(), signal.SIGKILL)
                    new = world.maybe_rewire(step)
                    if new is not None:
                        comm = new
                        restart = True
                        break
                    g = (comm.all_reduce(_grad(step, comm.rank))
                         / comm.world_size)
                    params = params - 0.1 * g
                    if comm.rank == 0:
                        tmp = ckpt / f".step_{step}.tmp.npy"
                        np.save(tmp, params)
                        os.replace(tmp, ckpt / f"step_{step}.npy")
                    comm.barrier()
                    world.step_ok()
                    if comm.world_size < world_size:
                        time.sleep(0.25)  # keep the join window real
                if not restart:
                    return params, comm.world_size, dict(world.stats)

        params, final_world, stats = elastic.run(
            train_once, coordinator=f"127.0.0.1:{port}",
            member_id=member_id, world_size=world_size, directory=dirpath,
            joiner=joiner, grace_ms=4000)
        m = telemetry.metrics()
        phases = {telemetry.labels(k)["phase"]: int(v)
                  for k, v in m["tpunet_rewire_duration_us_count"].items()}
        kinds = {telemetry.labels(k)["kind"]: int(v)
                 for k, v in m["tpunet_churn_events_total"].items()}
        gauge = int(next(iter(m["tpunet_world_size"].values())))
        sums = {telemetry.labels(k)["phase"]: float(v)
                for k, v in m["tpunet_rewire_duration_us_sum"].items()}
        q.put((member_id, ("OK", params.tolist(), final_world, phases,
                           kinds, gauge, stats, sums)))
    except Exception as e:  # noqa: BLE001
        _fail(q, member_id, e)


# -- a traced 2-rank all-reduce -------------------------------------------------


def traced_allreduce_worker(rank: int, world: int, port: int, q,
                            trace_dir: str) -> None:
    """Two port all-reduces under telemetry.profile(trace_dir). The trace
    file is named after TPUNET_RANK as the library loads, so it is set
    before the first import of the port."""
    try:
        os.environ["TPUNET_RANK"] = str(rank)
        from tpunet_torch import telemetry
        from tpunet_torch.collectives import Communicator

        comm = Communicator(f"127.0.0.1:{port}", rank, world)
        arr = np.full(1 << 18, float(rank + 1), np.float32)
        comm.all_reduce(arr)  # outside the profile: not traced
        with telemetry.profile(trace_dir):
            out = comm.all_reduce(arr)
            comm.all_reduce(arr)
        ok = bool(np.all(out == sum(r + 1 for r in range(world))))
        q.put((rank, "OK" if ok else f"FAIL wrong sum {out[:4]}"))
        comm.close()
    except Exception as e:  # noqa: BLE001
        q.put((rank, f"FAIL {type(e).__name__}: {e}"))


def collect_worker(member: int, world: int, port: int, q, dirpath: str,
                   die: bool) -> None:
    """fit() under run_elastic with automatic garbage collection off: each
    generation notes whether the earlier generations' params are still
    alive when it enters (only run_elastic's own collection can free
    them). Reports [[alive, ...] per generation]."""
    try:
        _rendezvous_env()
        if die:
            os.environ["TPUNET_FAULT_SPEC"] = FIT_KILL_SPEC
        import gc
        import weakref

        import torch

        from tpunet_torch.elastic import churn_action
        from tpunet_torch.models import Transformer
        from tpunet_torch.train import (adamw, create_train_state, fit,
                                        make_train_step, run_elastic)

        gc.disable()
        torch.set_num_threads(1)
        model = Transformer(compute_dtype=torch.float32, device="meta",
                            **TINY)
        tx = adamw(1e-2)
        refs: list = []
        alive: list = []

        def log(m):
            if churn_action(m["step"], member) == "kill":
                os.kill(os.getpid(), signal.SIGKILL)

        def train_once(comm, gen):
            alive.append([r() is not None for r in refs])
            state, _ = create_train_state(model, 0, None, tx, device="cpu")
            refs.append(weakref.ref(next(iter(state.params.values()))))
            step = make_train_step(model, tx, cross_host=True)
            fit(state, step, _tiny_batches(comm.rank), steps=FIT_STEPS,
                log_every=1, log_fn=log, prefetch=2, prefetch_device="cpu")
            return gen

        gen = run_elastic(train_once, coordinator=f"127.0.0.1:{port}",
                          rank=member, world_size=world, directory=dirpath,
                          max_restarts=3)
        q.put((member, ("OK", gen, alive)))
    except Exception as e:  # noqa: BLE001
        _fail(q, member, e)
