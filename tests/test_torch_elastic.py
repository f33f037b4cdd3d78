"""The port's elastic training and churn engine (``tpunet_torch.train.
elastic``, ``tpunet_torch.elastic``) on the CPU.

Spawned ranks (their workers live in ``torch_elastic_ranks.py``, which
imports no JAX) run the recovery paths for real over loopback comms: fit()
of a tiny Transformer under run_elastic with a rank SIGKILLed by the churn
script and respawned, bitwise equal to a run nobody killed; the shrink
policy (3 -> 2); and ElasticWorld's scripted kill -> shrink -> join -> grow
with the gates of the JAX package's churn test. The pure parts
(parse_churn_script, is_comm_failure, the generation file) are held to the
JAX package's answers on the same tables.
"""

from __future__ import annotations

import signal
import threading

import numpy as np
import pytest

from conftest import free_port
from torch_elastic_ranks import (FIT_STEPS, NPARAMS, collect_worker,
                                 expected_shrink_params, fit_worker,
                                 flagship_worker, shrink_worker, supervise)

from tpunet import _native as jax_native
from tpunet import elastic as jax_elastic
from tpunet.train import elastic as jax_train_elastic
from tpunet_torch import _native, elastic
from tpunet_torch.train import elastic as train_elastic


def _ok(results: dict) -> None:
    bad = {m: v for m, v in results.items() if v[0] != "OK"}
    assert not bad, f"worker failures: {bad}"


# -- pure parts against the JAX package -------------------------------------

CHURN_SPECS = [
    "churn:at_step=3:rank=2:action=kill;churn:at_step=6:rank=3:action=join",
    "churn:rank=*:action=kill",
    "stream=1:after_bytes=4M:action=close;churn:at_step=1:rank=0:action=join",
    "stream=1:action=close",
    "",
    ";;churn:at_step=9:rank=4:action=kill",
    "churn:at_step=1:action=nuke",
    "churn:at_step=1:rank=0",
    "churn:badkey=1:action=kill",
    "churn:at_step:action=kill",
    "churn:at_step=x:action=kill",
]


def _parse(mod, spec):
    try:
        return ("ok", mod.parse_churn_script(spec))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec", CHURN_SPECS)
def test_parse_churn_script_matches_jax(spec):
    assert _parse(elastic, spec) == _parse(jax_elastic, spec)


def _chains(native):
    """Exception chains built from one package's error types, by name."""

    def cause(outer, inner):
        outer.__cause__ = inner
        return outer

    def context_only():
        try:
            try:
                raise native.NativeError(-3, "dead peer")
            except native.NativeError:
                raise ValueError("loss is NaN")
        except ValueError as e:
            return e

    looped = RuntimeError("a")
    looped.__cause__ = RuntimeError("b")
    looped.__cause__.__cause__ = looped
    return {
        "native": native.NativeError(-3, "x"),
        "watchdog": native.ProgressTimeoutError(-5, "stuck"),
        "corrupt": native.CorruptionError(-4, "crc"),
        "rewire": native.RewireTimeoutError(-9, "rewire"),
        "explicit-cause": cause(RuntimeError("wrapped"),
                                native.NativeError(-3, "x")),
        "deep-cause": cause(KeyError("k"), cause(
            RuntimeError("w"), native.ProgressTimeoutError(-5, "stuck"))),
        "message": RuntimeError("tpunet native all_reduce failed (code -3)"),
        "context-only": context_only(),
        "plain": ValueError("loss is NaN"),
        "cycle": looped,
    }


def test_is_comm_failure_matches_jax():
    ours = {k: train_elastic.is_comm_failure(e)
            for k, e in _chains(_native).items()}
    theirs = {k: jax_train_elastic.is_comm_failure(e)
              for k, e in _chains(jax_native).items()}
    assert ours == theirs
    assert ours == {"native": True, "watchdog": True, "corrupt": True,
                    "rewire": True, "explicit-cause": True,
                    "deep-cause": True, "message": True,
                    "context-only": False, "plain": False, "cycle": False}


def test_generation_file_and_coordinator_match_jax(tmp_path):
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    ours.mkdir()
    theirs.mkdir()
    for mod, d in ((train_elastic, ours), (jax_train_elastic, theirs)):
        assert mod.read_generation(d) == 0
        mod.write_generation(d, 3)
    assert (ours / "GENERATION").read_bytes() == \
        (theirs / "GENERATION").read_bytes()
    assert train_elastic.read_generation(theirs) == 3
    (ours / "GENERATION").write_text("garbage")
    assert train_elastic.read_generation(ours) == 0
    for g in (0, 1, 7):
        assert train_elastic.generation_coordinator("10.0.0.1:29500", g) == \
            jax_train_elastic.generation_coordinator("10.0.0.1:29500", g)


def test_shrink_requires_advertise_host_on_nonloopback(tmp_path):
    with pytest.raises(ValueError, match="advertise_host"):
        train_elastic.run_elastic(
            lambda c, g: None, coordinator="10.0.0.1:29500", rank=0,
            world_size=2, directory=tmp_path, allow_shrink=True)
    with pytest.raises(ValueError, match="advertise_host"):
        elastic.ElasticWorld("10.0.0.1:29500", 0, 2, directory=tmp_path)


# -- ElasticWorld in one process ----------------------------------------------


def test_rewire_timeout_typed(tmp_path):
    """A 1 ms rewire deadline cannot be met: the pipeline raises the typed
    RewireTimeoutError (-9), not a hang and not a bare RuntimeError."""
    world = elastic.ElasticWorld(
        f"127.0.0.1:{free_port()}", 0, 1, directory=tmp_path,
        grace_ms=1, rewire_timeout_ms=1)
    world.create()
    try:
        with pytest.raises(_native.RewireTimeoutError) as info:
            world.on_failure(_native.NativeError(-3, "synthetic comm loss"))
        assert info.value.code == _native.TPUNET_ERR_REWIRE == -9
        # A non-comm failure is re-raised unchanged, never "recovered".
        with pytest.raises(ValueError, match="NaN"):
            world.on_failure(ValueError("loss is NaN"))
    finally:
        world.close()


def test_crc_check_digest_and_mismatch(tmp_path):
    """crc_check hashes numpy arrays and tensors (bf16 too) by their host
    bytes, so a tensor and its numpy copy agree; two ranks whose params
    differ both raise WorldCorruptionError."""
    import torch

    from tpunet_torch.collectives import Communicator
    from tpunet_torch.transport import crc32c

    port = free_port()
    worlds = [elastic.ElasticWorld(f"127.0.0.1:{port}", r, 2,
                                   directory=tmp_path / str(r))
              for r in range(2)]
    comms: list = [None, None]

    def wire(r):
        comms[r] = Communicator(f"127.0.0.1:{port}", r, 2)

    threads = [threading.Thread(target=wire, args=(r,)) for r in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    for w, c in zip(worlds, comms):
        w.comm = c
    try:
        a = np.arange(NPARAMS, dtype=np.float32)
        t = torch.from_numpy(a.copy())
        b16 = torch.arange(5, dtype=torch.bfloat16)
        out: dict = {}

        def check(r, arrays):
            try:
                out[r] = worlds[r].crc_check(arrays)
            except Exception as e:  # noqa: BLE001 — inspected below
                out[r] = e

        def both(per_rank):
            out.clear()
            ths = [threading.Thread(target=check, args=(r, per_rank[r]))
                   for r in range(2)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=60)
            return dict(out)

        got = both([a, t])
        assert got[0] == got[1] == crc32c(a)
        got = both([[t, b16], [a, b16.view(torch.int16).numpy()]])
        assert got[0] == got[1] == crc32c(b16.view(torch.int16).numpy(),
                                          crc32c(a))
        got = both([a, a + 1])
        assert all(isinstance(v, elastic.WorldCorruptionError)
                   for v in got.values()), got
        assert worlds[0].stats["crc_checks"] == 3
    finally:
        for c in comms:
            if c is not None:
                c.close()


# -- spawned ranks -------------------------------------------------------------


def test_fit_under_elastic_is_bitwise_a_control_run(tmp_path):
    """fit() with adamw under run_elastic: member 1 is SIGKILLed by the
    churn script after step 3, the supervisor respawns it, the survivor
    rebuilds at generation 1, every member restores step 2 from the most
    advanced member's checkpoint and replays steps 3-6. The final params
    and the replayed losses equal a run nobody killed, bitwise."""
    crash, ctrl = tmp_path / "crash", tmp_path / "ctrl"
    crash.mkdir()
    ctrl.mkdir()
    results, info = supervise(fit_worker, world=2, victim=1,
                              dirpath=str(crash), deadline_s=150)
    _ok(results)
    assert info["victim_exitcode"] == -signal.SIGKILL
    assert info["respawned"]
    assert sorted(results) == [0, 1]
    control, _ = supervise(fit_worker, world=2, victim=None,
                           dirpath=str(ctrl), deadline_s=100)
    _ok(control)
    crcs = {results[m][1] for m in results} | {control[m][1]
                                               for m in control}
    assert len(crcs) == 1, "params differ from the control run"
    for m, payload in results.items():
        _, _, step, final_world, gen, published, pending, losses = payload
        assert step == FIT_STEPS and final_world == 2
        assert gen >= 1 and published >= 1
        assert pending == 0  # the replacement carries no churn script
        for s in range(3, FIT_STEPS + 1):
            assert losses[s] == control[m][7][s], (m, s)
    assert control[0][4] == 0  # the control run never rebuilt


def test_failed_generation_is_collected_before_the_rebuild(tmp_path):
    """With automatic garbage collection off, the survivor's generation-0
    params are gone when generation 1 enters: run_elastic collects the
    failed attempt's frames (on the card they hold gigabytes of params,
    optimizer state and gradients) before it rebuilds."""
    results, info = supervise(collect_worker, world=2, victim=1,
                              dirpath=str(tmp_path), deadline_s=120)
    _ok(results)
    assert info["victim_exitcode"] == -signal.SIGKILL
    _, gen, alive = results[0]
    assert gen == 1 and alive == [[], [False]]


def test_shrink_to_survivors(tmp_path):
    """Shrink policy: member 1 dies at step 5 and nobody replaces it; the
    survivors re-rank in lockstep, finish the schedule at world 2, and
    follow the two-phase trajectory."""
    results, info = supervise(shrink_worker, world=3, victim=1,
                              dirpath=str(tmp_path), deadline_s=120,
                              respawn=False)
    _ok(results)
    assert info["victim_exitcode"] == -signal.SIGKILL
    assert sorted(results) == [0, 2]
    final = {m: np.asarray(v[1], np.float32) for m, v in results.items()}
    np.testing.assert_array_equal(final[0], final[2])
    assert results[0][2] == results[2][2] == 2
    assert results[0][3] == results[2][3] == 5  # resumed at the lost step
    # Ring sums order the additions unlike np.sum (1-ulp noise); a lost or
    # doubled step would be ~0.1 off.
    np.testing.assert_allclose(final[0], expected_shrink_params(3, 5),
                               rtol=5e-6, atol=5e-7)
    assert train_elastic.read_generation(tmp_path) >= 1


def test_scripted_kill_shrink_join_grow(tmp_path):
    """ElasticWorld under the churn script of the JAX package's churn test:
    member 2 dies at step 3 (the survivors rewire to 2 with measured
    phases), member 3 joins once step 6 is checkpointed (they grow back to
    3 without restarting), the CRC gate passes after every rewire. Gates:
    bitwise-equal params on every member, world 3 (comm and gauge), every
    rewire phase histogram non-empty, shrink, grow and join counted."""
    import multiprocessing as mp
    import queue as queue_mod
    import time

    ctx = mp.get_context("spawn")
    q, vq = ctx.Queue(), ctx.Queue()
    port = free_port()
    procs = {m: ctx.Process(target=flagship_worker, args=(
        m, 3, port, vq if m == 2 else q, str(tmp_path), m == 3))
        for m in range(4)}
    for p in procs.values():
        p.start()
    results: dict = {}
    deadline = time.time() + 150
    try:
        while len(results) < 3 and time.time() < deadline:
            try:
                mid, payload = q.get(timeout=1.0)
                results[mid] = payload
            except queue_mod.Empty:
                pass
    finally:
        for p in procs.values():
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    assert procs[2].exitcode == -signal.SIGKILL, \
        f"scripted kill never fired (exit {procs[2].exitcode})"
    _ok(results)
    assert sorted(results) == [0, 1, 3]
    p0 = np.asarray(results[0][1], np.float32)
    for mid in (1, 3):
        np.testing.assert_array_equal(
            p0, np.asarray(results[mid][1], np.float32),
            err_msg=f"member {mid} diverged across churn")
    for mid, payload in results.items():
        _, _, final_world, phases, kinds, gauge, stats, sums = payload
        assert final_world == 3 and gauge == 3, (mid, final_world, gauge)
        assert all(phases.get(ph, 0) >= 1 for ph in
                   ("detect", "quiesce", "rendezvous", "rewire")), phases
        assert all(v < 120_000 * 1e3 for v in sums.values()), sums
        assert stats["crc_checks"] >= stats["rewires"] >= 1
        if mid == 3:
            assert kinds["join"] >= 1
        else:
            assert kinds["shrink"] == 1 and kinds["grow"] == 1, kinds
            assert kinds["join"] == 1, kinds
    assert train_elastic.read_generation(tmp_path) >= 2
