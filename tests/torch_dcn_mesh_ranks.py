"""The spawned ranks of tests/test_torch_dcn_mesh.py: the DCN tier across
host meshes, in a module that imports no JAX, so that they start fast.
Every case runs in one spawn of 8 ranks: 2 hosts of {dp: 2, mdl: 2} (the
HOST mesh; host h is ranks 4h..4h+3), over the same ranks the
world-spanning {dp: 4, mdl: 2} (the WORLD mesh), and 4 hosts of {dp: 2,
mdl: 1} (the H4 mesh), each built at its first use, in case order on
every rank.

A training case takes the test process's GLOBAL batch (numpy): host h
takes its rows h·B/2.., and its dp ranks their blocks of those
(``parallel.shard`` over the host mesh), which puts every rank on the
rows it holds on the world mesh. It reports the global loss (the mean
over dp, then over the hosts) and the host's params gathered
(``parallel.unshard``), or the type and message of the exception it
raised. Then, for the bf16 wire, the world is built again with
``wire_dtype="bf16"`` and the host mesh with it."""

from __future__ import annotations

import traceback
from pathlib import Path

import numpy as np
import torch

from torch_mesh_ranks import _np, _t

HOST = (("dp", 2), ("mdl", 2))
WORLD = (("dp", 4), ("mdl", 2))
H4 = (("dp", 2), ("mdl", 1))
_meshes: dict = {}


def _mesh(axes: tuple):
    from tpunet_torch.parallel import make_named_mesh

    if axes not in _meshes:
        _meshes[axes] = make_named_mesh(dict(axes))
    return _meshes[axes]


def _model(mesh, cfg):
    from tpunet_torch.models import Transformer

    return Transformer(compute_dtype=torch.float32, mesh=mesh,
                       dp_axis="dp", tp_axis="mdl", device="meta", **cfg)


def _rows(mesh, a):
    """This rank's rows of the global batch `a`: its host's block, then
    its dp block of that."""
    from tpunet_torch.parallel import P, shard

    x = _t(a)
    b = x.shape[0] // mesh.n_hosts
    return shard(x[mesh.host * b:(mesh.host + 1) * b], mesh, P("dp"))


def _global_loss(mesh, loss: float) -> float:
    """The mean over the host's dp ranks, then over the hosts."""
    from tpunet_torch import interop
    from tpunet_torch.parallel.smap import psum

    with torch.no_grad():
        x = psum(torch.tensor([loss], dtype=torch.float64), "dp", mesh=mesh)
        x = x / mesh.axis_size("dp")
        if mesh.n_hosts > 1:
            with mesh:
                x = interop.dcn_pmean(x)
    return float(x[0])


def _gathered(mesh, model, full: dict, params: dict) -> dict:
    """The host's params: each block gathered under its spec (the specs
    from the full numpy `full`)."""
    from tpunet_torch.parallel import unshard
    from tpunet_torch.parallel.mesh import leaf_spec

    rules = model.partition_rules()
    return {f"param:{k}": _np(unshard(t.detach(), mesh, leaf_spec(
        k, full[k].shape, mesh, rules))) for k, t in params.items()}


def _opt_bytes(opt) -> int:
    return sum(v.numel() * v.element_size() for st in opt.state.values()
               for k, v in st.items()
               if k != "step" and isinstance(v, torch.Tensor))


def _state(mesh, cfg, params, lr, zero=False, lora=False):
    from tpunet_torch.models.lora import lora_optimizer
    from tpunet_torch.train import (adamw, create_train_state,
                                    create_zero_train_state)

    m = _model(mesh, cfg)
    full = {n: _t(a) for n, a in params.items()}
    tx = adamw(lr)
    if lora:
        tx = lora_optimizer(tx, full)
    create = create_zero_train_state if zero else create_train_state
    state, _ = create(m, 0, None, tx, params=full, device="cpu")
    return m, state


# -- cases --------------------------------------------------------------------


@torch.no_grad()
def wiring():
    """Each mesh's shape, host, coordinates and groups (world ranks), the
    DCN group's size and index, and one sum over each group of the world
    rank: the in-host groups, the DCN group (dcn_all_reduce under the host
    mesh) and the world (with no mesh active, and under the world mesh)."""
    from tpunet_torch import interop
    from tpunet_torch.parallel.smap import psum

    out = {}
    for name, axes in (("host", HOST), ("world", WORLD)):
        mesh = _mesh(axes)
        r = torch.tensor([float(mesh.rank)])
        dcn = mesh.dcn_comm()
        out[name] = {
            "n_hosts": mesh.n_hosts, "host": mesh.host,
            "coords": dict(mesh.coords),
            "devices": mesh.devices.tolist(),
            "groups": {"+".join(a): mesh.group(a)
                       for a in (("dp",), ("mdl",), ("dp", "mdl"))},
            "dcn": None if dcn is None else (dcn.rank, dcn.world_size),
            "sums": {"+".join(a): float(psum(r, a, mesh=mesh)[0])
                     for a in (("dp",), ("mdl",), ("dp", "mdl"))}}
        with mesh:
            out[name]["dcn_sum"] = float(interop.dcn_all_reduce(r)[0])
            out[name]["dcn_gather"] = _np(interop.dcn_all_gather(r))
    out["no_mesh_sum"] = float(interop.dcn_all_reduce(
        torch.tensor([float(_mesh(HOST).rank)]))[0])
    return out


def train(axes, cfg, params, inputs, labels, lr, steps=2, zero=False,
          lora=False, **step_kw):
    """`steps` of make_train_step (cross_host=True on a host mesh; the
    plain mesh step on the world mesh) or, with `zero`, of ZeRO-1, from
    the full `params`: the global losses, the host's params, the DCN
    calls of each kind a step, the optimizer's bytes and elements, the
    blocks' bytes."""
    from tpunet_torch import interop
    from tpunet_torch.train import make_train_step, make_zero_train_step

    mesh = _mesh(axes)
    m, state = _state(mesh, cfg, params, lr, zero, lora)
    if zero:
        step = make_zero_train_step(m, **step_kw)
    else:
        step = make_train_step(m, cross_host=mesh.n_hosts > 1, **step_kw)
    x, y = _rows(mesh, inputs), _rows(mesh, labels)
    start = {k: t.detach().clone() for k, t in state.params.items()}
    interop.dcn_reduce_stats_reset()
    interop.dcn_async_stats_reset()
    losses = []
    for _ in range(steps):
        state, loss = step(state, x, y, None)
        losses.append(float(loss))
    stats = interop.dcn_reduce_stats()
    calls = {k: (stats[k]["calls"] if k != "all_reduce" else stats["calls"])
             / steps for k in ("all_reduce", "reduce_scatter", "all_gather")}
    frozen = [k for k, t in state.params.items()
              if not t.is_floating_point()]
    return {"losses": np.array([_global_loss(mesh, v) for v in losses]),
            "calls": calls, "opt_bytes": _opt_bytes(state.opt_state),
            "opt_elems": sum(p.numel() for g in state.opt_state.param_groups
                             for p in g["params"]),
            "max_in_flight": interop.dcn_async_stats()["max_in_flight"],
            "block_bytes": sum(4 * t.numel() for t in state.params.values()),
            "frozen": len(frozen),
            "frozen_same": all(torch.equal(state.params[k], start[k])
                               for k in frozen),
            **_gathered(mesh, m, params, state.params)}


def bf16_wire(cfg, params, inputs, labels, lr, port):
    """The world again with wire_dtype="bf16", and the host mesh over it:
    the codecs of the world, the DCN group and an in-host group, and two
    cross_host steps with grad_compression="bf16" (the trainer ships f32
    and the DCN group's ring quantizes)."""
    from tpunet_torch import distributed

    world = distributed.global_communicator()
    rank, size = world.rank, world.world_size
    for m in _meshes.values():
        m.close()
    _meshes.clear()
    distributed.finalize()
    distributed.initialize(f"127.0.0.1:{port}", rank, size, wire_dtype="bf16")
    mesh = _mesh(HOST)
    out = train(HOST, cfg, params, inputs, labels, lr,
                grad_compression="bf16")
    out["codecs"] = [distributed.global_communicator().wire_dtype,
                     mesh.dcn_comm().wire_dtype,
                     mesh.comm(("mdl",)).wire_dtype]
    return out


def hierarchical():
    """hierarchical_psum over "mdl" and over "dp" of x = arange(3) * (rank
    + 1) + rank under each mesh."""
    from tpunet_torch import interop

    out = {}
    for name, axes in (("host", HOST), ("world", WORLD)):
        with _mesh(axes) as mesh:
            r = mesh.rank
            x = torch.arange(3, dtype=torch.float32) * (r + 1) + r
            for ax in ("mdl", "dp"):
                out[f"{name}:{ax}"] = _np(interop.hierarchical_psum(x, ax))
    return out


def _same(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k].detach(), b[k].detach())
                                    for k in a)


def _same_opt(a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    if sa["param_groups"] != sb["param_groups"]:
        return False
    return all(_same({k: v for k, v in sa["state"][i].items()
                      if isinstance(v, torch.Tensor)},
                     {k: v for k, v in sb["state"][i].items()
                      if isinstance(v, torch.Tensor)})
               for i in sa["state"])


def checkpoint(directory, axes, zero, cfg, params, inputs, labels, lr,
               steps=2):
    """A state over the mesh of `axes` (replicated, with cross_host on the
    host mesh; or ZeRO-1) through fit(checkpoint_every=1) for `steps`
    steps into `directory`, which every rank shares; then a fresh state's
    restore of the last step (are they its own blocks and optimizer
    state, bitwise?), and fit() resuming from the directory. A save or a
    restore that raises is reported, not raised, and the ranks meet at a
    barrier after each part, so that they stay aligned (the save that
    raises comes after the last step's collectives)."""
    from tpunet_torch import distributed
    from tpunet_torch.train import (CheckpointManager, fit, make_train_step,
                                    make_zero_train_step)

    barrier = distributed.global_communicator().barrier
    mesh = _mesh(axes)
    m, state = _state(mesh, cfg, params, lr, zero)
    step = (make_zero_train_step(m) if zero else
            make_train_step(m, cross_host=mesh.n_hosts > 1))
    x, y = _rows(mesh, inputs), _rows(mesh, labels)
    out = {}
    try:
        state = fit(state, step, iter([(x, y)] * steps), steps=steps,
                    checkpoint_dir=directory, checkpoint_every=1,
                    log_every=0)
        out["saved"] = "ok"
    except Exception as e:  # noqa: BLE001 — reported
        out["saved"] = f"raised {type(e).__name__}: {e}"
    barrier()
    _, fresh = _state(mesh, cfg, params, lr, zero)
    try:
        got = CheckpointManager(directory).restore(steps, fresh)
        out.update(params=_same(got.params, state.params),
                   opt=_same_opt(got.opt_state, state.opt_state),
                   step=got.step)
        resumed = fit(fresh, step, iter([]), steps=steps,
                      checkpoint_dir=directory, log_every=0)
        out["fit_resumed"] = (resumed.step == steps and _same(
            resumed.params, state.params) and _same_opt(
                resumed.opt_state, state.opt_state))
    except Exception as e:  # noqa: BLE001 — reported
        out["restored"] = f"raised {type(e).__name__}: {e}"
    barrier()
    return out


def foreign(directory, cfg, params, lr):
    """The host mesh's checkpoints of step 2 (``checkpoint``'s, in
    `directory`/replicated and /zero) restored into the world mesh's
    states (another mesh shape; for ZeRO another host count), which must
    raise; and a save_pytree of a host-mesh state to one path that every
    rank shares: restore_pytree gives back the rank's own blocks or
    refuses."""
    from tpunet_torch import distributed
    from tpunet_torch.train import (CheckpointManager, restore_pytree,
                                    save_pytree)

    base = Path(directory)
    out = {}
    for name, zero in (("replicated", False), ("zero", True)):
        _, target = _state(_mesh(WORLD), cfg, params, lr, zero)
        try:
            CheckpointManager(base / name).restore(2, target)
            out[name] = "restored"
        except (ValueError, FileNotFoundError) as e:
            out[name] = f"raised {type(e).__name__}"
    mesh = _mesh(HOST)
    _, state = _state(mesh, cfg, params, lr)
    save_pytree(base / "one.pt", state)
    distributed.global_communicator().barrier()
    try:
        got = restore_pytree(base / "one.pt", state)
        out["pytree"] = "own" if _same(got.params, state.params) else "other"
    except ValueError as e:
        out["pytree"] = f"raised {type(e).__name__}"
    distributed.global_communicator().barrier()
    return out


CASES = {f.__name__: f for f in (wiring, train, hierarchical, checkpoint,
                                 foreign)}


def rank_worker(rank, world, port, q, cases, bf16):
    """cases: {name: (case function name, kwargs)}, run in order; then
    `bf16` (kwargs of bf16_wire, or None). Reports {name: result, or
    "raised <type>: <message>"}."""
    try:
        from tpunet_torch import distributed

        torch.set_num_threads(1)
        distributed.initialize(f"127.0.0.1:{port}", rank, world)
        out = {}
        for name, (fn, kw) in cases.items():
            try:
                out[name] = CASES[fn](**kw)
            except Exception as e:  # noqa: BLE001 — reported per case
                out[name] = f"raised {type(e).__name__}: {e}"
        if bf16 is not None:
            try:
                out["bf16-wire"] = bf16_wire(**bf16)
            except Exception as e:  # noqa: BLE001
                out["bf16-wire"] = f"raised {type(e).__name__}: {e}"
        for m in _meshes.values():
            m.close()
        _meshes.clear()
        distributed.finalize()
        q.put((rank, "OK", out))
    except Exception:  # noqa: BLE001 — reported to the test process
        q.put((rank, "FAIL", traceback.format_exc()))


def spawn(world: int, cases: dict, bf16: dict | None,
          timeout: float = 240.0) -> dict:
    """Every case in one spawn of `world` port ranks: {rank: {case:
    result}}."""
    import multiprocessing as mp
    import socket

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=rank_worker,
                         args=(r, world, port, q, cases, bf16))
             for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in procs:
            rank, status, payload = q.get(timeout=timeout)
            assert status == "OK", f"rank {rank}: {payload}"
            out[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return out
