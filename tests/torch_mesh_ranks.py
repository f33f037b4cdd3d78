"""The spawned ranks of the port's mesh tests (test_torch_mesh.py,
test_torch_inpod_attention.py, test_torch_gpipe.py, test_torch_tp.py,
test_torch_tp_serve.py, test_torch_tp_quant_lora.py, test_torch_ep_moe.py,
test_torch_dryrun.py, the shared checkpoint of test_torch_train.py, the
in-pod model cases of test_torch_parallel.py and the serving tiers over a
mesh of test_torch_tp_serve.py), in a module that
imports no JAX, so that they start fast: every case of one world size runs
in one spawn. A mesh device is a rank, so a mesh of N devices takes N of
them; the meshes a spawn needs are built once, in case order, on every
rank.

Each case takes the test process's GLOBAL inputs (numpy), gives every rank
its block (``parallel.shard``), runs the port on it, gathers the blocks
back (``parallel.unshard``) and reports the global results by name, or the
type and message of the exception it raised."""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
import time
import traceback

import numpy as np
import torch

_meshes: dict = {}


def _mesh(axes: tuple):
    from tpunet_torch.parallel import make_named_mesh

    if axes not in _meshes:
        _meshes[axes] = make_named_mesh(dict(axes))
    return _meshes[axes]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else (
        t.detach().numpy())


# -- cases --------------------------------------------------------------------


def attention(kind, axes, qkv, causal=True, dp_axis=None, sp_axis="sp",
              tp_axis=None, grad=False, dtype="float32", permute=True):
    """`kind` ("ring", "zigzag", "ulysses") attention over the mesh on the
    global q/k/v (natural order; zigzag ones are permuted here unless
    `permute` is False); returns the global output (and, with `grad`, the
    gradients of sum(out ** 2)) in natural order."""
    from tpunet_torch.parallel import (P, from_zigzag, ring_self_attention,
                                       shard, to_zigzag, ulysses_self_attention,
                                       unshard, zigzag_self_attention)

    mesh = _mesh(axes)
    spec = P(dp_axis, sp_axis, tp_axis)
    w = mesh.shape[sp_axis]
    zig = kind == "zigzag" and permute
    dt = getattr(torch, dtype)
    glob = [_t(a).to(dt) for a in qkv]
    if zig:
        glob = [to_zigzag(x, w) for x in glob]
    local = [shard(x, mesh, spec).requires_grad_(grad) for x in glob]
    if kind == "zigzag":
        out = zigzag_self_attention(*local, mesh, dp_axis=dp_axis,
                                    sp_axis=sp_axis, tp_axis=tp_axis)
    else:
        fn = ring_self_attention if kind == "ring" else ulysses_self_attention
        out = fn(*local, mesh, causal=causal, dp_axis=dp_axis,
                 sp_axis=sp_axis, tp_axis=tp_axis)
    res = {"out": out}
    if grad:
        (out.float() ** 2).sum().backward()
        res.update(dq=local[0].grad, dk=local[1].grad, dv=local[2].grad)
    back = {}
    for k, t in res.items():
        g = unshard(t.detach(), mesh, spec)
        back[k] = _np(from_zigzag(g, w) if zig else g)
    return back


def _rules(tp_axis, ep_axis):
    from tpunet_torch.models import transformer_partition_rules

    return transformer_partition_rules(tp_axis=tp_axis, ep_axis=ep_axis)


def _model(axes, cfg, tp_axis="mdl", dp_axis="dp", **kw):
    from tpunet_torch.models import Transformer

    return Transformer(compute_dtype=torch.float32, mesh=_mesh(axes),
                       dp_axis=dp_axis, tp_axis=tp_axis, device="meta",
                       **cfg, **kw)


def model(axes, impl, cfg, params, tokens, dp_axis="dp", sp_axis="sp",
          tp_axis=None, ep_axis=None):
    """The port's Transformer over the mesh (`params` full, port layout;
    experts over `ep_axis` when given) on the global `tokens`; returns the
    global logits (natural order), each MoE block's dropped share and the
    forward's axis collectives ("axis:name")."""
    from tpunet_torch.parallel import P, from_zigzag, shard, to_zigzag, unshard
    from tpunet_torch.parallel import smap

    mesh = _mesh(axes)
    tm = _model(axes, cfg, tp_axis, dp_axis, attn_impl=impl,
                sp_axis=sp_axis)
    sharded_seq = impl in ("ring", "zigzag", "ulysses")
    spec = P(dp_axis, sp_axis if sharded_seq else None)
    toks = _t(tokens).long()
    w = mesh.shape.get(sp_axis, 1)
    if impl == "zigzag":
        toks = to_zigzag(toks, w)
    full = {n: _t(a) for n, a in params.items()}
    net = tm.bind(tm.local_params(full, _rules(tp_axis, ep_axis)))
    smap.axis_stats_reset()
    out = net(shard(toks, mesh, spec))
    ran = sorted(f"{a}:{c}" for a, d in smap.axis_stats().items() for c in d)
    logits = unshard(out, mesh, spec)
    dropped = [float(m.moe.dropped) for m in net.modules()
               if getattr(m, "is_moe", False)]
    return {"logits": _np(from_zigzag(logits, w) if impl == "zigzag"
                          else logits), "dropped": np.array(dropped),
            "collectives": ran}


def generate(axes, cfg, params, prompt, max_new, temperature=0.0,
             top_k=None, seed=0, tp_axis="mdl"):
    """The port's generate on the rank's prompt rows over dp (a generator
    of `seed` on every rank when sampling): the global tokens and this
    rank's own rows."""
    from tpunet_torch.models import generate as port_generate
    from tpunet_torch.parallel import P, shard, unshard

    mesh = _mesh(axes)
    tm = _model(axes, cfg, tp_axis)
    local = tm.local_params({n: _t(a) for n, a in params.items()})
    gen = torch.Generator().manual_seed(seed)
    out = port_generate(tm, local, shard(_t(prompt), mesh, P("dp")), max_new,
                        temperature=temperature, top_k=top_k, generator=gen)
    return {"tokens": _np(unshard(out, mesh, P("dp"))), "local": _np(out),
            "kv_heads": np.array(tm.local_kv_heads())}


def grads(axes, cfg, params, tokens, labels, tp_axis="mdl"):
    """The mean cross-entropy of the global `tokens` (every rank the whole
    batch) through the model over the mesh, and its gradient of each full
    leaf ("grad:<name>", the rank's blocks gathered)."""
    from tpunet_torch.parallel import unshard
    from tpunet_torch.parallel.mesh import shard_params

    mesh = _mesh(axes)
    tm = _model(axes, cfg, tp_axis, dp_axis=None)
    specs, local = shard_params({n: _t(a) for n, a in params.items()}, mesh,
                                tm.partition_rules())
    local = {k: torch.nn.Parameter(v.clone()) for k, v in local.items()}
    logits = tm.bind(local, trainable=True)(_t(tokens).long())
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), _t(labels).long().reshape(-1))
    loss.backward()
    return {"loss": _np(loss), **{
        f"grad:{k}": _np(unshard(t.grad, mesh, specs[k]))
        for k, t in local.items()}}


def dryrun(program, n, params=None, **kw):
    """One program of ``tpunet_torch.dryrun`` on the CPU over the world's
    `n` ranks, from `params` (the port's init without them); `kw` goes to
    the program (gather, tx)."""
    from tpunet_torch import dryrun as port_dryrun

    return port_dryrun.PROGRAMS[program](n, params, device="cpu", **kw)


def shared_checkpoint(directory, cfg, steps, own=False):
    """fit() with a checkpoint a step in `directory`, which every rank of
    the data-parallel world shares (a replicated state off a mesh), or,
    with `own`, in a directory a rank under it; rank 1 reaches each save
    0.2 s after the others. Then each rank saves the last step again
    (StepAlreadyExistsError or not), restores every step, and resumes
    with a second fit() of one more step from a fresh state. Reports the
    writes of step files this rank made, the files of its directory after
    the first run, whether each restore gives the params fit() returned at
    that step, the second save's outcome, the step the resumed run
    started from and its params."""
    import time
    from pathlib import Path

    from tpunet_torch import distributed
    from tpunet_torch.models import Transformer
    from tpunet_torch.train import (CheckpointManager, adamw,
                                    create_train_state, fit, make_train_step)
    from tpunet_torch.train import checkpoint as ckpt

    rank = distributed.rank()
    if own:
        directory = str(Path(directory) / f"rank{rank}")
    writes, trained, seen = [], {}, []
    atomic, save = ckpt._atomic_save, ckpt.CheckpointManager.save

    def counted(payload, path):
        writes.append(path.name)
        return atomic(payload, path)

    def late(self, step, state, *a, **kw):
        if rank == 1:
            time.sleep(0.2)
        return save(self, step, state, *a, **kw)

    ckpt._atomic_save, ckpt.CheckpointManager.save = counted, late
    model = Transformer(compute_dtype=torch.float32, device="meta", **cfg)
    tx = adamw(1e-2)
    state, _ = create_train_state(model, 0, None, tx, device="cpu")
    step = make_train_step(model, tx, cross_host=True)
    rng = np.random.default_rng(rank)
    batches = [(_t(x).long(), _t(np.roll(x, -1, axis=1)).long()) for x in (
        rng.integers(0, cfg["vocab"], (2, 8)) for _ in range(steps + 1))]

    def record(st, *a):
        seen.append(int(st.step))
        out = step(st, *a)
        trained[out[0].step] = {k: v.detach().clone()
                                for k, v in out[0].params.items()}
        return out

    try:
        state = fit(state, record, iter(batches[:steps]), steps=steps,
                    checkpoint_dir=directory, checkpoint_every=1,
                    max_to_keep=None, log_every=0)
        files = sorted(f.name for f in Path(directory).iterdir())
        mgr = CheckpointManager(directory, max_to_keep=None)
        try:
            mgr.save(steps, state)
            again = "saved"
        except ckpt.StepAlreadyExistsError:
            again = "raised StepAlreadyExistsError"
        distributed.global_communicator().barrier()
        fresh, _ = create_train_state(model, 9, None, tx, device="cpu")
        restored = [all(torch.equal(mgr.restore(s, fresh).params[k], v)
                        for k, v in trained[s].items())
                    for s in range(1, steps + 1)]
        del seen[:]
        resumed = fit(fresh, record, iter(batches), steps=steps + 1,
                      checkpoint_dir=directory, checkpoint_every=1,
                      max_to_keep=None, log_every=0,
                      skip_batches_on_resume=True)
    finally:
        ckpt._atomic_save, ckpt.CheckpointManager.save = atomic, save
    return {"writes": writes, "files": files, "again": again,
            "restored": restored, "steps": mgr.all_steps(),
            "resumed_from": seen, **{
                f"resumed:{k}": _np(v) for k, v in resumed.params.items()}}


def serve(axes, cfg, params, requests, server, draft_params=None,
          tp_axis="mdl", pipeline=2):
    """A BatchServer over the mesh (every rank the whole server; with
    `draft_params` the int8 self-draft): {"req<i>": tokens}."""
    from tpunet_torch.models import BatchServer

    tm = _model(axes, cfg, tp_axis)
    local = tm.local_params({n: _t(a) for n, a in params.items()})
    kw = dict(server)
    if draft_params is not None:
        dm = tm.clone(weight_quant="int8")
        kw.update(draft_model=dm, draft_params=dm.local_params(
            {n: _t(a) for n, a in draft_params.items()}))
    srv = BatchServer(tm, local, device="cpu", **kw)
    ids = [srv.submit(p, m) for p, m in requests]
    res = srv.run(pipeline=pipeline)
    out = {f"req{i}": res[rid] for i, rid in enumerate(ids)}
    if draft_params is not None:
        out["committed_per_round"] = np.array(
            srv.stats["spec_committed"] / max(srv.stats["spec_rounds"], 1))
    return out


def _collective_axes() -> list:
    from tpunet_torch.parallel import smap

    return sorted(smap.axis_stats())


def tier_prefill(axes, cfg, params, prompts, max_len, tp_axis="mdl"):
    """A PrefillEngine over each tp group of the mesh: the leaders prefill
    `prompts` ("kv<i>": the whole-head rows stacked, "last<i>": the last
    logits), the followers follow. Also the axes the ranks ran collectives
    over."""
    from tpunet_torch.parallel import smap
    from tpunet_torch.serve import PrefillEngine

    tm = _model(axes, cfg, tp_axis)
    local = tm.local_params({n: _t(a) for n, a in params.items()})
    smap.axis_stats_reset()
    pe = PrefillEngine(tm, local, max_len=max_len, device="cpu")
    out = {"kv_heads": np.array(tm.kv_head_ids())}
    if pe.group.leader:
        for i, p in enumerate(prompts):
            rows, last = pe.prefill(p)
            out[f"kv{i}"], out[f"last{i}"] = np.stack(rows), last
            out[f"shapes{i}"] = np.array(pe.kv_leaf_shapes(len(p)))
        pe.close()
    else:
        pe.follow()
    out["prefills"] = np.array(pe.stats["prefills"])
    out["axes"] = _collective_axes()
    return out


def _threaded(fn, box: dict, key: str):
    """fn() on a thread; its result or exception lands in box[key]."""
    import threading

    def run():
        try:
            box[key] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised by the case
            box[key] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


def _joined(th, box: dict, key: str):
    th.join(timeout=120)
    got = box.get(key)
    if isinstance(got, BaseException):
        raise got
    return got


def tier(axes, cfg, params, requests, kv_codec="f32", slots=2, max_len=40,
         prefill="mesh", decode="mesh", reference=False, tp_axis="mdl"):
    """The disaggregated tiers over the mesh. `prefill` / `decode`:
    "mesh", the tp group of dp index 0 (prefill) or of the last dp index
    (decode), or "single", a single-rank tier of the whole params on rank
    0 in a thread. The Router runs on rank 0 beside the prefill engine.
    Rank 0 reports the tier's tokens ("tier<i>"), TTFT/TPOT samples and,
    on the int8 wire, its codec counters; a decode group's ranks their
    worker's stats; with `reference` every rank first runs a mesh
    BatchServer on the same requests ("ref<i>")."""
    from tpunet_torch import distributed, serve, telemetry
    from tpunet_torch.models import BatchServer, Transformer
    from tpunet_torch.parallel import smap

    mesh = _mesh(axes)
    n_dp = mesh.shape.get("dp", 1)
    dp = mesh.coords.get("dp", 0)
    tm = _model(axes, cfg, tp_axis)
    local = tm.local_params({n: _t(a) for n, a in params.items()})
    whole = {n: _t(a) for n, a in params.items()}
    single = Transformer(compute_dtype=torch.float32, device="cpu", **cfg)
    out = {}
    if reference:
        srv = BatchServer(tm, local, slots=slots, max_len=max_len,
                          device="cpu")
        ids = [srv.submit(p, m) for p, m in requests]
        res = srv.run()
        out.update({f"ref{i}": res[rid] for i, rid in enumerate(ids)})
    rank = distributed.rank()
    lsock = serve.Router.listen("127.0.0.1:0") if rank == 0 else None
    port = int(distributed.global_communicator().broadcast(np.array(
        [lsock.getsockname()[1] if lsock else 0], np.int64), 0)[0])
    addr = f"127.0.0.1:{port}"
    in_prefill = prefill == "mesh" and dp == 0
    in_decode = decode == "mesh" and dp == n_dp - 1
    smap.axis_stats_reset()
    if rank == 0 and kv_codec == "int8":
        telemetry.reset()

    def frontend(engine):
        # Closed after the world barrier: a decode rank in another process
        # must have read its SHUTDOWN frame before the link goes.
        box["router"] = router = serve.Router(engine, kv_codec=kv_codec)
        try:
            router.accept_ranks(lsock, 1)
            lsock.close()
            rids = [router.submit(p, m) for p, m in requests]
            got = router.run(timeout=120)
        finally:
            router.shutdown()
        return [got[r] for r in rids], dict(router.samples)

    def decode_leader(model, p):
        worker = serve.connect_decode(addr, model, p, slots=slots,
                                      max_len=max_len, kv_codec=kv_codec,
                                      device="cpu")
        try:
            worker.serve()
        finally:
            worker.close()
        return worker

    box, threads = {}, {}
    if rank == 0 and prefill == "single":
        threads["front"] = _threaded(lambda: frontend(serve.PrefillEngine(
            single, whole, max_len=max_len, device="cpu")), box, "front")
    if rank == 0 and decode == "single":
        threads["decode"] = _threaded(lambda: decode_leader(single, whole),
                                      box, "decode")
    if in_prefill:
        pe = serve.PrefillEngine(tm, local, max_len=max_len, device="cpu")
        if pe.group.leader:
            box["front"] = frontend(pe)
        else:
            pe.follow()
        out["prefills"] = np.array(pe.stats["prefills"])
    worker = None
    if in_decode:
        if mesh.axis_index(tp_axis) == 0:
            worker = decode_leader(tm, local)
        else:
            worker = serve.follow_decode(tm, local, slots=slots,
                                         max_len=max_len, device="cpu")
    for key, th in threads.items():
        got = _joined(th, box, key)
        if key == "decode":
            worker = got
    if rank == 0:
        tokens, samples = box["front"]
        out.update({f"tier{i}": t for i, t in enumerate(tokens)})
        out.update(ttft=np.array(samples["ttft"]),
                   tpot=np.array(samples["tpot"]))
        if kv_codec == "int8":
            m = telemetry.metrics()
            out["wire_ratio"] = np.array(
                list(m["tpunet_codec_wire_ratio"].items()), dtype=object)
            out["int8_tx"] = np.array(sum(
                v for k, v in m["tpunet_codec_bytes_total"].items()
                if telemetry.labels(k).get("codec") == "int8"
                and telemetry.labels(k).get("dir") == "tx"))
    if worker is not None:
        out["decode_stats"] = dict(worker.stats, **{
            f"srv_{k}": v for k, v in worker.srv.stats.items()})
    out["axes"] = _collective_axes()
    distributed.global_communicator().barrier()
    if "router" in box:
        box["router"].close()
    return out


def tier_swap(axes, cfg, params, slots=2, max_len=40, tp_axis="mdl"):
    """A SWAP_BEGIN into the decode group of the last dp index from a
    single-rank router on rank 0: what each rank saw ("leader", "follower":
    the exception raised; "rank_failures" at the router)."""
    from tpunet_torch import distributed, serve
    from tpunet_torch.models import Transformer
    from tpunet_torch.serve import protocol as proto

    mesh = _mesh(axes)
    dp, n_dp = mesh.coords.get("dp", 0), mesh.shape.get("dp", 1)
    tm = _model(axes, cfg, tp_axis)
    local = tm.local_params({n: _t(a) for n, a in params.items()})
    rank = distributed.rank()
    lsock = serve.Router.listen("127.0.0.1:0") if rank == 0 else None
    port = int(distributed.global_communicator().broadcast(np.array(
        [lsock.getsockname()[1] if lsock else 0], np.int64), 0)[0])
    out = {}
    if rank == 0:
        single = Transformer(compute_dtype=torch.float32, device="cpu", **cfg)
        pe = serve.PrefillEngine(single, {n: _t(a) for n, a in
                                          params.items()},
                                 max_len=max_len, device="cpu")
        router = serve.Router(pe, kv_codec="f32")
        router.accept_ranks(lsock, 1)
        lsock.close()
        ann = proto.SwapAnnounce(1, 2, 1, 8, 1024, "bf16", 5000,
                                 "127.0.0.1:1")
        router._ranks[0].link.send_frame(proto.T_SWAP_BEGIN, 1 << 32 | 1,
                                         proto.pack_swap_begin(ann))
        deadline = time.monotonic() + 60
        while router._ranks[0].alive and time.monotonic() < deadline:
            router.poll()
            time.sleep(0.01)
        out["rank_failures"] = np.array(router.stats["rank_failures"])
        router.close()
    if dp == n_dp - 1:
        try:
            if mesh.axis_index(tp_axis) == 0:
                worker = serve.connect_decode(
                    f"127.0.0.1:{port}", tm, local, slots=slots,
                    max_len=max_len, kv_codec="f32", device="cpu")
                try:
                    worker.serve()
                finally:
                    worker.close()
            else:
                serve.follow_decode(tm, local, slots=slots, max_len=max_len,
                                    device="cpu")
            seen = "returned"
        except Exception as e:  # noqa: BLE001 — what the test checks
            seen = f"{type(e).__name__}: {e}"
        out["leader" if mesh.axis_index(tp_axis) == 0 else "follower"] = seen
    distributed.global_communicator().barrier()
    return out


def gpipe(axes, stacked, x, microbatches, dp_axis=None, remat=False,
          grad=False):
    """The port's gpipe of a residual MLP stage over the mesh: the global
    output and, with `grad`, the gradients of sum(out ** 2) with respect to
    the stacked params and x."""
    from tpunet_torch.parallel import P, gpipe as port_gpipe, shard, unshard

    mesh = _mesh(axes)
    params = {k: shard(_t(v), mesh, P("pp")).requires_grad_(grad)
              for k, v in stacked.items()}
    xg = _t(x)
    xs = xg.reshape((microbatches, -1) + tuple(xg.shape[1:]))
    dspec = P(None, dp_axis)
    xl = shard(xs, mesh, dspec).reshape((-1,) + tuple(xg.shape[1:]))
    xl.requires_grad_(grad)
    y = port_gpipe(_stage_fn, params, xl, mesh, microbatches,
                   dp_axis=dp_axis, remat_stages=remat)
    res = {}
    if grad:
        (y ** 2).sum().backward()
        for k, p in params.items():
            res[f"d{k}"] = _np(unshard(p.grad, mesh, P("pp")))
        res["dx"] = _np(unshard(xl.grad.reshape(microbatches, -1,
                                                *xg.shape[1:]),
                                mesh, dspec).reshape(xg.shape))
    mb = y.reshape((microbatches, -1) + tuple(xg.shape[1:]))
    res["out"] = _np(unshard(mb.detach(), mesh, dspec).reshape(xg.shape))
    return res


def _stage_fn(params, x):
    """tests/test_pipeline.py's residual MLP block."""
    h = torch.nn.functional.gelu(x @ params["w1"], approximate="tanh")
    return x + h @ params["w2"]


def train_step(axes, family, cfg, params, inputs, labels, tx, steps=1,
               dp_axis="dp", tp_axis="mdl", rng=None, ep_axis=None,
               lora=False, **step_kw):
    """`steps` of the port's train step on a `family` ("transformer" or
    "vgg") model over the mesh, from the full `params` (experts over
    `ep_axis`; `lora`: lora_optimizer over tx); returns the step losses
    (the mean over the data axes) and the global params. `step_kw` goes to
    make_train_step (accum_steps, fused_xent_block)."""
    from tpunet_torch.models import VGG, Transformer
    from tpunet_torch.models.lora import lora_optimizer
    from tpunet_torch.parallel import P, shard, unshard
    from tpunet_torch.parallel.mesh import shard_params
    from tpunet_torch.train import (adamw, create_train_state,
                                    make_train_step, sgd)

    mesh = _mesh(axes)
    cls = Transformer if family == "transformer" else VGG
    m = cls(compute_dtype=torch.float32, mesh=mesh, dp_axis=dp_axis,
            tp_axis=tp_axis, device="meta", **cfg)
    opt = {"adamw": lambda: adamw(tx[1]),
           "adam": lambda: adamw(tx[1], weight_decay=0.0),
           "sgd": lambda: sgd(tx[1], momentum=tx[2])}[tx[0]]()
    full = {n: _t(a) for n, a in params.items()}
    if lora:
        opt = lora_optimizer(opt, full)
    rules = _rules(tp_axis, ep_axis) if family == "transformer" else None
    state, _ = create_train_state(m, 0, None, opt, params=full,
                                  device="cpu", rules=rules)
    step = make_train_step(m, opt, **step_kw)
    spec = P(dp_axis)
    x, y = shard(_t(inputs), mesh, spec), shard(_t(labels), mesh, spec)
    losses = []
    for _ in range(steps):
        state, loss = step(state, x, y, rng)
        losses.append(float(loss))
    specs, _ = shard_params(full, mesh, m.partition_rules())
    from tpunet_torch.parallel.smap import psum

    n = mesh.axis_size(dp_axis)
    means = [float(psum(torch.tensor(v), dp_axis, mesh=mesh)) / n
             for v in losses]
    return {"losses": np.array(means), **{
        f"param:{k}": _np(unshard(t.detach(), mesh, specs[k]))
        for k, t in state.params.items()}}


def vgg_forward(axes, cfg, params, images, rng, tp_axis="mdl"):
    """A training-mode forward (dropout from seed `rng`) of the VGG over
    the mesh with its classifier split over `tp_axis`, every rank on the
    whole batch (dp_axis None): the logits."""
    from tpunet_torch.models import VGG

    mesh = _mesh(axes)
    vm = VGG(compute_dtype=torch.float32, mesh=mesh, dp_axis=None,
             tp_axis=tp_axis, device="meta", **cfg)
    net = vm.bind(vm.local_params({n: _t(a) for n, a in params.items()}))
    return {"logits": _np(net(_t(images), train=True, rng=rng))}


def hierarchical(axes):
    """hierarchical_psum over "mdl" of x = arange(3) * (rank + 1) + rank:
    JAX's lax.psum over "mdl" (the mesh spans the world, so it is one host
    and no DCN tier follows)."""
    from tpunet_torch import interop

    with _mesh(axes) as mesh:
        r = mesh.rank
        x = torch.arange(3, dtype=torch.float32) * (r + 1) + r
        return {"total": _np(interop.hierarchical_psum(x, "mdl"))}


def collectives(axes):
    """Every axis collective, forward and backward, on rank-tagged inputs
    (x = rank + arange): results from every rank, gathered."""
    from tpunet_torch import interop
    from tpunet_torch.parallel import P, unshard
    from tpunet_torch.parallel import smap

    with _mesh(axes) as mesh:
        return _collectives(mesh, interop, unshard, P, smap)


def _collectives(mesh, interop, unshard, P, smap):
    r = mesh.rank
    res = {}

    def gathered(name, t):
        # (world, ...) in world-rank order
        res[name] = _np(unshard(t.detach()[None], mesh,
                                P(tuple(mesh.axis_names))))

    for ax in mesh.axis_names:
        w = mesh.shape[ax]
        x = (torch.arange(2 * w, dtype=torch.float32) + 10 * r).reshape(
            w, 2).requires_grad_()
        y = smap.psum(x, ax)
        (y * (1 + torch.arange(2 * w).reshape(w, 2))).sum().backward()
        gathered(f"psum:{ax}", y)
        gathered(f"psum_grad:{ax}", x.grad)
        x.grad = None
        y = smap.pvary(x, ax)
        (y * (r + 1)).sum().backward()
        gathered(f"pvary:{ax}", y)
        gathered(f"pvary_grad:{ax}", x.grad)
        x.grad = None
        perm = [(i, (i + 1) % w) for i in range(w)]
        y = smap.ppermute(x, ax, perm)
        (y * (r + 1)).sum().backward()
        gathered(f"ppermute:{ax}", y)
        gathered(f"ppermute_grad:{ax}", x.grad)
        x.grad = None
        back = [(i, (i - 1) % w) for i in range(w)]
        y = smap.ppermute(x, ax, back)
        (y * (r + 1)).sum().backward()
        gathered(f"ppermute_back:{ax}", y)
        gathered(f"ppermute_back_grad:{ax}", x.grad)
        x.grad = None
        y = smap.all_to_all(x, ax, split_axis=0, concat_axis=1)
        (y * (r + 1)).sum().backward()
        gathered(f"all_to_all:{ax}", y)
        gathered(f"all_to_all_grad:{ax}", x.grad)
        x.grad = None
        y = smap.all_gather(x, ax, axis=1, tiled=True)
        (y * (1 + torch.arange(y.numel()).reshape(y.shape))).sum().backward()
        gathered(f"all_gather:{ax}", y)
        gathered(f"all_gather_grad:{ax}", x.grad)
        gathered(f"axis_index:{ax}", torch.tensor([smap.axis_index(ax, mesh)
                                                   ]).float())
        gathered(f"hierarchical_psum:{ax}", interop.hierarchical_psum(
            torch.tensor([1.0, float(r)]), ax))
    return res


CASES = {f.__name__: f for f in (attention, model, generate, grads, serve,
                                 gpipe, train_step, vgg_forward, hierarchical,
                                 collectives, dryrun, shared_checkpoint,
                                 tier_prefill, tier, tier_swap)}


def rank_worker(rank, world, port, q, cases):
    """cases: {name: (case function name, kwargs)}, or the path of a file
    that pickles them; reports {name: {key: array}, or "raised <type>:
    <message>"} in case order."""
    try:
        from tpunet_torch import distributed

        if isinstance(cases, str):
            with open(cases, "rb") as f:
                cases = pickle.load(f)

        torch.set_num_threads(1)
        distributed.initialize(f"127.0.0.1:{port}", rank, world)
        out = {}
        for name, (fn, kw) in cases.items():
            try:
                out[name] = CASES[fn](**kw)
            except Exception as e:  # noqa: BLE001 — the refusals' cases
                out[name] = f"raised {type(e).__name__}: {e}"
        for m in _meshes.values():
            m.close()
        _meshes.clear()
        distributed.finalize()
        q.put((rank, "OK", out))
    except Exception:  # noqa: BLE001 — reported to the test process
        q.put((rank, "FAIL", traceback.format_exc()))


def start(world: int, cases: dict, timeout: float = 240.0):
    """Start every case in one spawn of `world` port ranks; returns a
    function that waits for them: {rank: {case: result}}. The test process
    may work meanwhile."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # The cases go through a file: a start() whose arguments outgrow the
    # pipe waits for its child to import this module.
    fd, path = tempfile.mkstemp(suffix=".pkl")
    with os.fdopen(fd, "wb") as f:
        pickle.dump(cases, f)
    procs = [ctx.Process(target=rank_worker, args=(r, world, port, q, path))
             for r in range(world)]
    for p in procs:
        p.start()

    def collect() -> dict:
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
            os.unlink(path)
        return out

    return collect


def spawn(world: int, cases: dict, timeout: float = 240.0) -> dict:
    """Every case in one spawn of `world` port ranks: {rank: {case:
    result}}."""
    return start(world, cases, timeout)()
