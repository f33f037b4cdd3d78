"""Entry points of the dry run: the port of ``__graft_entry__.py``.

    python -m tpunet_torch.dryrun [n]      # n ranks (default 8) on the card

``entry(device=None)`` returns ``(fn, (params, images))``: VGG16's forward
with 1000 classes as a function of its parameters
(``torch.func.functional_call``) on an (8, 224, 224, 3) zero batch, for a
single-card check.

``dryrun_multichip(n_devices=8, device=None)`` spawns `n_devices` rank
processes that form a tpunet world on loopback (on the card they share it,
as every mesh of the port does: a mesh device is a rank) and runs the five
programs of the JAX dry run over meshes of those ranks, in order:

1. VGG: dp x mdl (batch over dp, the Megatron-split classifier over mdl),
   one SGD step with momentum;
2. Transformer: dp x sp x mdl, ring attention over sp, TP over mdl, MoE
   with its experts over dp (= ep), top-2, two accumulated microbatches,
   one adam step;
3. Pipeline: pp x dp, GPipe of a residual-MLP stage with remat, two SGD
   steps (the second loss must be below the first);
4. QLoRA and int8 inference: dp x mdl, an adapters-only step over the
   frozen int8 base (every lora_b moves, every other leaf stays bitwise),
   then TP int8 ``generate``;
5. Serving: dp x mdl, the windowed GQA model's ``BatchServer`` (ring
   cache, pipelined run) and the speculative one (int8 self-draft, gamma
   3); every request's tokens must equal the unsharded ``generate``'s.

Rank 0 prints JAX's ``dryrun_multichip OK: ...`` lines with the port's
numbers. Each program is a function of the mesh size that every rank of
an initialized world calls; it takes optional initial parameters as numpy
arrays in the port's layout (so that a test can give it JAX's; without
them it uses the port's seeded init), runs its JAX counterpart's checks,
raising as that does, and returns its numbers (with ``gather=True``, the
VGG, transformer and QLoRA programs also return the global params after
their step, for a test to hold them to JAX's). Where the JAX program gives
the model no mesh and lets XLA follow the parameters' shardings (the
qlora and serve programs), the port gives the model the mesh and its tp
axis.

`device=None` means the card and raises without one; only an explicit
``device="cpu"`` runs the ranks on the CPU.
"""

from __future__ import annotations

import socket
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F

from tpunet_torch import _device

SMALL = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
             n_kv_heads=2)
TRANSFORMER = dict(SMALL, mlp_impl="swiglu", moe_every=2)
VGG_CFG = dict(cfg=(8, "M", 16, "M"), num_classes=16, hidden=64,
               classifier_dropout=0.0, image_size=16)
PIPE_D, PIPE_FF = 16, 32


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _full(params, device) -> dict | None:
    return None if params is None else {k: _t(v, device)
                                        for k, v in params.items()}


def _global_mean(value: float, mesh, axes) -> float:
    """The mean over the ranks of `axes` of a per-rank value."""
    from tpunet_torch.parallel.smap import psum

    t = torch.tensor([float(value)], dtype=torch.float64)
    n = 1
    with torch.no_grad():
        for a in axes:
            t = psum(t, a, mesh=mesh)
            n *= mesh.axis_size(a)
    return float(t[0]) / n


def _gathered(state, model, mesh, params: dict) -> dict:
    """The global params of a mesh state after its steps, numpy: each
    leaf's blocks gathered over the mesh, its spec from the model's
    partition rules and the leaf's full shape in `params`."""
    from tpunet_torch.parallel import unshard
    from tpunet_torch.parallel.mesh import leaf_spec

    rules = model.partition_rules()
    with torch.no_grad():
        return {k: unshard(t.detach(), mesh, leaf_spec(
            k, params[k].shape, mesh, rules)).cpu().numpy()
            for k, t in state.params.items()}


def _finite(name: str, *values) -> None:
    if not all(np.isfinite(v) for v in values):
        raise RuntimeError(f"{name} dryrun produced non-finite loss {values}")


def _dp_mdl_axes(n: int) -> dict:
    """The dp x mdl sizing the qlora and serve programs share (TP width 4
    when the rank count allows)."""
    return {"dp": max(1, n // 4), "mdl": 4 if n % 4 == 0 else 1}


def transformer_axes(n: int) -> dict:
    """The transformer program's dp x sp x mdl fold of n ranks."""
    if n % 4 == 0:
        return {"dp": n // 4, "sp": 2, "mdl": 2}
    if n % 2 == 0:
        return {"dp": 1, "sp": 2, "mdl": 1}
    return {"dp": 1, "sp": 1, "mdl": 1}


# -- the five programs --------------------------------------------------------


def vgg(n: int, params: dict | None = None, device=None, *,
        gather: bool = False) -> dict:
    """One SGD step (momentum 0.9) of a small VGG over dp x mdl;
    `gather`: also the global params after it ("params"; needs
    `params`)."""
    from tpunet_torch.models import VGG
    from tpunet_torch.parallel import P, make_mesh, shard
    from tpunet_torch.train import (create_train_state, make_train_step, sgd,
                                    synthetic_batch)

    dev = _device.resolve(device)
    mdl = 2 if n % 2 == 0 and n >= 4 else 1
    dp = n // mdl
    mesh = make_mesh(dp=dp, mdl=mdl)
    try:
        model = VGG(**VGG_CFG, compute_dtype=torch.float32, mesh=mesh,
                    dp_axis="dp", tp_axis="mdl" if mdl > 1 else None,
                    device="meta")
        tx = sgd(1e-2, momentum=0.9)
        batch = 2 * dp
        state, _ = create_train_state(model, 0, None, tx,
                                      params=_full(params, dev), device=dev)
        imgs, labels = synthetic_batch(np.random.default_rng(0), batch, 16,
                                       16)
        spec = P("dp")
        step = make_train_step(model, tx)
        state, loss = step(state, shard(_t(imgs, dev), mesh, spec),
                           shard(_t(labels, dev).long(), mesh, spec), 1)
        loss = _global_mean(float(loss), mesh, ("dp",))
        after = _gathered(state, model, mesh, params) if gather else None
    finally:
        mesh.close()
    _finite("", loss)
    return {"dp": dp, "mdl": mdl, "batch": batch, "loss": loss,
            "params": after,
            "line": f"dryrun_multichip OK: {n} devices, mesh dp={dp} x "
                    f"mdl={mdl}, batch {batch}, loss {loss:.4f}"}


def transformer(n: int, params: dict | None = None, device=None, *,
                cfg: dict | None = None, dtype=torch.float32,
                batch: int | None = None, seq: int | None = None,
                steps: int = 1, inspect=None, tx=None,
                gather: bool = False) -> dict:
    """Adam steps (1e-3, no weight decay) of a GQA SwiGLU Transformer with
    MoE every second block over dp x sp x mdl: ring attention over sp, TP
    over mdl, the experts over ep = dp (top-2), two accumulated
    microbatches. `cfg`, `dtype`, `batch`, `seq` and `steps` widen it
    (the defaults are the JAX program's), `tx` replaces its optimizer (a
    test's ``sgd(1.0)`` turns the update into the gradient);
    `inspect(model, state, step)` runs before the steps and returns a
    function of the final state whose result joins the output; `gather`:
    also the global params after the steps ("params"; needs `params`)."""
    from tpunet_torch.models import Transformer, transformer_partition_rules
    from tpunet_torch.parallel import P, make_named_mesh, shard
    from tpunet_torch.train import adamw, create_train_state, make_train_step

    dev = _device.resolve(device)
    axes = transformer_axes(n)
    dp, sp, mdl = axes["dp"], axes["sp"], axes["mdl"]
    cfg = dict(TRANSFORMER if cfg is None else cfg)
    batch = 2 * dp if batch is None else batch
    seq = 8 * sp if seq is None else seq
    mesh = make_named_mesh(axes)
    try:
        model = Transformer(
            **cfg, n_experts=dp if dp > 1 else 0,
            moe_top_k=2 if dp > 1 else 1, compute_dtype=dtype,
            attn_impl="ring" if sp > 1 else "reference",
            mesh=mesh, dp_axis="dp", sp_axis="sp",
            tp_axis="mdl" if mdl > 1 else None, device="meta")
        rules = transformer_partition_rules(
            tp_axis="mdl" if mdl > 1 else None,
            ep_axis="dp" if dp > 1 else None)
        tx = adamw(1e-3, weight_decay=0.0) if tx is None else tx
        state, _ = create_train_state(model, 0, None, tx,
                                      params=_full(params, dev), device=dev,
                                      rules=rules)
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg["vocab"], size=(batch, seq))
        labels = np.roll(toks, -1, axis=1)
        spec = P("dp", "sp")
        x = shard(_t(toks, dev).long(), mesh, spec)
        y = shard(_t(labels, dev).long(), mesh, spec)
        step = make_train_step(model, tx, accum_steps=2)
        after = inspect(model, state, step) if inspect is not None else None
        losses, seconds = [], []
        for _ in range(steps):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, x, y, 1)
            losses.append(float(loss))
            seconds.append(time.perf_counter() - t0)
        losses = [_global_mean(v, mesh, ("dp", "sp")) for v in losses]
        extra = after(state) if after is not None else {}
        if gather:
            extra["params"] = _gathered(state, model, mesh, params)
    finally:
        mesh.close()
    _finite("transformer", *losses)
    return {"axes": axes, "batch": batch, "seq": seq, "loss": losses[0],
            "losses": losses, "step_s": seconds, **extra,
            "line": f"dryrun_multichip OK: transformer mesh dp={dp} x "
                    f"sp={sp} x mdl={mdl} (ring-attn sp, TP mdl, MoE "
                    f"ep=dp, 2 accum microbatches), batch {batch}, seq "
                    f"{seq}, loss {losses[0]:.4f}"}


def _stage_fn(params, x):
    """The residual-MLP stage, x + gelu(x @ w1) @ w2 (jax.nn.gelu's tanh
    form)."""
    return x + F.gelu(x @ params["w1"], approximate="tanh") @ params["w2"]


def _stage_init(pp: int, device) -> dict:
    """The port's seeded stacked stage params: N(0, 0.1^2) entries, stage s
    from a generator seeded with s."""
    w1, w2 = [], []
    for s in range(pp):
        gen = torch.Generator().manual_seed(s)
        w1.append(torch.randn(PIPE_D, PIPE_FF, generator=gen) * 0.1)
        w2.append(torch.randn(PIPE_FF, PIPE_D, generator=gen) * 0.1)
    return {"w1": torch.stack(w1).to(device), "w2": torch.stack(w2).to(device)}


def pipeline(n: int, params: dict | None = None, device=None) -> dict:
    """Two SGD steps (1e-2) through GPipe over pp x dp, stage remat on; the
    second loss must be below the first. `params`: the stacked {"w1": (pp,
    16, 32), "w2": (pp, 32, 16)}."""
    from tpunet_torch.parallel import P, gpipe, make_named_mesh, shard
    from tpunet_torch.parallel.smap import psum

    dev = _device.resolve(device)
    pp, dp = (n // 2, 2) if n % 2 == 0 and n >= 4 else (n, 1)
    mesh = make_named_mesh({"pp": pp, "dp": dp})
    try:
        micro = max(2, pp)
        batch = micro * 2 * dp
        stacked = (_full(params, dev) if params is not None
                   else _stage_init(pp, dev))
        p = {k: shard(v, mesh, P("pp")).clone().requires_grad_()
             for k, v in stacked.items()}
        rng = np.random.default_rng(0)
        x, y = (rng.standard_normal((batch, PIPE_D)).astype(np.float32)
                for _ in range(2))
        dp_axis = "dp" if dp > 1 else None
        spec = P(None, dp_axis)

        def rows(a):
            blk = shard(_t(a, dev).reshape(micro, -1, PIPE_D), mesh, spec)
            return blk.reshape(-1, PIPE_D)

        xl, yl = rows(x), rows(y)
        losses = []
        for _ in range(2):
            out = gpipe(_stage_fn, p, xl, mesh, micro, dp_axis=dp_axis,
                        remat_stages=True)
            local = ((out - yl) ** 2).sum() / (batch * PIPE_D)
            local.backward()
            with torch.no_grad():
                for t in p.values():
                    t -= 1e-2 * t.grad
                    t.grad = None
                total = local.detach()
                if dp_axis is not None:
                    total = psum(total, dp_axis, mesh=mesh)
            losses.append(float(total))
    finally:
        mesh.close()
    _finite("pipeline", *losses)
    if not losses[1] < losses[0]:
        raise RuntimeError(f"pipeline SGD step did not reduce loss: "
                           f"{losses[0]} -> {losses[1]}")
    return {"pp": pp, "dp": dp, "microbatches": micro, "batch": batch,
            "losses": losses,
            "line": f"dryrun_multichip OK: pipeline mesh pp={pp} x dp={dp} "
                    f"(GPipe {micro} microbatches), batch {batch}, loss "
                    f"{losses[0]:.4f} -> {losses[1]:.4f}"}


def qlora(n: int, params: dict | None = None, device=None, *,
          gather: bool = False) -> dict:
    """An adapters-only adam step (1e-2) of the int8 base grafted under
    rank-4 adapters over dp x mdl (every lora_b must move, every other leaf
    stay bitwise), then TP int8 ``generate`` of 4 tokens from 8-token
    prompts. `params`: {"base": the fp base's init, "adapted": the adapted
    model's}, both port state_dicts; `gather`: also the global params
    after the step ("params"; needs `params`)."""
    from tpunet_torch.models import (Transformer, generate, graft_base,
                                     init_params, lora_optimizer,
                                     quantize_params)
    from tpunet_torch.parallel import P, make_named_mesh, shard, unshard
    from tpunet_torch.train import adamw, create_train_state, make_train_step

    dev = _device.resolve(device)
    axes = _dp_mdl_axes(n)
    dp, mdl = axes["dp"], axes["mdl"]
    tp = "mdl" if mdl > 1 else None
    mesh = make_named_mesh(axes)
    try:
        base = Transformer(**SMALL, compute_dtype=torch.float32,
                           device="meta")
        adapted = base.clone(weight_quant="int8", lora_rank=4)
        if params is None:
            base_params = init_params(base, seed=0, device=dev)
            adapted_init = init_params(adapted, seed=1, device=dev)
        else:
            base_params = _full(params["base"], dev)
            adapted_init = _full(params["adapted"], dev)
        qbase = quantize_params(base_params)
        full = graft_base(adapted_init, qbase)
        rng = np.random.default_rng(0)
        toks = rng.integers(0, SMALL["vocab"], size=(2 * dp, 12))
        labels = np.roll(toks, -1, axis=1)
        model = Transformer(**SMALL, compute_dtype=torch.float32,
                            weight_quant="int8", lora_rank=4, mesh=mesh,
                            dp_axis="dp", tp_axis=tp, device="meta")
        tx = lora_optimizer(adamw(1e-2, weight_decay=0.0), full)
        state, _ = create_train_state(model, 0, None, tx, params=full,
                                      device=dev)
        before = {k: v.detach().clone() for k, v in state.params.items()}
        spec = P("dp")
        state, loss = make_train_step(model, tx)(
            state, shard(_t(toks, dev).long(), mesh, spec),
            shard(_t(labels, dev).long(), mesh, spec), None)
        loss = _global_mean(float(loss), mesh, ("dp",))
        _finite("qlora", loss)
        moved = all(bool((v != 0).any()) for k, v in state.params.items()
                    if k.endswith(".lora_b"))
        frozen = all(torch.equal(v, before[k])
                     for k, v in state.params.items()
                     if not k.endswith((".lora_a", ".lora_b")))
        if not (moved and frozen):
            raise RuntimeError(
                f"qlora dryrun: adapters moved={moved}, base frozen={frozen}")
        trained = _gathered(state, model, mesh, full) if gather else None
        del state, before
        qmodel = Transformer(**SMALL, compute_dtype=torch.float32,
                             weight_quant="int8", mesh=mesh, dp_axis="dp",
                             tp_axis=tp, device="meta")
        prompts = shard(_t(toks[:, :8], dev).long(), mesh, spec)
        out = unshard(generate(qmodel, qmodel.local_params(qbase), prompts,
                               4), mesh, spec)
        if tuple(out.shape) != (2 * dp, 12):
            raise RuntimeError(f"sharded int8 generate shape "
                               f"{tuple(out.shape)}")
    finally:
        mesh.close()
    return {"dp": dp, "mdl": mdl, "loss": loss, "moved": moved,
            "frozen": frozen, "tokens": out.cpu().numpy(),
            "params": trained,
            "line": f"dryrun_multichip OK: qlora mesh dp={dp} x mdl={mdl} "
                    f"(frozen int8 base + fp adapters, adapters-only step, "
                    f"loss {loss:.4f}) + TP-sharded int8 generate"}


def serve(n: int, params: dict | None = None, device=None) -> dict:
    """The windowed GQA model's BatchServer (slots 2, max_len 24, 4 steps a
    call, pipelined run) and the speculative one (int8 self-draft, gamma
    3) over dp x mdl, on 3 requests; every request's tokens must equal the
    unsharded ``generate``'s."""
    from tpunet_torch.models import (BatchServer, Transformer, generate,
                                     init_params, quantize_params)
    from tpunet_torch.parallel import make_named_mesh

    dev = _device.resolve(device)
    axes = _dp_mdl_axes(n)
    dp, mdl = axes["dp"], axes["mdl"]
    cfg = dict(SMALL, attn_window=6)
    model = Transformer(**cfg, compute_dtype=torch.float32, device="meta")
    rng = np.random.default_rng(0)
    rng.integers(0, 64, size=(1, 12))   # the init batch of the JAX program
    requests = [(rng.integers(0, 64, size=k).astype(np.int32), m)
                for k, m in ((8, 6), (8, 9), (10, 4))]
    full = (_full(params, dev) if params is not None
            else init_params(model, seed=0, device=dev))
    oracle = [generate(model, full, _t(p, dev).long()[None], m)[0, len(p):]
              .cpu().numpy() for p, m in requests]
    mesh = make_named_mesh(axes)
    try:
        tm = Transformer(**cfg, compute_dtype=torch.float32, mesh=mesh,
                         dp_axis="dp", tp_axis="mdl" if mdl > 1 else None,
                         device="meta")
        local = tm.local_params(full)
        dm = tm.clone(weight_quant="int8")
        dlocal = dm.local_params(quantize_params(full))
        out = {"dp": dp, "mdl": mdl, "oracle": oracle}
        for name, kw in (("server", dict(steps_per_call=4)),
                         ("spec_server", dict(draft_model=dm,
                                              draft_params=dlocal, gamma=3))):
            srv = BatchServer(tm, local, slots=2, max_len=24,
                              temperature=0.0, device=dev, **kw)
            ids = [srv.submit(p, m) for p, m in requests]
            res = srv.run(pipeline=2)
            got = [np.asarray(res[rid]) for rid in ids]
            for rid, g, want in zip(ids, got, oracle):
                if not np.array_equal(g, want):
                    what = ("serve dryrun: sharded request" if name == "server"
                            else "spec-serve dryrun: request")
                    raise RuntimeError(f"{what} {rid} diverged from the "
                                       f"unsharded generate() oracle: {g} "
                                       f"vs {want}")
            out[name] = got
            out[name + "_stats"] = dict(srv.stats)
    finally:
        mesh.close()
    st = out["spec_server_stats"]
    tpr = st["spec_committed"] / max(st["spec_rounds"], 1)
    out["tokens_per_round"] = tpr
    out["lines"] = [
        f"dryrun_multichip OK: serve mesh dp={dp} x mdl={mdl} (BatchServer "
        f"continuous batching, per-row ring cache, pipelined run, "
        f"{len(requests)} requests / 2 slots), token-parity vs generate()",
        f"dryrun_multichip OK: SPECULATIVE serve mesh dp={dp} x mdl={mdl} "
        f"(int8 self-draft, gamma 3, {tpr:.2f} tok/round), token-parity vs "
        f"generate()"]
    return out


PROGRAMS = {"vgg": vgg, "transformer": transformer, "pipeline": pipeline,
            "qlora": qlora, "serve": serve}


def run_programs(n: int, device=None, printer=None) -> dict:
    """The five programs in order, from the port's inits, on this rank of
    an initialized world of `n` ranks; `printer` (rank 0's print) gets
    each OK line. Returns {program: its numbers and seconds, "s"}."""
    out = {}
    for name, fn in PROGRAMS.items():
        t0 = time.perf_counter()
        res = fn(n, device=device)
        res["s"] = time.perf_counter() - t0
        for line in res.get("lines", [res.get("line")]):
            if printer is not None:
                printer(line)
        out[name] = res
    return out


# -- the spawn ----------------------------------------------------------------


def _rank_main(rank: int, n: int, port: int, device: str, q) -> None:
    """A spawned rank: join the world, run the programs, report to `q`
    before leaving it."""
    try:
        from tpunet_torch import distributed

        if device == "cpu":
            torch.set_num_threads(1)
        distributed.initialize(f"127.0.0.1:{port}", rank, n)
        out = run_programs(n, device,
                           printer=(lambda s: print(s, flush=True))
                           if rank == 0 else None)
        distributed.finalize()
        q.put((rank, "OK", {k: {"line": v.get("line", v.get("lines"))}
                            for k, v in out.items()}))
    except Exception:  # noqa: BLE001 — reported to the parent
        q.put((rank, "FAIL", traceback.format_exc()))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int = 8, device=None,
                     timeout: float = 900.0) -> dict:
    """Run the five programs over `n_devices` spawned ranks (on the card
    unless `device` says otherwise; no card raises). Raises if a rank
    fails or does not report within `timeout` seconds; every rank is gone
    on return. Returns rank 0's report."""
    import multiprocessing as mp
    import queue

    dev = _device.resolve(device)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n_devices, port, str(dev), q))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    reports = {}
    deadline = time.monotonic() + timeout
    try:
        while len(reports) < n_devices:
            try:
                rank, status, payload = q.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in reports and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"dryrun_multichip: ranks {dead} "
                                       "exited without reporting") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"dryrun_multichip: ranks "
                        f"{sorted(set(range(n_devices)) - set(reports))} did "
                        f"not report within {timeout} s") from None
                continue
            if status != "OK":
                raise RuntimeError(f"dryrun_multichip: rank {rank} failed:\n"
                                   f"{payload}")
            reports[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return reports[0]


def entry(device=None):
    """VGG16's forward with 1000 classes as a function of its parameters,
    and its arguments: (fn, (params, images)), images an (8, 224, 224, 3)
    zero batch. On ``device="meta"`` nothing is computed (the parameters
    are the meta model's own)."""
    from torch.func import functional_call

    from tpunet_torch.models import vgg16
    from tpunet_torch.models.vgg import init_params

    dev = _device.resolve(device)
    model = vgg16(num_classes=1000, device="meta")
    params = (dict(model.named_parameters()) if dev.type == "meta"
              else init_params(model, seed=0, device=dev))
    images = torch.zeros((8, 224, 224, 3), device=dev)

    def forward(params, images):
        return functional_call(model, params, (images,))

    return forward, (params, images)


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
