"""The spawned ranks of ``test_torch_parallel.py``, in a module that imports
no JAX, so they start faster: every sequence-parallel case of one world
size runs in one spawn. Each rank takes its shard of the full inputs the
test process made (contiguous, or the zigzag chunk pair; `sp_shards.shard`
at the repo's root), runs the port's function on it and reports its
output, or the type of the exception it raised, by case name. The in-pod
impls run over a mesh {sp: world} of the spawn's ranks."""

from __future__ import annotations

import traceback

import torch

from sp_shards import shard


def _attention(kind: str, causal: bool, qkv, whole: bool, world: int,
               rank: int):
    """`kind` attention of this rank's shard of qkv (of qkv itself when
    `whole`)."""
    from tpunet_torch.parallel import (dcn_ring_attention,
                                       dcn_ulysses_attention,
                                       dcn_zigzag_attention)

    q, k, v = (torch.from_numpy(a if whole else shard(
        a, world, rank, kind == "zigzag")) for a in qkv)
    if kind == "ring":
        return dcn_ring_attention(q, k, v, causal=causal)
    if kind == "zigzag":
        return dcn_zigzag_attention(q, k, v)
    return dcn_ulysses_attention(q, k, v, causal=causal)


_meshes: dict = {}


def _model(impl: str, cfg: dict, params: dict, tokens, world: int,
           rank: int):
    """The tiny Transformer on this rank's token shard: across processes
    (the dcn impls) or over a mesh {sp: world} (the in-pod impls)."""
    from tpunet_torch.models import Transformer
    from tpunet_torch.parallel import make_named_mesh

    mesh_kw = {}
    if not impl.startswith("dcn_"):
        if world not in _meshes:
            _meshes[world] = make_named_mesh({"sp": world})
        mesh_kw = dict(mesh=_meshes[world], dp_axis=None)
    model = Transformer(compute_dtype=torch.float32, attn_impl=impl,
                        device="meta", **cfg, **mesh_kw).bind(
        {n: torch.from_numpy(a) for n, a in params.items()})
    toks = torch.from_numpy(shard(tokens, world, rank,
                                  impl.endswith("zigzag")))
    return model(toks.long())


def _backward(kind: str, qkv, world: int, rank: int):
    """A loss through the exchange: its backward must raise."""
    q, k, v = (torch.from_numpy(shard(a, world, rank, False)).requires_grad_()
               for a in qkv)
    from tpunet_torch.parallel import dcn_ring_attention, dcn_ulysses_attention

    fn = dcn_ring_attention if kind == "ring" else dcn_ulysses_attention
    fn(q, k, v, causal=False).sum().backward()


def run_case(case: tuple, world: int, rank: int):
    kind = case[0]
    if kind == "attention":
        return _attention(*case[1:], world, rank)
    if kind == "model":
        return _model(*case[1:], world, rank)
    if kind == "backward":
        return _backward(*case[1:], world, rank)
    raise ValueError(f"unknown case {kind!r}")


def rank_worker(rank, world, port, q, cases):
    """cases: {name: case}; reports {name: output array or "raised <type>:
    <message>"} in case order (every rank runs every case in one order:
    a refusal raises before its first collective)."""
    try:
        from tpunet_torch import distributed

        torch.set_num_threads(1)
        distributed.initialize(f"127.0.0.1:{port}", rank, world)
        out = {}
        for name, case in cases.items():
            try:
                with torch.set_grad_enabled(case[0] == "backward"):
                    y = run_case(case, world, rank)
                out[name] = None if y is None else y.detach().numpy()
            except Exception as e:  # noqa: BLE001 — the refusals' cases
                out[name] = f"raised {type(e).__name__}: {e}"
        for m in _meshes.values():
            m.close()
        _meshes.clear()
        distributed.finalize()
        q.put((rank, "OK", out))
    except Exception:  # noqa: BLE001 — reported to the test process
        q.put((rank, "FAIL", traceback.format_exc()))
