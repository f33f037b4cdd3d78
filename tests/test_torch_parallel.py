"""The port's sequence parallelism across processes (tpunet_torch/parallel:
dcn_ring_attention, dcn_zigzag_attention, dcn_ulysses_attention and the
block math and zigzag helpers under them; the Transformer's "dcn_*"
attn_impls) against the JAX package on the same seeded numpy inputs, on
the CPU.

In this process: `_block_update` (causal and not, with offsets, and rows
that see no key), `causal_block_mode` and the zigzag helpers against JAX's
(exact, or 1e-6 for the f32 block math), and the three functions at world
1. Then every case of one world size runs in ONE spawn of port ranks
(tests/torch_sp_ranks.py, which imports no JAX): the attention functions
on (B, S, H, D) = (2, 32, 4, 8) f32 against JAX's attention_reference on
the full problem (atol = rtol = 2e-5, as tests/test_dcn_ring_attention.py
and tests/test_ulysses.py hold JAX's), and the tiny Transformer on its
token shard against the flax model with attn_impl="reference" on the full
sequence, params carried across by from_flax (1e-4 ring and Ulysses, 3e-5
zigzag). The in-pod impls "ring", "zigzag" and "ulysses" run the same
model cases over a mesh {sp: 2} of the two ranks. Refusals: Ulysses heads
not divisible by the world, an odd zigzag shard, a backward through the
exchange, attn_window and the decode cache with a dcn impl, and an in-pod
impl without a mesh.
"""

from __future__ import annotations

import functools
import importlib
import multiprocessing as mp

import numpy as np
import pytest

from conftest import free_port  # (pins JAX_PLATFORMS=cpu first)

import jax
import jax.numpy as jnp
import torch
from sp_shards import shard
from torch_sp_ranks import rank_worker

from tpunet.models import Transformer as JaxTransformer
from tpunet.ops import attention_reference as jax_attention_reference
from tpunet_torch import distributed
from tpunet_torch.models import Transformer, from_flax, init_cache
from tpunet_torch.parallel import (causal_block_mode, dcn_ring_attention,
                                   dcn_ulysses_attention,
                                   dcn_zigzag_attention, from_zigzag,
                                   to_zigzag, zigzag_chunk_order,
                                   zigzag_positions)
from tpunet_torch.parallel.ring_attention import NEG_INF, _block_update

# (tpunet.parallel's own names shadow these two modules.)
jax_ring = importlib.import_module("tpunet.parallel.ring_attention")
jax_zigzag = importlib.import_module("tpunet.parallel.zigzag_attention")

B, S, H, D = 2, 32, 4, 8
ATTN_TOL = 2e-5
MODEL_TOL = {"dcn_ring": 1e-4, "dcn_ulysses": 1e-4, "dcn_zigzag": 3e-5}
MODEL_CFGS = {
    "mha": dict(vocab=32, d_model=16, n_layers=2, n_heads=2, d_ff=32),
    "gqa": dict(vocab=32, d_model=16, n_layers=2, n_heads=4, n_kv_heads=2,
                d_ff=32),
}
# (kind, causal) of the attention cases at each world size.
ATTENTION = {2: [("ring", False), ("ring", True), ("zigzag", True),
                 ("ulysses", False), ("ulysses", True)],
             4: [("ring", True), ("zigzag", True), ("ulysses", True)]}
IMPLS = ("dcn_ring", "dcn_zigzag", "dcn_ulysses")
IN_POD_IMPLS = ("ring", "zigzag", "ulysses")
# case name -> (the exception the ranks must raise, its message).
REFUSALS = {"ulysses_heads": ("ValueError", "not divisible by world"),
            "zigzag_odd_shard": ("ValueError", "must be even"),
            "backward_ring": ("RuntimeError", "JAX package"),
            "backward_ulysses": ("RuntimeError", "JAX package")}


def _qkv(seed=7, heads=H, seq=S):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, seq, heads, D)).astype(np.float32)
                 for _ in range(3))


@functools.lru_cache(maxsize=None)
def _reference(causal: bool) -> np.ndarray:
    q, k, v = _qkv()
    fn = jax.jit(functools.partial(jax_attention_reference, causal=causal))
    return np.asarray(fn(q, k, v))


@functools.lru_cache(maxsize=None)
def _model_setup(name: str):
    """(port params as numpy, tokens, flax logits on the full sequence)."""
    cfg = MODEL_CFGS[name]
    jm = JaxTransformer(compute_dtype=jnp.float32, attn_impl="reference",
                        **cfg)
    toks = np.random.default_rng(3).integers(0, cfg["vocab"], (2, S)).astype(
        np.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(4), toks)["params"]
    want = np.asarray(jax.jit(jm.apply)({"params": params}, toks))
    tm = Transformer(compute_dtype=torch.float32, device="cpu", **cfg)
    sd = from_flax(jax.tree.map(np.asarray, params), tm)
    return {n: t.detach().numpy() for n, t in sd.items()}, toks, want


def _cases(world: int) -> dict:
    qkv = _qkv()
    cases = {f"{kind}-{causal}": ("attention", kind, causal, qkv, False)
             for kind, causal in ATTENTION[world]}
    if world == 2:
        for name in MODEL_CFGS:
            params, toks, _ = _model_setup(name)
            for impl in IMPLS + IN_POD_IMPLS:
                cases[f"{impl}-{name}"] = ("model", impl, MODEL_CFGS[name],
                                           params, toks)
        cases["ulysses_heads"] = ("attention", "ulysses", True,
                                  _qkv(heads=3), False)
        cases["zigzag_odd_shard"] = ("attention", "zigzag", True,
                                     _qkv(seq=5), True)
        cases["backward_ring"] = ("backward", "ring", qkv)
        cases["backward_ulysses"] = ("backward", "ulysses", qkv)
    return cases


@functools.lru_cache(maxsize=None)
def _ranks(world: int) -> dict:
    """Every case of `world` in one spawn of port ranks: {rank: {case:
    output or refusal}}."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    cases = _cases(world)
    procs = [ctx.Process(target=rank_worker, args=(r, world, port, q, cases))
             for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in procs:
            rank, status, payload = q.get(timeout=240)
            assert status == "OK", f"rank {rank}: {payload}"
            out[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return out


# -- in this process ---------------------------------------------------------


@pytest.mark.parametrize("causal,q_start,k_start,fresh", [
    (False, 0, 0, False), (True, 6, 3, False), (True, 0, 0, False),
    (True, 2, 4, True)])
def test_block_update_matches_jax(causal, q_start, k_start, fresh):
    """One k/v block folded into the online-softmax state, against JAX's
    _block_update (f32, 1e-6): unmasked, the causal mask at global
    offsets, the diagonal, and rows that see no key of the block on a
    fresh state (m = NEG_INF)."""
    rng = np.random.default_rng(q_start * 10 + k_start)
    q = rng.standard_normal((2, 8, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 6, 4, 8)).astype(np.float32)
            for _ in range(2))
    acc = rng.standard_normal((2, 8, 4, 8)).astype(np.float32)
    m = rng.standard_normal((2, 8, 4, 1)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (2, 8, 4, 1)).astype(np.float32)
    if fresh:
        acc, m, l = np.zeros_like(acc), np.full_like(m, NEG_INF), \
            np.zeros_like(l)
    scale = 1.0 / np.sqrt(8)
    got = _block_update(*(torch.from_numpy(a) for a in (q, k, v, acc, m, l)),
                        q_start, k_start, causal=causal, scale=scale)
    want = jax_ring._block_update(*(jnp.asarray(a) for a in (q, k, v, acc,
                                                             m, l)),
                                  q_start, k_start, causal=causal,
                                  scale=scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_causal_block_mode_matches_jax():
    for kc in range(4):
        for qc in range(4):
            assert int(causal_block_mode(kc, qc)) == int(
                jax_ring.causal_block_mode(kc, qc)), (kc, qc)
    got = causal_block_mode(torch.arange(4), torch.tensor(2))
    assert got.tolist() == np.asarray(jax_ring.causal_block_mode(
        jnp.arange(4), 2)).tolist() == [0, 0, 1, 2]


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_zigzag_helpers_match_jax(world):
    """The chunk order, the permutation and its inverse (axis 1 and 0) and
    every rank's positions, exactly JAX's."""
    assert zigzag_chunk_order(world) == jax_zigzag.zigzag_chunk_order(world)
    x = np.arange(2 * 8 * world * 3, dtype=np.float32).reshape(2, 8 * world,
                                                               3)
    for axis in (1, 0) if world == 2 else (1,):
        a = x if axis == 1 else x.transpose(1, 0, 2)
        zz = to_zigzag(torch.from_numpy(a), world, axis=axis)
        want = np.asarray(jax_zigzag.to_zigzag(jnp.asarray(a), world,
                                               axis=axis))
        assert np.array_equal(zz.numpy(), want)
        assert np.array_equal(from_zigzag(zz, world, axis=axis).numpy(), a)
        assert np.array_equal(np.asarray(jax_zigzag.from_zigzag(
            jnp.asarray(want), world, axis=axis)), a)
    for rank in range(world):
        got = zigzag_positions(world, 8 * world, rank)
        assert got.dtype == torch.int32
        assert got.tolist() == np.asarray(jax_zigzag.zigzag_positions(
            world, 8 * world, rank)).tolist()
    with pytest.raises(ValueError, match="2\\*world"):
        to_zigzag(torch.zeros(1, 8 * world + 1), world)


@pytest.mark.parametrize("kind", ["ring", "zigzag", "ulysses"])
def test_world_1_is_plain_attention(kind):
    """At world 1 no block travels: each function is attention over the
    whole sequence (causal; the ring and Ulysses also not)."""
    distributed.initialize(f"127.0.0.1:{free_port()}", 0, 1)
    try:
        q, k, v = (torch.from_numpy(a) for a in _qkv())
        for causal in (True,) if kind == "zigzag" else (True, False):
            if kind == "ring":
                got = dcn_ring_attention(q, k, v, causal=causal)
            elif kind == "zigzag":
                got = from_zigzag(dcn_zigzag_attention(
                    *(to_zigzag(t, 1) for t in (q, k, v))), 1)
            else:
                got = dcn_ulysses_attention(q, k, v, causal=causal)
            np.testing.assert_allclose(got.numpy(), _reference(causal),
                                       rtol=ATTN_TOL, atol=ATTN_TOL)
    finally:
        distributed.finalize()


@pytest.mark.parametrize("impl", IMPLS)
def test_window_and_cache_refuse_dcn_impls(impl):
    """The flax model's ValueErrors: attn_window and the decode cache are
    for "reference" and "flash" only."""
    cfg = dict(MODEL_CFGS["gqa"], compute_dtype=torch.float32, device="cpu")
    toks = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="attn_window"):
        Transformer(attn_impl=impl, attn_window=4, **cfg)(toks)
    model = Transformer(attn_impl=impl, **cfg)
    with pytest.raises(ValueError, match="decode"):
        model(toks, cache=init_cache(model, 1, 8, device="cpu"))


@pytest.mark.parametrize("impl", IN_POD_IMPLS)
def test_in_pod_impls_wait_for_the_mesh(impl):
    """The in-pod impls run over the port's mesh (ROADMAP A.6b): over a
    mesh {sp: 2} of the spawn's two ranks, each rank's logits on its token
    shard equal the flax reference model's on the full sequence at the
    shard's rows, MHA and GQA, at the dcn impls' tolerances. Without a
    mesh they raise the flax model's ValueError."""
    with pytest.raises(ValueError, match="requires a mesh"):
        Transformer(attn_impl=impl, device="cpu", **MODEL_CFGS["mha"])
    res = _ranks(2)
    for cfg in sorted(MODEL_CFGS):
        _, _, want = _model_setup(cfg)
        for rank in range(2):
            got = res[rank][f"{impl}-{cfg}"]
            assert isinstance(got, np.ndarray), got
            tol = MODEL_TOL[f"dcn_{impl}"]
            np.testing.assert_allclose(
                got, shard(want, 2, rank, impl == "zigzag"), rtol=tol,
                atol=tol, err_msg=f"{cfg} rank {rank}")


# -- on spawned port ranks ---------------------------------------------------


@pytest.mark.parametrize("world,kind,causal", [
    (w, kind, causal) for w, cases in ATTENTION.items()
    for kind, causal in cases])
def test_dcn_attention_matches_jax_reference(world, kind, causal):
    """Each rank's output is its shard of JAX's attention_reference over
    the full problem (for zigzag: its chunk pair)."""
    want = _reference(causal)
    res = _ranks(world)
    for rank in range(world):
        got = res[rank][f"{kind}-{causal}"]
        assert isinstance(got, np.ndarray), got
        np.testing.assert_allclose(got, shard(want, world, rank,
                                              kind == "zigzag"),
                                   rtol=ATTN_TOL, atol=ATTN_TOL,
                                   err_msg=f"rank {rank}")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("cfg", sorted(MODEL_CFGS))
def test_transformer_sequence_parallel_matches_flax(impl, cfg):
    """Each rank's logits on its token shard equal the flax reference
    model's on the full sequence, at the shard's rows (global rotary
    positions, GQA k/v repeated after rotary)."""
    _, _, want = _model_setup(cfg)
    res = _ranks(2)
    for rank in range(2):
        got = res[rank][f"{impl}-{cfg}"]
        assert isinstance(got, np.ndarray), got
        tol = MODEL_TOL[impl]
        np.testing.assert_allclose(got, shard(want, 2, rank,
                                              impl == "dcn_zigzag"),
                                   rtol=tol, atol=tol, err_msg=f"rank {rank}")


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_on_ranks(case):
    """Ulysses heads not divisible by the world and an odd zigzag shard
    raise ValueError as JAX's do; a backward through the neighbor exchange
    or the all-to-all raises, as jax.grad does through JAX's."""
    kind, match = REFUSALS[case]
    res = _ranks(2)
    for rank in range(2):
        got = res[rank][case]
        assert isinstance(got, str) and got.startswith(f"raised {kind}"), got
        assert match in got, got
