"""The port's Transformer, decode cache and generation against the JAX
package's, on the same weights (flax init converted with `from_flax`) and
the same token inputs, in f32 on the CPU (atol 1e-4 on logits)."""

from __future__ import annotations

import functools

import numpy as np
import pytest

from conftest import free_port  # noqa: F401  (pins JAX_PLATFORMS=cpu first)

import jax
import jax.numpy as jnp
import torch

from tpunet.models import Transformer as JaxTransformer
from tpunet.models import generate as jax_generate
from tpunet.models.generate import _kv_leaves as jax_kv_leaves
from tpunet.models.generate import _prefill as jax_prefill
from tpunet.models.generate import init_cache as jax_init_cache
from tpunet_torch.models import (Transformer, from_flax, generate,
                                 init_cache, init_params, to_flax)
from tpunet_torch.models.generate import _kv_leaves, _prefill

TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _pair_cached(n_layers, items):
    cfg = dict(vocab=64, d_model=32, n_layers=n_layers, n_heads=4,
               n_kv_heads=2, d_ff=64)
    cfg.update(items)
    jm = JaxTransformer(compute_dtype=jnp.float32, **cfg)
    tm = Transformer(compute_dtype=torch.float32, device="cpu", **cfg)
    toks = jnp.zeros((1, 8), jnp.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), toks)["params"]
    return jm, tm, params, from_flax(jax.tree.map(np.asarray, params), tm)


def _pair(n_layers=2, **kw):
    """(flax model, port model, flax params, port state_dict) for one tiny
    config; shared across tests (nothing here mutates them)."""
    return _pair_cached(n_layers, tuple(sorted(kw.items())))


def _jax_apply(module, variables, toks, **kw):
    """module.apply under jit: far quicker on the CPU than op-by-op."""
    return jax.jit(functools.partial(module.apply, **kw))(variables, toks)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 64, shape).astype(np.int32)


def _to_jax_cache(cache):
    """The port's flat cache dict as the flax cache tree."""
    tree: dict = {}
    for name, t in cache.items():
        block, attn, leaf = name.split("/")
        tree.setdefault(block, {}).setdefault(attn, {})[leaf] = jnp.asarray(
            t.numpy())
    return tree


@pytest.mark.parametrize("n_layers", [2, 12])
def test_flax_roundtrip_is_bitwise(n_layers):
    """Every leaf of a flax param tree (shapes from the flax init, values
    random) survives from_flax -> to_flax bitwise."""
    cfg = dict(vocab=64, d_model=32, n_layers=n_layers, n_heads=4,
               n_kv_heads=2, d_ff=64, mlp_impl="swiglu")
    jm = JaxTransformer(compute_dtype=jnp.float32, **cfg)
    tm = Transformer(compute_dtype=torch.float32, device="cpu", **cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(n_layers)
    params = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    sd = from_flax(params, tm)
    back = to_flax(sd)
    flat_a = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, params))[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert set(sd) == {n for n, _ in tm.named_parameters()}


@pytest.mark.parametrize("mlp_impl", ["gelu", "swiglu"])
@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_forward_logits_match_jax(mlp_impl, attn_impl):
    jm, tm, params, sd = _pair(mlp_impl=mlp_impl, attn_impl=attn_impl)
    toks = _tokens(0, (2, 21))
    want = np.asarray(_jax_apply(jm, {"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = tm.bind(sd)(torch.from_numpy(toks))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("s", [1, 3])
def test_per_row_decode_step_matches_jax(s):
    """A per-row cache holding random K/V with the rows at different
    offsets (the last one overflowing when s > 1): the step's logits and
    the updated cache match the JAX decode step's."""
    jm, tm, params, sd = _pair()
    b, cap = 3, 12
    cache = init_cache(tm, b, cap, per_row=True, device="cpu")
    rng = np.random.default_rng(4)
    for name, t in cache.items():
        if name.endswith("/cache_index"):
            t.copy_(torch.tensor([2, 7, cap - 1], dtype=torch.int32))
        else:
            t.copy_(torch.from_numpy(
                rng.standard_normal(t.shape).astype(np.float32)))
    jcache = _to_jax_cache(cache)
    toks = _tokens(5, (b, s))
    dm = jm.clone(decode=True, per_row_cache=True)
    want, mut = _jax_apply(dm, {"params": params, "cache": jcache},
                           jnp.asarray(toks), mutable=["cache"])
    with torch.no_grad():
        got = tm.bind(sd)(torch.from_numpy(toks), cache=cache)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert np.isnan(want[2]).all() == (s > 1)
    got_tree = _to_jax_cache(cache)
    for blk, sub in mut["cache"].items():
        for leaf, arr in sub["attn"].items():
            np.testing.assert_allclose(
                np.asarray(got_tree[blk]["attn"][leaf]), np.asarray(arr),
                atol=TOL, rtol=TOL)


def test_lockstep_decode_step_matches_jax():
    jm, tm, params, sd = _pair()
    cache = init_cache(tm, 2, 16, device="cpu")
    toks = _tokens(6, (2, 9))
    dm = jm.clone(decode=True)
    jcache = jax_init_cache(jm, 2, 16)
    _, mut = _jax_apply(dm, {"params": params, "cache": jcache},
                        jnp.asarray(toks), mutable=["cache"])
    want, _ = _jax_apply(dm, {"params": params, "cache": mut["cache"]},
                         jnp.asarray(toks[:, :1]), mutable=["cache"])
    net = tm.bind(sd)
    with torch.no_grad():
        net(torch.from_numpy(toks), cache=cache)
        got = net(torch.from_numpy(toks[:, :1]), cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("chunk", [None, 4, 7])
def test_prefill_matches_jax_with_and_without_chunk(chunk):
    jm, tm, params, sd = _pair()
    toks = _tokens(7, (1, 17))
    dm = jm.clone(decode=True, per_row_cache=True)
    jcache, jlast = jax.jit(functools.partial(jax_prefill, dm,
                                              chunk=chunk))(
        params, jax_init_cache(dm, 1, 24), jnp.asarray(toks))
    net = tm.bind(sd)
    with torch.no_grad():
        cache, last = _prefill(
            net, init_cache(tm, 1, 24, per_row=True, device="cpu"),
            torch.from_numpy(toks), chunk)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                               atol=TOL, rtol=TOL)
    for a, b in zip(_kv_leaves(cache), jax_kv_leaves(jcache)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=TOL, rtol=TOL)
    with torch.no_grad():
        _, whole = _prefill(
            net, init_cache(tm, 1, 24, per_row=True, device="cpu"),
            torch.from_numpy(toks), None)
    np.testing.assert_allclose(last.numpy(), whole.numpy(),
                               atol=TOL, rtol=TOL)


def test_kv_leaf_order_matches_jax_at_12_layers():
    """The shipping order is the flax tree-flatten order (block0, block1,
    block10, block11, block2, ...): tag every leaf of the JAX cache with its
    own index and read the tags back through both packages' _kv_leaves."""
    jm = JaxTransformer(vocab=64, d_model=32, n_layers=12, n_heads=4,
                        n_kv_heads=2, d_ff=64, compute_dtype=jnp.float32)
    tm = Transformer(vocab=64, d_model=32, n_layers=12, n_heads=4,
                     n_kv_heads=2, d_ff=64, compute_dtype=torch.float32,
                     device="meta")
    jcache = jax_init_cache(jm.clone(decode=True, per_row_cache=True), 1, 4)
    paths, treedef = jax.tree_util.tree_flatten_with_path(jcache)
    tagged = [jnp.full(leaf.shape, i, leaf.dtype)
              for i, (_, leaf) in enumerate(paths)]
    jcache = jax.tree_util.tree_unflatten(treedef, tagged)
    cache = init_cache(tm, 1, 4, per_row=True, device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(jcache)[0]:
        name = "/".join(p.key for p in path)
        cache[name] = torch.from_numpy(np.asarray(leaf).copy())
    want = [int(np.asarray(x).flat[0]) for x in jax_kv_leaves(jcache)]
    got = [int(x.flatten()[0]) for x in _kv_leaves(cache)]
    assert got == want and len(got) == 24
    assert [k for k in sorted(cache) if "cached_key" in k][:4] == [
        "block0/attn/cached_key", "block1/attn/cached_key",
        "block10/attn/cached_key", "block11/attn/cached_key"]


def test_greedy_generate_matches_jax_where_margin_allows():
    """Greedy tokens are equal up to the first position whose top-2 logit
    margin (teacher-forced through the JAX model) is within the tolerance."""
    jm, tm, params, sd = _pair(attn_impl="flash")
    prompt = _tokens(8, (2, 9))
    n = 10
    want = np.asarray(jax.jit(functools.partial(
        jax_generate, jm, max_new_tokens=n))(params, jnp.asarray(prompt)))
    got = generate(tm, sd, torch.from_numpy(prompt), n).numpy()
    logits = np.asarray(_jax_apply(jm, {"params": params},
                                   jnp.asarray(want)))
    for row in range(2):
        for i in range(n):
            pos = prompt.shape[1] + i
            top2 = np.sort(logits[row, pos - 1])[-2:]
            if top2[1] - top2[0] <= TOL:
                break
            assert got[row, pos] == want[row, pos], (row, i)
    np.testing.assert_array_equal(got[:, :9], prompt)


def test_unported_options_raise_not_implemented():
    """Every option of the flax model is ported: the in-pod sequence
    parallel impls and the mesh (ROADMAP A.6b; their parity tests are
    test_torch_inpod_attention.py and test_torch_tp.py), int8 weights, the
    ring decode cache, MoE and LoRA (test_torch_quant.py,
    test_torch_ring_cache.py, test_torch_moe.py and test_torch_lora.py).
    An in-pod impl without a mesh is the flax model's ValueError; a model
    over a {dp: 2, mdl: 2} mesh takes each rank's blocks."""
    from tpunet_torch.parallel import Mesh

    with pytest.raises(ValueError, match="requires a mesh"):
        Transformer(vocab=64, d_model=32, n_layers=1, n_heads=4, d_ff=64,
                    device="cpu", attn_impl="ring")
    mesh = Mesh(np.arange(4).reshape(2, 2), ("dp", "mdl"), rank=3)
    tp = Transformer(vocab=64, d_model=32, n_layers=1, n_heads=4, d_ff=64,
                     device="meta", mesh=mesh, tp_axis="mdl")
    full = init_params(Transformer(vocab=64, d_model=32, n_layers=1,
                                   n_heads=4, d_ff=64, device="cpu"),
                       seed=0, device="cpu")
    local = tp.local_params(full)
    assert tuple(local["block0.attn.q.weight"].shape) == (16, 32)
    assert torch.equal(local["block0.mlp.down.weight"],
                       full["block0.mlp.down.weight"][:, 32:])
    assert torch.equal(local["embed"], full["embed"][32:])
    assert local["norm_f.scale"] is full["norm_f.scale"]
    bound = tp.bind(local)
    assert bound.block0.attn.q.kind() == "column"
    assert bound.block0.attn.out.kind() == "row"
    moe = Transformer(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                      device="cpu", n_experts=4, lora_rank=2)
    assert moe.block1.is_moe and not moe.block0.is_moe
    assert tuple(moe.block0.mlp.up.lora_a.shape) == (32, 2)
    quant = Transformer(vocab=64, d_model=32, n_layers=1, n_heads=4,
                        d_ff=64, device="cpu", weight_quant="int8")
    assert quant.lm_head.q.dtype == torch.int8
    tm = Transformer(vocab=64, d_model=32, n_layers=1, n_heads=4, d_ff=64,
                     attn_window=4, device="cpu")
    ring = init_cache(tm, 1, 8, device="cpu")
    assert ring["block0/attn/cached_key"].shape == (1, 4, 4, 8)


def test_init_params_scales_and_meta_model():
    """init_params draws at the flax initialisers' scales; a meta model
    runs with them through bind()."""
    tm = Transformer(vocab=64, d_model=32, n_layers=2, n_heads=4,
                     n_kv_heads=2, d_ff=64, compute_dtype=torch.float32,
                     device="meta")
    sd = init_params(tm, seed=0, device="cpu")
    assert abs(float(sd["embed"].std()) - 0.02) < 0.003
    w = sd["block0.mlp.up.weight"]
    assert abs(float(w.std()) - (1 / 32) ** 0.5) < 0.03
    assert float(w.abs().max()) <= 2 * (1 / 32) ** 0.5 / 0.8796 + 1e-6
    assert torch.equal(sd["norm_f.scale"], torch.ones(32))
    with torch.no_grad():
        out = tm.bind(sd)(torch.from_numpy(_tokens(9, (1, 5))))
    assert out.shape == (1, 5, 64) and torch.isfinite(out).all()
    again = init_params(tm, seed=0, device="cpu")
    assert all(torch.equal(sd[k], again[k]) for k in sd)


@pytest.mark.parametrize("top_k,top_p", [(None, None), (5, None),
                                         (None, 0.7), (8, 0.9)])
def test_filtered_logits_match_jax(top_k, top_p):
    from tpunet.models.generate import filtered_logits as jax_filtered
    from tpunet_torch.models.generate import filtered_logits, make_sampler

    logits = np.random.default_rng(10).standard_normal((3, 64)).astype(
        np.float32)
    want = np.asarray(jax_filtered(jnp.asarray(logits), 0.8, top_k, top_p))
    got = filtered_logits(torch.from_numpy(logits), 0.8, top_k, top_p)
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[finite], want[finite], rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    drawn = make_sampler(0.8, top_k, top_p)(torch.from_numpy(logits), gen)
    assert drawn.dtype == torch.int32
    assert finite[np.arange(3), drawn.numpy()].all()  # only kept tokens
    greedy = make_sampler(0.0, None, None)(torch.from_numpy(logits))
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))


def test_cache_index_helpers():
    from tpunet_torch.models.generate import (_get_cache_index,
                                              _set_cache_index)

    tm = Transformer(vocab=64, d_model=32, n_layers=3, n_heads=4, d_ff=64,
                     compute_dtype=torch.float32, device="meta")
    cache = init_cache(tm, 2, 8, per_row=True, device="cpu")
    moved = _set_cache_index(cache, torch.tensor([3, 5], dtype=torch.int32))
    assert _get_cache_index(moved).tolist() == [3, 5]
    assert _get_cache_index(cache).tolist() == [0, 0]  # a new dict
    assert all(moved[k] is cache[k] for k in cache
               if not k.endswith("/cache_index"))
    lockstep = _set_cache_index(init_cache(tm, 2, 8, device="cpu"), 4)
    assert _get_cache_index(lockstep).shape == () and int(
        _get_cache_index(lockstep)) == 4


@pytest.mark.parametrize("attn_impl", ["flash", "reference"])
def test_f16_logits_with_head_dim_12_match_jax(attn_impl):
    """A float16 model whose head dim (48 / 4 = 12) is no multiple of 8, the
    two inputs the card's flash path once refused: its logits match the JAX
    model's `compute_dtype=jnp.float16`. Tolerance 1e-2: every matmul and
    norm rounds to f16 (11 significant bits, 2e-3 at |x| < 4) on both
    sides, in places that differ between the two frameworks, over 2 blocks
    (the gap read 2.9e-3)."""
    cfg = dict(vocab=64, d_model=48, n_layers=2, n_heads=4, n_kv_heads=2,
               d_ff=96, attn_impl=attn_impl)
    jm = JaxTransformer(compute_dtype=jnp.float16, **cfg)
    tm = Transformer(compute_dtype=torch.float16, device="cpu", **cfg)
    toks = _tokens(11, (2, 21))
    params = jax.jit(jm.init)(jax.random.PRNGKey(3),
                              jnp.asarray(toks))["params"]
    sd = from_flax(jax.tree.map(np.asarray, params), tm)
    want = np.asarray(_jax_apply(jm, {"params": params}, jnp.asarray(toks)),
                      np.float32)
    with torch.no_grad():
        got = tm.bind(sd)(torch.from_numpy(toks))
    assert np.abs(want).max() < 4
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2,
                               rtol=1e-2)
