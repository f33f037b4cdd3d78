"""The port's rolling ring decode cache (attn_window with
decode_ring_cache=True) against the JAX package's, on the CPU, f32, with
flax weights carried across by from_flax: leaf shapes, generate tokens
equal to the flax model's and to the full-capacity masked cache's, steps
past the window exact against the full forward, per-row GQA rows
independent, a ring smaller than the window NaN-poisoned past capacity,
and the plain BatchServer on the ring."""

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
from tpunet.models import init_cache as jax_init_cache
from tpunet_torch import serve
from tpunet_torch.models import (BatchServer, Transformer, from_flax,
                                 generate, init_cache)
from tpunet_torch.models.generate import _set_cache_index

TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread is ~10x quicker than a pool
    (restored after the module, so other files keep their setting)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _pair_cached(items):
    cfg = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64)
    cfg.update(items)
    jm = JaxTransformer(compute_dtype=jnp.float32, **cfg)
    tm = Transformer(compute_dtype=torch.float32, device="cpu", **cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    return jm, tm, params, from_flax(jax.tree.map(np.asarray, params), tm)


def _pair(**kw):
    """(flax model, port model, flax params, port state_dict)."""
    return _pair_cached(tuple(sorted(kw.items())))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 64, shape).astype(
        np.int32)


def _kv_lengths(cache):
    return sorted({v.shape[1] for k, v in cache.items()
                   if not k.endswith("cache_index")})


@pytest.mark.parametrize("window,cap,want", [(6, 24, 6), (100, 24, 24)])
def test_ring_cache_leaf_shapes_bounded_by_window(window, cap, want):
    """Leaves of min(window, capacity), as the flax cache's; the masked
    cache keeps the full capacity."""
    jm, tm, _, _ = _pair(attn_window=window)
    ring = init_cache(tm, 2, cap, device="cpu")
    jring = jax_init_cache(jm, 2, cap)
    assert _kv_lengths(ring) == [want]
    assert sorted({x.shape[1] for x in jax.tree.leaves(jring)
                   if x.ndim == 4}) == [want]
    masked = init_cache(tm.clone(decode_ring_cache=False), 2, cap,
                        device="cpu")
    assert _kv_lengths(masked) == [cap]


@pytest.mark.parametrize("n_kv_heads", [None, 2])
def test_ring_generate_matches_flax_and_masked_cache(n_kv_heads):
    """Greedy tokens on the ring equal the flax model's on its ring, and the
    port's own masked cache's; chunked prefill (s > 1 steps through the
    ring) and sampling from one generator seed agree with the masked cache
    too."""
    jm, tm, params, sd = _pair(attn_window=6, n_kv_heads=n_kv_heads)
    prompt = _tokens(3, (2, 9))  # longer than the window: the ring wraps
    want = np.asarray(jax.jit(functools.partial(
        jax_generate, jm, max_new_tokens=15))(params, jnp.asarray(prompt)))
    ring = generate(tm, sd, prompt, 15)
    np.testing.assert_array_equal(ring.numpy(), want)
    masked_model = tm.clone(decode_ring_cache=False)
    masked = generate(masked_model, sd, prompt, 15)
    assert torch.equal(ring, masked)
    assert torch.equal(generate(tm, sd, prompt, 15, prefill_chunk=4),
                       masked)
    kw = dict(temperature=0.8, top_k=8)
    s_ring = generate(tm, sd, prompt, 15, generator=torch.Generator(
        ).manual_seed(7), **kw)
    s_masked = generate(masked_model, sd, prompt, 15,
                        generator=torch.Generator().manual_seed(7), **kw)
    assert torch.equal(s_ring, s_masked)


def test_ring_steps_past_window_match_full_forward_and_flax():
    """A ring of exactly the window never overflows: 20 one-token steps
    through a 4-slot ring stay finite and match the full-sequence forward
    at every position, and the flax ring step's logits."""
    jm, tm, params, sd = _pair(attn_window=4)
    toks = _tokens(5, (2, 20))
    net = tm.bind(sd)
    with torch.no_grad():
        full = net(torch.from_numpy(toks)).numpy()
    cache = init_cache(tm, 2, 4, device="cpu")
    dm = jm.clone(decode=True)
    jcache = jax_init_cache(jm, 2, 4)
    step = jax.jit(lambda c, t: dm.apply({"params": params, "cache": c}, t,
                                         mutable=["cache"]))
    for i in range(20):
        with torch.no_grad():
            got = net(torch.from_numpy(toks[:, i:i + 1]), cache=cache)
        jlog, mut = step(jcache, jnp.asarray(toks[:, i:i + 1]))
        jcache = mut["cache"]
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, i], atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(jlog), atol=1e-4,
                                   rtol=1e-4)


def test_ring_per_row_gqa_rows_independent():
    """Per-row ring (the serving substrate): rows at different offsets wrap
    independently; a row reset to 0 (a recycled slot) never sees its
    predecessor's K/V; each row's logits match the full forward at its own
    position."""
    _, tm, _, sd = _pair(attn_window=5, n_kv_heads=2)
    toks = _tokens(6, (2, 16))
    net = tm.bind(sd)
    with torch.no_grad():
        full = net(torch.from_numpy(toks)).numpy()
    cache = init_cache(tm, 2, 5, per_row=True, device="cpu")
    t = torch.from_numpy(toks)
    with torch.no_grad():
        for i in range(3):
            net(torch.stack([t[0, i:i + 1], t[1, 0:1]]), cache=cache)
        cache = _set_cache_index(cache, torch.tensor([3, 0],
                                                     dtype=torch.int32))
        for i in range(10):
            step = net(torch.stack([t[0, 3 + i:4 + i], t[1, i:i + 1]]),
                       cache=cache)
            np.testing.assert_allclose(step[0, 0].numpy(), full[0, 3 + i],
                                       atol=TOL, rtol=TOL)
            np.testing.assert_allclose(step[1, 0].numpy(), full[1, i],
                                       atol=TOL, rtol=TOL)


def test_ring_window_wider_than_capacity_poisons_past_cap():
    """cap < window: the ring would wrap before the window does, so the
    step past capacity is NaN-poisoned, as in flax."""
    jm, tm, params, sd = _pair(attn_window=100)
    toks = _tokens(7, (2, 12))
    net = tm.bind(sd)
    cache = init_cache(tm, 2, 8, device="cpu")
    with torch.no_grad():
        for i in range(8):
            assert torch.isfinite(
                net(torch.from_numpy(toks[:, i:i + 1]), cache=cache)).all()
        over = net(torch.from_numpy(toks[:, 8:9]), cache=cache)
    assert torch.isnan(over).all()
    dm = jm.clone(decode=True)
    step = jax.jit(lambda c, t: dm.apply({"params": params, "cache": c}, t,
                                         mutable=["cache"]))
    jc = jax_init_cache(jm, 2, 8)
    for i in range(9):
        jlog, mut = step(jc, jnp.asarray(toks[:, i:i + 1]))
        jc = mut["cache"]
    assert bool(jnp.all(jnp.isnan(jlog)))


def test_batch_server_on_the_ring_matches_generate():
    """The plain BatchServer serves a windowed model on the ring (leaves of
    the window), each request's tokens equal to generate's; shipped-KV
    serving keeps refusing windowed models."""
    _, tm, _, sd = _pair(attn_window=6, n_kv_heads=2)
    srv = BatchServer(tm, sd, slots=2, max_len=32, steps_per_call=2,
                      device="cpu")
    assert _kv_lengths(srv._cache) == [6]
    prompts = [_tokens(10 + i, (n,)) for i, n in enumerate((5, 9, 7))]
    lens = (12, 6, 9)
    ids = [srv.submit(p, n) for p, n in zip(prompts, lens)]
    res = srv.run()
    for rid, p, n in zip(ids, prompts, lens):
        want = generate(tm, sd, p[None], n)[0, len(p):].numpy()
        np.testing.assert_array_equal(res[rid], want)
    with pytest.raises(ValueError, match="full-capacity"):
        srv.submit_kv(prompts[0], 4, [], np.zeros(64, np.float32))
    with pytest.raises(ValueError, match="full-capacity"):
        serve.PrefillEngine(tm, sd, max_len=32, device="cpu")
