"""The port's speculative decoding (speculative_generate and
BatchServer(draft_model=...)) against the JAX package's, on the CPU, f32,
flax weights carried across by from_flax.

Greedy tokens are held bitwise to the JAX package's `generate` (which JAX's
own tests hold bitwise to its `speculative_generate` and speculative
BatchServer) and, directly, to JAX's speculative_generate and speculative
BatchServer on the int8 self-draft; `_leading_accepts` and
`_residual_probs` to JAX's to 1e-6; the sampled marginal to the port's
`generate` by a chi-square test at a fixed seed."""

from __future__ import annotations

import functools
import types

import numpy as np
import pytest
from scipy import stats

from conftest import free_port  # noqa: F401  (pins JAX_PLATFORMS=cpu first)

import jax
import jax.numpy as jnp
import torch

from tpunet.models import BatchServer as JaxBatchServer
from tpunet.models import Transformer as JaxTransformer
from tpunet.models import generate as jax_generate
from tpunet.models import quantize_params as jax_quantize
from tpunet.models import speculative_generate as jax_speculative
from tpunet.models.generate import _leading_accepts as jax_leading
from tpunet.models.generate import _residual_probs as jax_residual
from tpunet_torch.models import (BatchServer, Transformer, from_flax,
                                 generate, init_params, quantize_params,
                                 speculative_generate)
from tpunet_torch.models.generate import (_get_cache_index, _leading_accepts,
                                          _residual_probs)

BASE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread is ~10x quicker than a pool
    (restored after the module, so other files keep their setting)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _pair_cached(seed, items):
    cfg = {**BASE, **dict(items)}
    jm = JaxTransformer(compute_dtype=jnp.float32, **cfg)
    tm = Transformer(compute_dtype=torch.float32, device="meta", **cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    return jm, tm, params, from_flax(jax.tree.map(np.asarray, params), tm,
                                     device="cpu")


def _pair(seed=1, **kw):
    """(flax model, port model, flax params, port state_dict)."""
    return _pair_cached(seed, tuple(sorted(kw.items())))


def _tokens(seed, shape, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _jax_oracle(items, seed, max_new, eos_id=None):
    """JAX generate's greedy tokens for the target of `items` on the prompt
    of `seed`, (3, 12)."""
    jm, _, params, _ = _pair(**dict(items))
    prompt = _tokens(seed, (3, 12), BASE["vocab"] if "vocab" not in dict(
        items) else dict(items)["vocab"])
    return np.asarray(jax.jit(functools.partial(
        jax_generate, jm, max_new_tokens=max_new, eos_id=eos_id))(
            params, jnp.asarray(prompt)))


@pytest.mark.parametrize("seed", [0, 1])
def test_leading_accepts_and_residual_probs_match_jax(seed):
    rng = np.random.default_rng(seed)
    accept = rng.random((5, 4)) < 0.7
    accept[0] = True
    np.testing.assert_array_equal(
        _leading_accepts(torch.from_numpy(accept)).numpy(),
        np.asarray(jax_leading(jnp.asarray(accept))))
    p = rng.dirichlet(np.ones(16), size=6).astype(np.float32)
    q = rng.dirichlet(np.ones(16), size=6).astype(np.float32)
    q[0] = p[0]  # identical rows: the residual falls back to p
    q[1, :8] = 0.0  # a filtered-out draft support
    got = _residual_probs(torch.from_numpy(p), torch.from_numpy(q)).numpy()
    want = np.asarray(jax_residual(jnp.asarray(p), jnp.asarray(q)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got[0], p[0])


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("draft_kind", ["smaller", "unrelated"])
@pytest.mark.parametrize("gamma", [1, 3, 4])
def test_greedy_bitwise_jax_generate(gamma, draft_kind, per_row):
    """Greedy speculative tokens equal JAX generate's (and the port's), for
    drafts of any quality: a bad draft only slows things down."""
    _, tm, _, sd = _pair()
    if draft_kind == "smaller":
        _, dm, _, dsd = _pair(seed=7, n_layers=1)
    else:
        _, dm, _, dsd = _pair(seed=99)
    prompt = _tokens(0, (3, 12))
    want = _jax_oracle((), 0, 12)
    np.testing.assert_array_equal(generate(tm, sd, prompt, 12).numpy(), want)
    got, st = speculative_generate(tm, sd, dm, dsd, prompt, 12, gamma=gamma,
                                   per_row=per_row, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and 1 <= st["rounds"] <= 11
    assert 0.0 <= st["draft_accept_rate"] <= 1.0


@functools.lru_cache(maxsize=None)
def _jax_int8_self_draft(items):
    """JAX speculative_generate's greedy tokens, lockstep, with the target's
    int8 self-draft, gamma 3 and prefill_chunk 7."""
    jm, _, params, _ = _pair(**dict(items))
    return np.asarray(jax.jit(functools.partial(
        jax_speculative, jm, draft_model=jm.clone(weight_quant="int8"),
        max_new_tokens=12, gamma=3, prefill_chunk=7))(
            params, draft_params=jax_quantize(params),
            prompt=jnp.asarray(_tokens(0, (3, 12)))))


@pytest.mark.parametrize("per_row", [False, True])
def test_int8_self_draft_matches_jax_speculative_generate(per_row):
    """The whole inference feature set in one configuration (GQA, window 12
    on the ring, chunked prefill, the int8 self-draft): tokens equal JAX's
    speculative_generate and generate's."""
    kw = dict(n_kv_heads=2, attn_window=12)
    _, tm, _, sd = _pair(**kw)
    items = tuple(sorted(kw.items()))
    want = _jax_int8_self_draft(items)
    np.testing.assert_array_equal(want, _jax_oracle(items, 0, 12))
    got, st = speculative_generate(
        tm, sd, tm.clone(weight_quant="int8"), quantize_params(sd),
        _tokens(0, (3, 12)), 12, gamma=3, prefill_chunk=7, per_row=per_row,
        return_stats=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert st["draft_accept_rate"] > 0.5


@pytest.mark.parametrize("per_row", [False, True])
def test_self_draft_accepts_everything(per_row):
    """draft == target: p == q everywhere, so every round commits gamma + 1
    tokens and the accept rate reads exactly 1.0."""
    _, tm, _, sd = _pair()
    prompt = _tokens(2, (2, 10))
    gamma, new = 3, 13
    out, st = speculative_generate(
        tm, sd, tm, sd, prompt, new, gamma=gamma, temperature=0.8,
        generator=torch.Generator().manual_seed(5), per_row=per_row,
        return_stats=True)
    assert out.shape == (2, 10 + new)
    assert st["rounds"] == -(-(new - 1) // (gamma + 1))
    assert st["draft_accept_rate"] == 1.0
    assert ((out >= 0) & (out < 64)).all()


def test_sampled_marginal_matches_generate():
    """Over 4096 identical prompts, each of the first 3 generated
    positions' token histogram from speculative sampling (an unrelated
    draft forcing real rejections, top-k filtering) is the same
    distribution as the port's generate's: chi-square homogeneity test,
    p > 1e-3, at fixed generator seeds."""
    cfg = dict(vocab=16, d_model=16, n_layers=1, n_heads=2, d_ff=32)
    tm = Transformer(compute_dtype=torch.float32, device="cpu", **cfg)
    sd = init_params(tm, seed=1, device="cpu")
    dsd = init_params(tm, seed=123, device="cpu")
    b = 4096
    prompt = np.tile(np.array([[3, 1, 2, 7]], np.int32), (b, 1))
    kw = dict(temperature=1.0, top_k=12)
    anc = generate(tm, sd, prompt, 3, generator=torch.Generator(
        ).manual_seed(11), **kw).numpy()
    spec, st = speculative_generate(
        tm, sd, tm, dsd, prompt, 3, gamma=2, generator=torch.Generator(
            ).manual_seed(22), return_stats=True, **kw)
    spec = spec.numpy()
    assert st["draft_accept_rate"] < 0.9  # rejections really happen
    for pos in range(4, 7):
        a = np.bincount(anc[:, pos], minlength=16)
        s = np.bincount(spec[:, pos], minlength=16)
        keep = (a + s) > 0
        if pos == 4:  # one shared prefix: exactly the top-k support
            assert (a > 0).sum() <= 12 and (s > 0).sum() <= 12
        p = stats.chi2_contingency(np.stack([a[keep], s[keep]]))[1]
        assert p > 1e-3, (pos, p, a, s)


@pytest.mark.parametrize("per_row", [False, True])
def test_eos_pins_tail_and_matches_generate(per_row):
    """After a row emits eos every later token is eos, also within one
    committed block; greedy with eos equals JAX generate with eos."""
    items = (("vocab", 8),)
    _, tm, _, sd = _pair(vocab=8)
    _, dm, _, dsd = _pair(seed=9, vocab=8, n_layers=1)
    prompt = _tokens(0, (3, 12), 8)
    want = _jax_oracle(items, 0, 16, eos_id=5)
    got = speculative_generate(tm, sd, dm, dsd, prompt, 16, gamma=3,
                               eos_id=5, per_row=per_row).numpy()
    np.testing.assert_array_equal(got, want)
    for row in got[:, 12:]:
        hits = np.nonzero(row == 5)[0]
        if hits.size:
            assert (row[hits[0]:] == 5).all()
    assert (want[:, 12:] == 5).any()  # eos does occur


@pytest.mark.parametrize("chunk", [4, 5, 12, 100])
def test_chunked_prefill_parity(chunk):
    """prefill_chunk re-blocks the same computation on a GQA + window model
    on the ring: dividing, remainder and oversized chunks give the
    unchunked tokens, plain and speculative."""
    _, tm, _, sd = _pair(n_kv_heads=2, attn_window=10)
    _, dm, _, dsd = _pair(seed=3, n_layers=1, n_kv_heads=2, attn_window=10)
    prompt = _tokens(4, (2, 24))
    want = generate(tm, sd, prompt, 8)
    assert torch.equal(generate(tm, sd, prompt, 8, prefill_chunk=chunk), want)
    got = speculative_generate(tm, sd, dm, dsd, prompt, 8, gamma=2,
                               prefill_chunk=chunk)
    assert torch.equal(got, want)


@pytest.mark.parametrize("temperature,per_row", [
    (0.0, False), (0.0, True), (0.9, False), (0.9, True)])
def test_spec_ring_cache_matches_masked_cache(temperature, per_row):
    """With gamma + 1 <= window speculation runs on the ring (stash and
    restore of the overwritten slots) and gives the masked cache's tokens
    from one generator seed; greedy, also generate's."""
    _, tm, _, sd = _pair(n_kv_heads=2, attn_window=8)
    _, dm, _, dsd = _pair(seed=3, n_layers=1, n_kv_heads=2, attn_window=8)
    prompt = _tokens(5, (3, 6))
    kw = dict(gamma=3, temperature=temperature, per_row=per_row)
    if temperature:
        kw["top_k"] = 8
    ring = speculative_generate(tm, sd, dm, dsd, prompt, 12,
                                generator=torch.Generator().manual_seed(11),
                                **kw)
    masked = speculative_generate(
        tm.clone(decode_ring_cache=False), sd,
        dm.clone(decode_ring_cache=False), dsd, prompt, 12,
        generator=torch.Generator().manual_seed(11), **kw)
    assert torch.equal(ring, masked)
    if not temperature:
        assert torch.equal(ring, generate(tm, sd, prompt, 12))


def test_spec_narrow_window_falls_back_to_masked_cache():
    """gamma + 1 > window: a round would lap the ring, so speculation runs
    the full-capacity masked cache, and still gives generate's tokens."""
    _, tm, _, sd = _pair(n_kv_heads=2, attn_window=4)
    _, dm, _, dsd = _pair(seed=3, n_layers=1, n_kv_heads=2, attn_window=4)
    prompt = _tokens(6, (2, 6))
    got = speculative_generate(tm, sd, dm, dsd, prompt, 8, gamma=4)
    assert torch.equal(got, generate(tm, sd, prompt, 8))


def test_sampled_runs_repeat_per_generator_seed():
    """Sampling draws only from the given generator: one seed, one
    output; the draws stay in the vocabulary."""
    _, tm, _, sd = _pair()
    _, dm, _, dsd = _pair(seed=7, n_layers=1)
    prompt = _tokens(7, (3, 6))
    runs = [speculative_generate(
        tm, sd, dm, dsd, prompt, 9, gamma=2, temperature=0.8, top_p=0.9,
        per_row=True, generator=torch.Generator().manual_seed(3))
        for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert ((runs[0] >= 0) & (runs[0] < 64)).all()


def test_validation_errors_mirror_jax():
    _, tm, _, sd = _pair()
    prompt = _tokens(0, (1, 4))
    with pytest.raises(ValueError, match="gamma"):
        speculative_generate(tm, sd, tm, sd, prompt, 4, gamma=0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        speculative_generate(tm, sd, tm, sd, prompt, 0)
    with pytest.raises(ValueError, match="top_k"):
        speculative_generate(tm, sd, tm, sd, prompt, 4, top_k=3)
    with pytest.raises(ValueError, match="vocab"):
        speculative_generate(tm, sd, tm.clone(vocab=32), sd, prompt, 4)
    meta = {k: torch.empty_like(v, device="meta") for k, v in sd.items()}
    with pytest.raises(ValueError, match="draft_params"):
        speculative_generate(tm, sd, tm, meta, prompt, 4)
    gen = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError, match="generator"):
        speculative_generate(tm, sd, tm, sd, prompt, 4, temperature=0.5,
                             generator=gen)


def test_speculative_entry_points_use_the_card_unless_asked(monkeypatch):
    """device=None is the GPU: the speculative BatchServer raises without
    one; speculative_generate runs where its params are (CPU here, since
    the caller gave CPU params)."""
    _, tm, _, sd = _pair()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchServer(tm, sd, slots=1, max_len=8, draft_model=tm,
                    draft_params=sd)
    out = speculative_generate(tm, sd, tm, sd, _tokens(0, (1, 3)), 2)
    assert out.device.type == "cpu"


# -- the speculative BatchServer ---------------------------------------------


def _server_oracle(tm, sd, prompt, n):
    return generate(tm, sd, prompt[None], n)[0, len(prompt):].numpy()


@pytest.mark.parametrize("steps_per_call,pipeline", [(1, 1), (4, 1), (2, 2)])
def test_spec_server_greedy_matches_generate_mixed_lengths(steps_per_call,
                                                           pipeline):
    """Mixed prompt lengths and budgets over 2 slots: every request's tokens
    equal generate's (itself JAX's generate, test_greedy_bitwise_jax_generate),
    also with multi-round windows and a second window in flight."""
    _, tm, _, sd = _pair()
    _, dm, _, dsd = _pair(seed=9, n_layers=1)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 50, 5 + i % 3).astype(np.int32), n)
            for i, n in enumerate([4, 11, 6, 13, 3, 8])]
    srv = BatchServer(tm, sd, draft_model=dm, draft_params=dsd, slots=2,
                      max_len=24, gamma=3, steps_per_call=steps_per_call,
                      device="cpu")
    ids = [srv.submit(p, n) for p, n in reqs]
    res = srv.run(pipeline=pipeline)
    for rid, (p, n) in zip(ids, reqs):
        np.testing.assert_array_equal(res[rid], _server_oracle(tm, sd, p, n))
    assert srv.stats["spec_rounds"] > 0
    assert srv.stats["spec_committed"] >= srv.stats["spec_rounds"]


def test_spec_server_int8_self_draft_matches_jax_server():
    """The int8 self-draft (the draft the repo's benchmarks run): tokens
    equal JAX's speculative BatchServer's on the same weights, and rounds
    commit more than 2 tokens on average in both."""
    jm, tm, params, sd = _pair()
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, 50, 6).astype(np.int32), 12) for _ in range(3)]
    jsrv = JaxBatchServer(jm, params, draft_model=jm.clone(
        weight_quant="int8"), draft_params=jax_quantize(params), slots=2,
        max_len=24, gamma=4)
    jids = [jsrv.submit(p, n) for p, n in reqs]
    want = jsrv.run()
    srv = BatchServer(tm, sd, draft_model=tm.clone(weight_quant="int8"),
                      draft_params=quantize_params(sd), slots=2, max_len=24,
                      gamma=4, device="cpu")
    ids = [srv.submit(p, n) for p, n in reqs]
    res = srv.run()
    for rid, jid in zip(ids, jids):
        np.testing.assert_array_equal(res[rid], np.asarray(want[jid]))
    for st in (srv.stats, jsrv.stats):
        assert st["spec_committed"] / max(st["spec_rounds"], 1) > 2.0, st


def test_spec_server_windowed_ring_matches_generate():
    """A windowed target and draft speculate on the ring (leaves of the
    window, gamma + 1 <= window), tokens equal to generate's."""
    _, tm, _, sd = _pair(attn_window=8)
    _, dm, _, dsd = _pair(seed=9, n_layers=1, attn_window=8)
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, 50, 6).astype(np.int32), n) for n in (5, 12, 7)]
    srv = BatchServer(tm, sd, draft_model=dm, draft_params=dsd, slots=2,
                      max_len=24, gamma=3, device="cpu")
    ids = [srv.submit(p, n) for p, n in reqs]
    res = srv.run()
    for rid, (p, n) in zip(ids, reqs):
        np.testing.assert_array_equal(res[rid], _server_oracle(tm, sd, p, n))
    for cache in (srv._cache, srv._dcache):
        assert {v.shape[1] for k, v in cache.items()
                if not k.endswith("cache_index")} == {8}


def test_spec_server_eos_cuts_mid_round_and_idle_rows_park_at_capacity():
    """A request retires at its first eos even inside a round's block; an
    idle slot's frontier parks at max_len + gamma + 1 (the caches'
    capacity), not at max_len, and never passes it."""
    _, tm, _, sd = _pair()
    _, dm, _, dsd = _pair(seed=9, n_layers=1)
    p = np.arange(2, 8).astype(np.int32)
    ref = _server_oracle(tm, sd, p, 12)
    eos = int(ref[4])
    first = int(np.nonzero(ref == eos)[0][0])
    srv = BatchServer(tm, sd, slots=1, max_len=24, eos_id=eos,
                      draft_model=dm, draft_params=dsd, gamma=3,
                      device="cpu")
    rid = srv.submit(p, 12)
    np.testing.assert_array_equal(srv.run()[rid], ref[:first + 1])

    srv = BatchServer(tm, sd, slots=2, max_len=24, draft_model=dm,
                      draft_params=dsd, gamma=3, device="cpu")
    short = srv.submit(np.arange(20), 1)  # slot 1, idle at once
    long = srv.submit(np.arange(4), 20)   # slot 0, ~1 token a round
    res = srv.run()
    np.testing.assert_array_equal(
        res[long], _server_oracle(tm, sd, np.arange(4), 20))
    assert res[short].shape == (1,)
    for cache in (srv._cache, srv._dcache):
        assert _get_cache_index(cache).tolist()[1] == 28


def test_spec_server_sampled_runs_and_validates():
    """Sampling with idle (NaN-poisoned) slots draws in-vocab tokens from
    the server's generator; construction mirrors JAX's refusals, and
    shipped-KV refills are refused."""
    _, tm, _, sd = _pair()
    _, dm, _, dsd = _pair(seed=9, n_layers=1)
    srv = BatchServer(tm, sd, slots=3, max_len=20, temperature=0.8,
                      top_k=8, draft_model=dm, draft_params=dsd, gamma=2,
                      generator=torch.Generator().manual_seed(0),
                      device="cpu")
    ids = [srv.submit(np.arange(1, 7), n) for n in (8, 2, 14)]
    res = srv.run()
    for rid, n in zip(ids, (8, 2, 14)):
        assert res[rid].shape == (n,)
        assert ((res[rid] >= 0) & (res[rid] < 64)).all()
    with pytest.raises(ValueError, match="non-speculative"):
        srv.submit_kv(np.arange(1, 7), 2, [], np.zeros(64, np.float32))
    with pytest.raises(ValueError, match="draft_model and draft_params"):
        BatchServer(tm, sd, slots=1, max_len=8, draft_model=dm,
                    device="cpu")
    with pytest.raises(ValueError, match="gamma"):
        BatchServer(tm, sd, slots=1, max_len=8, draft_model=dm,
                    draft_params=dsd, gamma=0, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        BatchServer(tm, sd, slots=1, max_len=8, draft_model=tm.clone(
            vocab=32), draft_params=dsd, device="cpu")


def test_sampled_server_idle_slot_past_max_len_keeps_serving():
    """An idle slot parks at max_len, where its step is NaN-poisoned: the
    sampled server draws garbage for it (as JAX's categorical does)
    instead of refusing the NaN row and stopping every other request."""
    _, tm, _, sd = _pair()
    srv = BatchServer(tm, sd, slots=2, max_len=24, temperature=0.8,
                      generator=torch.Generator().manual_seed(0),
                      device="cpu")
    short = srv.submit(np.arange(20), 2)   # idle from its 2nd token on
    long = srv.submit(np.arange(4), 18)    # outlives it past max_len
    res = srv.run()
    assert res[short].shape == (2,) and res[long].shape == (18,)
    assert ((res[long] >= 0) & (res[long] < 64)).all()
