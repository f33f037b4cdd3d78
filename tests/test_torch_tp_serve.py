"""The port's decoding under tensor parallelism against the JAX package,
where GSPMD splits the decode cache by its kv heads from the parameters'
shardings alone: ``generate`` (tests/test_generate.py's
test_generate_tp_dp_sharded_matches_replicated), int8 ``generate``
(tests/test_quant.py's test_quant_tp_sharded_matches_single_replica), the
plain and speculative ``BatchServer`` of the multichip dry run
(``__graft_entry__.py``'s ``_dryrun_serve``: windowed GQA, per-row ring
cache, slots 2), a sampled ``generate`` whose mdl group draws one token
stream, and the single-rank serving tiers' refusal of a mesh model.

The port runs in ONE spawn of 4 torch-only ranks
(tests/torch_mesh_ranks.py) over {dp: 2, mdl: 2}, the JAX tests' own mesh
(the dry run's dp x mdl at 8 devices is mdl 4; 4 ranks give mdl 2): each
rank takes its prompt rows over dp and its blocks of the flax init
(``from_flax``, then the port's partition rules); every rank of a server
runs all its requests. Ties: the mdl all-reduce reassociates float sums,
so, as in the JAX tests, every token must be a near-argmax (atol 1e-3) of
JAX's replicated logits on the port's own prefix.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

from conftest import free_port  # noqa: F401  (pins JAX_PLATFORMS=cpu first)

import jax
import jax.numpy as jnp
import torch
from torch_mesh_ranks import spawn

from tpunet.models import Transformer as JaxTransformer
from tpunet.models import generate as jax_generate
from tpunet.models import quantize_params as jax_quantize
from tpunet_torch.models import BatchServer, Transformer, from_flax
from tpunet_torch.parallel import Mesh
from tpunet_torch.serve import DecodeWorker, PrefillEngine

TIE_ATOL = 1e-3
TP_MESH = (("dp", 2), ("mdl", 2))
GQA = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
           n_kv_heads=2)
WINDOWED = dict(GQA, attn_window=6)
MAX_NEW = 6
SERVE = dict(slots=2, max_len=24, temperature=0.0)
SAMPLED = dict(temperature=0.8, top_k=10, seed=7)


@functools.lru_cache(maxsize=None)
def _model(name: str):
    """(flax model, flax params, port params, prompts) of the test's
    model: "gqa" (tests/test_generate.py's), "int8" (its quantize_params),
    "windowed" (the dry run's serve model, with its 3 requests)."""
    if name == "windowed":
        rng = np.random.default_rng(0)
        toks = rng.integers(0, 64, size=(1, 12)).astype(np.int32)
        model = JaxTransformer(compute_dtype=jnp.float32, **WINDOWED)
        params = model.init(jax.random.PRNGKey(0), toks)["params"]
        prompts = [(rng.integers(0, 64, size=n).astype(np.int32), m)
                   for n, m in ((8, 6), (8, 9), (10, 4))]
        cfg = WINDOWED
    else:
        prompts = np.random.default_rng(3).integers(0, 64, (4, 12)).astype(
            np.int32)
        model = JaxTransformer(compute_dtype=jnp.float32, **GQA)
        params = model.init(jax.random.PRNGKey(1), prompts)["params"]
        cfg = GQA
        if name == "int8":
            model = model.clone(weight_quant="int8")
            params = jax_quantize(params)
            cfg = dict(GQA, weight_quant="int8")
    tm = Transformer(compute_dtype=torch.float32, device="cpu", **cfg)
    sd = {n: t.numpy() for n, t in from_flax(
        jax.tree.map(np.asarray, params), tm, device="cpu").items()}
    return model, params, sd, prompts, cfg


def _near_argmax(model, params, seq: np.ndarray, start: int, err: str):
    """Every token of `seq` (b, s) from position `start` on is within
    TIE_ATOL of the max of JAX's logits on the prefix before it."""
    logits = np.asarray(jax.jit(lambda p, t: model.apply({"params": p}, t))(
        params, jnp.asarray(seq[:, :-1])))[:, start - 1:]
    chosen = np.take_along_axis(logits, seq[:, start:, None], axis=2)[..., 0]
    np.testing.assert_allclose(chosen, logits.max(axis=2), atol=TIE_ATOL,
                               err_msg=err)


@functools.lru_cache(maxsize=None)
def _ranks() -> dict:
    cases = {}
    for name in ("gqa", "int8"):
        _, _, sd, prompts, cfg = _model(name)
        cases[f"generate-{name}"] = ("generate", dict(
            axes=TP_MESH, cfg=cfg, params=sd, prompt=prompts,
            max_new=MAX_NEW))
    _, _, sd, prompts, cfg = _model("gqa")
    cases["sampled"] = ("generate", dict(axes=TP_MESH, cfg=cfg, params=sd,
                                         prompt=prompts, max_new=MAX_NEW,
                                         **SAMPLED))
    _, _, sd, requests, cfg = _model("windowed")
    qsd = {n: t.numpy() for n, t in from_flax(
        jax.tree.map(np.asarray, jax_quantize(_model("windowed")[1])),
        Transformer(compute_dtype=torch.float32, device="cpu",
                    weight_quant="int8", **cfg), device="cpu").items()}
    cases["serve"] = ("serve", dict(axes=TP_MESH, cfg=cfg, params=sd,
                                    requests=requests,
                                    server=dict(SERVE, steps_per_call=4)))
    cases["serve-spec"] = ("serve", dict(axes=TP_MESH, cfg=cfg, params=sd,
                                         requests=requests,
                                         server=dict(SERVE, gamma=3),
                                         draft_params=qsd))
    return spawn(4, cases)


@pytest.mark.parametrize("name", ["gqa", "int8"])
def test_tp_dp_generate_matches_replicated(name):
    """generate over {dp: 2, mdl: 2}, the prompt's rows over dp, the cache
    of each rank its one kv head of two; int8: q and the scale split with
    the output dim (column), q by input and the scale whole (row)."""
    model, params, _, prompts, _ = _model(name)
    want = np.asarray(jax_generate(model, params, jnp.asarray(prompts),
                                   MAX_NEW))
    for rank, res in _ranks().items():
        got = res[f"generate-{name}"]
        assert isinstance(got, dict), got
        seq = got["tokens"]
        assert seq.shape == want.shape
        np.testing.assert_array_equal(seq[:, :12], prompts)
        _near_argmax(model, params, seq, 12, f"rank {rank}")


def test_sampled_tp_generate_draws_one_stream_a_tp_group():
    """Sampling under TP: the logits are gathered over mdl and the ranks
    of a group pass generators of one seed, so they emit the same
    tokens; the two dp groups sample their own rows."""
    res = _ranks()
    for r in res.values():
        assert isinstance(r["sampled"], dict), r["sampled"]
    for a, b in ((0, 1), (2, 3)):   # rank = dp * 2 + mdl
        np.testing.assert_array_equal(res[a]["sampled"]["local"],
                                      res[b]["sampled"]["local"])
    toks = res[0]["sampled"]["tokens"]
    assert toks.shape == (4, 12 + MAX_NEW)
    assert ((toks >= 0) & (toks < GQA["vocab"])).all()


@pytest.mark.parametrize("case", ["serve", "serve-spec"])
def test_tp_batch_server_matches_unsharded_generate(case):
    """The dry run's BatchServer under dp x mdl, plain (steps_per_call 4)
    and speculative (the int8 self-draft, gamma 3), pipeline=2: every rank
    returns the same tokens, each request JAX's unsharded generate's or a
    near-argmax of its logits on the port's own prefix."""
    model, params, _, requests, _ = _model("windowed")
    res = _ranks()
    first = res[0][case]
    assert isinstance(first, dict), first
    for rank, r in res.items():
        got = r[case]
        assert isinstance(got, dict), got
        for i, (prompt, max_new) in enumerate(requests):
            np.testing.assert_array_equal(got[f"req{i}"], first[f"req{i}"],
                                          err_msg=f"rank {rank} req {i}")
    for i, (prompt, max_new) in enumerate(requests):
        toks = first[f"req{i}"]
        assert toks.shape == (max_new,)
        want = np.asarray(jax_generate(model, params,
                                       jnp.asarray(prompt)[None], max_new))
        if not np.array_equal(toks, want[0, len(prompt):]):
            _near_argmax(model, params,
                         np.concatenate([prompt, toks])[None], len(prompt),
                         f"request {i}")
    if case == "serve-spec":
        assert float(first["committed_per_round"]) > 1.0


def test_single_rank_serving_tiers_refuse_a_mesh_model():
    """The disaggregated tiers (PrefillEngine, DecodeWorker, KV shipping
    into a BatchServer) stay single-rank: a mesh model raises, naming their
    item (ROADMAP A.12); a BatchServer over the mesh itself builds."""
    mesh = Mesh(np.arange(4).reshape(2, 2), ("dp", "mdl"), rank=0)
    m = Transformer(compute_dtype=torch.float32, mesh=mesh, tp_axis="mdl",
                    device="meta", **GQA)
    local = m.local_params(m.init_params(seed=0, device="cpu"))
    assert tuple(local["block0.attn.k.weight"].shape) == (8, 32)
    with pytest.raises(NotImplementedError, match="A.12"):
        PrefillEngine(m, local, max_len=16, device="cpu")
    with pytest.raises(NotImplementedError, match="A.12"):
        DecodeWorker(m, local, None, slots=1, max_len=16)
    srv = BatchServer(m, local, slots=1, max_len=16, device="cpu")
    assert srv.kv_leaf_shapes(3)[0] == (3, 1, 8)   # one kv head of two
    with pytest.raises(NotImplementedError, match="A.12"):
        srv.submit_kv(np.arange(3), 2, [], np.zeros(64))
