"""The port's decoding under tensor parallelism against the JAX package,
where GSPMD splits the decode cache by its kv heads from the parameters'
shardings alone: ``generate`` (tests/test_generate.py's
test_generate_tp_dp_sharded_matches_replicated), int8 ``generate``
(tests/test_quant.py's test_quant_tp_sharded_matches_single_replica), the
plain and speculative ``BatchServer`` of the multichip dry run
(``__graft_entry__.py``'s ``_dryrun_serve``: windowed GQA, per-row ring
cache, slots 2), a sampled ``generate`` whose mdl group draws one token
stream, and the disaggregated serving tiers over tp groups of ranks
(JAX's ``tpunet.serve`` tiers, given sharded params, ship whole kv heads:
the port's groups ship the single-rank tier's block).

The port runs in ONE spawn of 4 torch-only ranks
(tests/torch_mesh_ranks.py) over {dp: 2, mdl: 2}, the JAX tests' own mesh
(the dry run's dp x mdl at 8 devices is mdl 4; 4 ranks give mdl 2): each
rank takes its prompt rows over dp and its blocks of the flax init
(``from_flax``, then the port's partition rules); every rank of a server
runs all its requests. The tier cases pair the dp-0 group (prefill, the
Router on its leader, rank 0) with the dp-1 group (decode), or a group
with a single-rank tier on rank 0, also over {mdl: 4}, where two ranks
hold each of the 2 kv heads. Ties: the mdl all-reduce reassociates float sums,
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
from tpunet import serve as jax_serve
from tpunet_torch.models import BatchServer, Transformer, from_flax
from tpunet_torch.models.transformer import _head_layout
from tpunet_torch.parallel import Mesh
from tpunet_torch.serve import PrefillEngine, Router, WeightPublisher

TIE_ATOL = 1e-3
TP_MESH = (("dp", 2), ("mdl", 2))
MDL4 = (("mdl", 4),)
# Distinct prompt lengths: every refill is a (1, p) claim, the shape the
# prefill tier runs.
TIER_LENS, TIER_NEW = (5, 9, 13, 7), (8, 6, 8, 5)
TIER = dict(slots=2, max_len=40)
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
    _, _, sd, _, cfg = _model("gqa")
    for name, axes in (("mdl2", TP_MESH), ("mdl4", MDL4)):
        cases[f"prefill-{name}"] = ("tier_prefill", dict(
            axes=axes, cfg=cfg, params=sd, prompts=_tier_prompts(),
            max_len=TIER["max_len"]))
    reqs = list(zip(_tier_prompts(), TIER_NEW))
    for name, axes, kw in (
            ("tier-f32", TP_MESH, dict(reference=True)),
            ("tier-mesh-single", TP_MESH, dict(decode="single")),
            ("tier-single-mesh", MDL4, dict(prefill="single"))):
        cases[name] = ("tier", dict(axes=axes, cfg=cfg, params=sd,
                                    requests=reqs, **TIER, **kw))
    cases["tier-int8"] = ("tier", dict(
        axes=TP_MESH, cfg=cfg, params=sd, kv_codec="int8",
        requests=[(p, 6) for p in _tier_prompts((8, 8, 8), seed=3)], **TIER))
    cases["tier-swap"] = ("tier_swap", dict(axes=TP_MESH, cfg=cfg,
                                            params=sd, **TIER))
    return spawn(4, cases)


def _tier_prompts(lens=TIER_LENS, seed=2) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, n).astype(np.int32) for n in lens]


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
    """The tiers' layout on a mesh model (they once refused one, ROADMAP
    A.12): ``kv_leaf_shapes`` is whole-head, as a single rank's, and
    ``kv_head_ids`` is ``_head_layout``'s at mdl 2 (a kv head a rank) and
    mdl 4 (half a kv head a rank: two ranks hold each); the engines build
    over a layout-only mesh, and what is still refused names A.12b."""
    for shape, axes, want in (((2, 2), ("dp", "mdl"), [[0], [1]]),
                              ((4,), ("mdl",), [[0], [0], [1], [1]])):
        mesh = Mesh(np.arange(4).reshape(shape), axes, rank=0)
        m = Transformer(compute_dtype=torch.float32, mesh=mesh,
                        tp_axis="mdl", device="meta", **GQA)
        n = mesh.shape["mdl"]
        assert [m.kv_head_ids(i) for i in range(n)] == want
        assert [_head_layout(4, 2, 8, 32 // n, i)[2]
                for i in range(n)] == want
        assert m.local_kv_heads() == len(m.kv_head_ids()) == 1
        local = m.local_params(m.init_params(seed=0, device="cpu"))
        srv = BatchServer(m, local, slots=1, max_len=16, device="cpu")
        pe = PrefillEngine(m, local, max_len=16, device="cpu")
        assert srv.kv_leaf_shapes(3) == pe.kv_leaf_shapes(3) == [
            (3, 2, 8)] * 4
        with pytest.raises(ValueError, match="expected"):
            srv.submit_kv(np.arange(3), 2, [], np.zeros(64))
    router = Router(pe, kv_codec="f32")
    try:
        with pytest.raises(NotImplementedError, match="A.12b"):
            router.install_version(1, pe)
        with pytest.raises(NotImplementedError, match="A.12b"):
            WeightPublisher(router)
    finally:
        router.close()


@pytest.mark.parametrize("name", ["mdl2", "mdl4"])
def test_mesh_prefill_ships_jax_prefill_engines_whole_heads(name):
    """The mesh PrefillEngine's leader returns whole-head kv rows and the
    last logits of JAX's PrefillEngine on the same params, within 1e-5 of
    max(1, |ref|): at mdl 2 (both dp groups' leaders) and at mdl 4 (half a
    kv head a rank). Only the mdl axis ran collectives."""
    model, params, _, _, _ = _model("gqa")
    jpe = jax_serve.PrefillEngine(model, params, max_len=TIER["max_len"])
    want = [jpe.prefill(p) for p in _tier_prompts()]
    res = _ranks()
    leaders = [0, 2] if name == "mdl2" else [0]
    for rank, r in res.items():
        got = r[f"prefill-{name}"]
        assert isinstance(got, dict), got
        assert got["axes"] == ["mdl"], got["axes"]
        assert int(got["prefills"]) == len(TIER_LENS)
        if rank not in leaders:
            assert "kv0" not in got
            continue
        for i, (rows, last) in enumerate(want):
            ref = np.stack(rows)
            assert got[f"kv{i}"].shape == ref.shape == (4, TIER_LENS[i], 2, 8)
            assert got[f"shapes{i}"].tolist() == [list(x.shape) for x in rows]
            for a, b in ((got[f"kv{i}"], ref), (got[f"last{i}"], last)):
                np.testing.assert_allclose(
                    a, b, rtol=0, atol=1e-5 * max(1.0, np.abs(b).max()),
                    err_msg=f"rank {rank} prompt {i}")


def _held_near_argmax(tokens: dict, prefix: str):
    model, params, _, _, _ = _model("gqa")
    for i, (p, n) in enumerate(zip(_tier_prompts(), TIER_NEW)):
        toks = tokens[f"{prefix}{i}"]
        assert toks.shape == (n,)
        _near_argmax(model, params, np.concatenate([p, toks])[None], len(p),
                     f"request {i}")


def test_tp_tier_f32_wire_is_bitwise_the_mesh_server():
    """The dp-0 group prefills (the Router on its leader) and ships on the
    f32 wire to the dp-1 group, which decodes: its tokens are bitwise the
    mesh BatchServer's on the same ranks and requests, and near-argmax
    JAX's; the decode ranks finish the same tokens (one digest), adopt
    every block and never prefill; only the mdl axis ran collectives."""
    res = {k: r["tier-f32"] for k, r in _ranks().items()}
    for rank, r in res.items():
        assert isinstance(r, dict), f"rank {rank}: {r}"
        assert r["axes"] == ["mdl"], r["axes"]
    for i in range(len(TIER_LENS)):
        for rank in (2, 3):
            np.testing.assert_array_equal(res[0][f"tier{i}"],
                                          res[rank][f"ref{i}"],
                                          err_msg=f"request {i}")
    _held_near_argmax(res[0], "tier")
    assert [int(res[r]["prefills"]) for r in (0, 1)] == [4, 4]
    stats = [res[r]["decode_stats"] for r in (2, 3)]
    assert stats[0]["tokens_crc"] == stats[1]["tokens_crc"] != 0
    for st in stats:
        assert (st["blocks"], st["srv_kv_adopts"], st["srv_prefills"]) == (
            4, 4, 0)
    assert len(res[0]["ttft"]) == 4


@pytest.mark.parametrize("case", ["tier-mesh-single", "tier-single-mesh"])
def test_mixed_layout_tiers(case):
    """An mdl-2 prefill group into a single-rank decode tier, and a
    single-rank prefill tier into an mdl-4 decode group (two ranks a kv
    head; each installs its copy): the wire is the single-rank tier's
    either way, and the tokens are near-argmax JAX's."""
    res = {k: r[case] for k, r in _ranks().items()}
    for rank, r in res.items():
        assert isinstance(r, dict), f"rank {rank}: {r}"
    _held_near_argmax(res[0], "tier")
    if case == "tier-single-mesh":
        crcs = {res[r]["decode_stats"]["tokens_crc"] for r in range(4)}
        assert len(crcs) == 1 and crcs != {0}
        assert all(res[r]["decode_stats"]["srv_kv_adopts"] == 4
                   for r in range(4))
    else:
        assert [int(res[r]["prefills"]) for r in (0, 1)] == [4, 4]
        assert res[0]["decode_stats"]["srv_kv_adopts"] == 4


def test_tp_tier_int8_wire_ratio_by_counters():
    """The int8 wire through a TP pair: 8-token prompts give 8 x 2 layers
    x 2 leaves x 2 kv heads x 8 = 512 f32 elements a whole-head block, so
    the wire is exactly the single-rank tier's: (512 + 2*4) / 2048 of the
    f32 bytes, 3 x 520 int8 bytes sent; tokens in [0, vocab)."""
    r0 = _ranks()[0]["tier-int8"]
    assert isinstance(r0, dict), r0
    for i in range(3):
        toks = r0[f"tier{i}"]
        assert toks.shape == (6,)
        assert ((toks >= 0) & (toks < GQA["vocab"])).all()
    ratios = [v for k, v in r0["wire_ratio"]]
    assert len(ratios) == 1 and abs(ratios[0] - 0.25390625) < 1e-6
    assert int(r0["int8_tx"]) == 3 * (512 + 8)


def test_swap_into_a_mesh_decode_group_raises():
    """A SWAP_BEGIN into a decode group: its leader raises naming ROADMAP
    A.12b and releases its follower, which raises; the router reaps the
    rank."""
    res = {k: r["tier-swap"] for k, r in _ranks().items()}
    for rank, r in res.items():
        assert isinstance(r, dict), f"rank {rank}: {r}"
    assert res[2]["leader"].startswith("NotImplementedError")
    assert "A.12b" in res[2]["leader"]
    assert res[3]["follower"].startswith("ServeError")
    assert int(res[0]["rank_failures"]) == 1
