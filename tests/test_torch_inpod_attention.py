"""The port's in-pod sequence parallelism (ring_self_attention,
zigzag_self_attention, ulysses_self_attention over a mesh axis, and the
Transformer's "zigzag" impl) against the JAX package's on the same inputs,
case for case with tests/test_ring_attention.py, test_zigzag_attention.py
and test_ulysses.py.

JAX runs each function on its virtual 8-device CPU mesh; the port runs it
in ONE spawn of 4 ranks (tests/torch_mesh_ranks.py), a mesh device being a
rank, on each rank's block of the same global q/k/v, and the blocks are
gathered back. The meshes are JAX's, cut to 4 ranks: {dp: 2, sp: 2} for
JAX's {dp: 2, sp: 4}, {sp: 2, tp: 2} (dp_axis None) for {dp: 2, sp: 2, tp:
2}, {sp: 4} for {sp: 8}; where JAX's mesh has fewer devices, a leading
"rep" axis holds replicas. Outputs within 2e-5 of JAX's (bf16: 3e-2),
gradients of sum(out ** 2) within 5e-5 (the files' own tolerances), the
zigzag Transformer's logits within 3e-5; and the refusals: an odd zigzag
shard and heads not divisible by the sp axis.
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
from tpunet.parallel import make_named_mesh as jax_mesh
from tpunet.parallel import ring_self_attention as jax_ring
from tpunet.parallel import ulysses_self_attention as jax_ulysses
from tpunet.parallel import zigzag_self_attention as jax_zigzag
from tpunet.parallel.zigzag_attention import from_zigzag, to_zigzag
from tpunet_torch.models import Transformer, from_flax

TOL, GRAD_TOL, BF16_TOL, MODEL_TOL = 2e-5, 5e-5, 3e-2, 3e-5
ZZ_MODEL = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64)


def _qkv(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32)
                 for _ in range(3))


# name -> (kind, port mesh, JAX mesh, qkv, options); options: causal,
# dp_axis, tp_axis, grad, dtype.
CASES = {
    "ring-full-False": ("ring", {"dp": 2, "sp": 2}, {"dp": 2, "sp": 2},
                        (0, 4, 32, 2, 8), dict(causal=False, dp_axis="dp")),
    "ring-full-True": ("ring", {"dp": 2, "sp": 2}, {"dp": 2, "sp": 2},
                       (0, 4, 32, 2, 8), dict(causal=True, dp_axis="dp")),
    "ring-tp-heads": ("ring", {"sp": 2, "tp": 2}, {"sp": 2, "tp": 2},
                      (1, 2, 16, 4, 8), dict(causal=True, tp_axis="tp")),
    "ring-sp-only": ("ring", {"sp": 4}, {"sp": 4}, (2, 1, 64, 2, 16),
                     dict(causal=True)),
    "ring-grad-False": ("ring", {"dp": 2, "sp": 2}, {"dp": 2, "sp": 2},
                        (3, 2, 32, 2, 8),
                        dict(causal=False, dp_axis="dp", grad=True)),
    "ring-grad-True": ("ring", {"dp": 2, "sp": 2}, {"dp": 2, "sp": 2},
                       (3, 2, 32, 2, 8),
                       dict(causal=True, dp_axis="dp", grad=True)),
    "ring-bf16": ("ring", {"sp": 4}, {"sp": 4}, (4, 1, 32, 2, 8),
                  dict(causal=True, dtype="bfloat16")),
    "zigzag-w1": ("zigzag", {"rep": 4, "sp": 1}, {"sp": 1},
                  (5, 2, 16, 4, 8), {}),
    "zigzag-w2": ("zigzag", {"rep": 2, "sp": 2}, {"sp": 2},
                  (5, 2, 32, 4, 8), {}),
    "zigzag-w4": ("zigzag", {"sp": 4}, {"sp": 4}, (5, 2, 64, 4, 8), {}),
    "zigzag-grad": ("zigzag", {"sp": 4}, {"sp": 4}, (6, 2, 32, 4, 8),
                    dict(grad=True)),
    "zigzag-dp": ("zigzag", {"dp": 2, "sp": 2}, {"dp": 2, "sp": 2},
                  (9, 2, 32, 4, 8), dict(dp_axis="dp")),
    "ulysses-full-False": ("ulysses", {"dp": 2, "sp": 2}, {"dp": 2, "sp": 2},
                           (0, 4, 32, 4, 8), dict(causal=False, dp_axis="dp")),
    "ulysses-full-True": ("ulysses", {"dp": 2, "sp": 2}, {"dp": 2, "sp": 2},
                          (0, 4, 32, 4, 8), dict(causal=True, dp_axis="dp")),
    "ulysses-tp-heads": ("ulysses", {"sp": 2, "tp": 2}, {"sp": 2, "tp": 2},
                         (1, 2, 16, 4, 8), dict(causal=True, tp_axis="tp")),
    "ulysses-grad": ("ulysses", {"sp": 4}, {"sp": 4}, (3, 2, 32, 4, 8),
                     dict(causal=True, grad=True)),
}
REFUSALS = {
    # (case, the exception the ranks must raise, its message)
    "zigzag-odd-shard": (("attention", dict(
        kind="zigzag", axes=(("rep", 2), ("sp", 2)), qkv=_qkv(1, 2, 6, 4, 8),
        permute=False)), "ValueError", "even"),
    "ulysses-heads": (("attention", dict(
        kind="ulysses", axes=(("sp", 4),), qkv=_qkv(4, 1, 32, 2, 8))),
        "ValueError", "divisible"),
}


@functools.lru_cache(maxsize=None)
def _zz_model():
    """(port params, tokens, JAX zigzag model's logits in natural order)
    of tests/test_zigzag_attention.py's Transformer case."""
    w, seq = 4, 32
    ref = JaxTransformer(attn_impl="reference", compute_dtype=jnp.float32,
                         **ZZ_MODEL)
    zz = JaxTransformer(attn_impl="zigzag", mesh=jax_mesh({"sp": w}),
                        sp_axis="sp", dp_axis=None,
                        compute_dtype=jnp.float32, **ZZ_MODEL)
    toks = np.random.default_rng(7).integers(0, 64, (2, seq)).astype(
        np.int32)
    params = jax.jit(ref.init)(jax.random.PRNGKey(0), toks)["params"]
    got = zz.apply({"params": params}, to_zigzag(jnp.asarray(toks), w))
    tm = Transformer(compute_dtype=torch.float32, device="cpu", **ZZ_MODEL)
    sd = from_flax(jax.tree.map(np.asarray, params), tm)
    return ({n: t.numpy() for n, t in sd.items()}, toks,
            np.asarray(from_zigzag(got, w)))


def _case_kwargs(name):
    kind, port_mesh, _, qkv, opts = CASES[name]
    kw = dict(kind=kind, axes=tuple(port_mesh.items()), qkv=_qkv(*qkv))
    kw.update({k: v for k, v in opts.items() if k != "dp_axis"})
    kw["dp_axis"] = opts.get("dp_axis")
    return ("attention", kw)


@functools.lru_cache(maxsize=None)
def _ranks() -> dict:
    cases = {name: _case_kwargs(name) for name in CASES}
    params, toks, _ = _zz_model()
    cases["zigzag-model"] = ("model", dict(
        axes=(("sp", 4),), impl="zigzag", cfg=ZZ_MODEL, params=params,
        tokens=toks, dp_axis=None))
    cases.update({k: v[0] for k, v in REFUSALS.items()})
    return spawn(4, cases)


@functools.lru_cache(maxsize=None)
def _jax(name: str) -> dict:
    """JAX's function on its mesh: output (natural order) and, for the
    grad cases, the gradients of sum(out ** 2)."""
    kind, _, mesh_sizes, qkv, opts = CASES[name]
    mesh = jax_mesh(mesh_sizes)
    causal = opts.get("causal", True)
    dt = jnp.bfloat16 if opts.get("dtype") == "bfloat16" else jnp.float32
    w = mesh_sizes["sp"]
    axes = dict(dp_axis=opts.get("dp_axis"), sp_axis="sp",
                tp_axis=opts.get("tp_axis"))

    def fn(q, k, v):
        if kind == "zigzag":
            out = jax_zigzag(*(to_zigzag(x, w) for x in (q, k, v)), mesh,
                             **axes)
            return from_zigzag(out, w)
        f = jax_ring if kind == "ring" else jax_ulysses
        return f(q, k, v, mesh, causal=causal, **axes)

    args = [jnp.asarray(a, dt) for a in _qkv(*qkv)]
    res = {"out": np.asarray(jax.jit(fn)(*args), np.float32)}
    if opts.get("grad"):
        grads = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) ** 2),
                                 argnums=(0, 1, 2)))(*args)
        res.update(dq=np.asarray(grads[0]), dk=np.asarray(grads[1]),
                   dv=np.asarray(grads[2]))
    return res


@pytest.mark.parametrize("name", list(CASES))
def test_inpod_attention_matches_jax(name):
    """Every rank's gathered output (and gradients) against JAX's function
    on the same global inputs."""
    want = _jax(name)
    opts = CASES[name][4]
    tol = BF16_TOL if opts.get("dtype") == "bfloat16" else TOL
    for rank, res in _ranks().items():
        got = res[name]
        assert isinstance(got, dict), got
        assert set(got) == set(want)
        for key, w in want.items():
            np.testing.assert_allclose(
                got[key], w, rtol=tol if key == "out" else GRAD_TOL,
                atol=tol if key == "out" else GRAD_TOL,
                err_msg=f"{key} rank {rank}")


def test_zigzag_transformer_matches_jax():
    """The Transformer with attn_impl="zigzag" over {sp: 4}, each rank fed
    its zigzag chunk pair of the tokens, against JAX's zigzag model on the
    whole zigzag-ordered sequence (flax params carried by from_flax)."""
    want = _zz_model()[2]
    for rank, res in _ranks().items():
        got = res["zigzag-model"]
        assert isinstance(got, dict), got
        np.testing.assert_allclose(got["logits"], want, rtol=MODEL_TOL,
                                   atol=MODEL_TOL, err_msg=f"rank {rank}")


@pytest.mark.parametrize("name", list(REFUSALS))
def test_inpod_refusals(name):
    _, exc, msg = REFUSALS[name]
    for rank, res in _ranks().items():
        got = res[name]
        assert isinstance(got, str) and got.startswith(f"raised {exc}"), got
        assert msg in got, got
