"""The port's GPipe schedule (tpunet_torch/parallel/pipeline.py) against
the JAX package's ``gpipe`` on the same stacked params and inputs, case for
case with tests/test_pipeline.py.

JAX runs gpipe on its virtual CPU mesh; the port runs it in ONE spawn of 4
ranks (tests/torch_mesh_ranks.py), each a stage (or a data-parallel or
replica rank), on its block: its stage's slice of the stacked params and
its rows of each microbatch. JAX's meshes are cut to 4 ranks ({pp: 4, dp:
2} becomes {pp: 2, dp: 2}; pp 8 becomes pp 1 beside 4 replicas); outputs
within 1e-5 of JAX's and gradients of sum(out ** 2) within 1e-4 (the
file's tolerances), with and without ``dp_axis`` and ``remat_stages``;
``stack_stage_params`` equals JAX's; the shape refusals raise JAX's
ValueErrors.
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

from tpunet.parallel import gpipe as jax_gpipe
from tpunet.parallel import make_named_mesh as jax_mesh
from tpunet.parallel import stack_stage_params as jax_stack
from tpunet_torch.parallel import Mesh, gpipe, stack_stage_params

D, FF = 16, 32
TOL, GRAD_TOL = 1e-5, 1e-4


def _jax_stage_fn(params, x):
    """tests/test_pipeline.py's residual MLP block (tanh gelu)."""
    h = jax.nn.gelu(x @ params["w1"])
    return x + h @ params["w2"]


def _stages(n: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [{"w1": (rng.standard_normal((D, FF)) * 0.1).astype(np.float32),
             "w2": (rng.standard_normal((FF, D)) * 0.1).astype(np.float32)}
            for _ in range(n)]


def _stacked(n: int) -> dict:
    return {k: np.stack([s[k] for s in _stages(n)]) for k in ("w1", "w2")}


def _x(seed: int, rows: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((rows, D)).astype(
        np.float32)


# name -> (port mesh, JAX mesh, stages, rows, microbatches, dp_axis, remat,
# grad)
CASES = {
    "seq-pp4-m4": ({"pp": 4}, {"pp": 4}, 4, 16, 4, None, False, False),
    "seq-pp4-m8": ({"pp": 4}, {"pp": 4}, 4, 16, 8, None, False, False),
    "seq-pp2-m4": ({"pp": 2, "rep": 2}, {"pp": 2}, 2, 16, 4, None, False,
                   False),
    "seq-pp1-m4": ({"pp": 1, "rep": 4}, {"pp": 1}, 1, 16, 4, None, False,
                   False),
    "grad-remat-False": ({"pp": 4}, {"pp": 4}, 4, 8, 4, None, False, True),
    "grad-remat-True": ({"pp": 4}, {"pp": 4}, 4, 8, 4, None, True, True),
    "pp-x-dp-replicated": ({"pp": 2, "dp": 2}, {"pp": 2, "dp": 2}, 2, 8, 4,
                           None, False, False),
    "dp-axis": ({"pp": 2, "dp": 2}, {"pp": 2, "dp": 2}, 2, 8, 4, "dp",
                False, True),
}


@functools.lru_cache(maxsize=None)
def _ranks() -> dict:
    cases = {}
    for i, (name, (pm, _, n, rows, m, dp, remat, grad)) in enumerate(
            CASES.items()):
        cases[name] = ("gpipe", dict(
            axes=tuple(pm.items()), stacked=_stacked(n), x=_x(i, rows),
            microbatches=m, dp_axis=dp, remat=remat, grad=grad))
    return spawn(4, cases)


@functools.lru_cache(maxsize=None)
def _jax(name: str) -> dict:
    i = list(CASES).index(name)
    _, jm, n, rows, m, dp, remat, grad = CASES[name]
    mesh = jax_mesh(jm)
    stacked = {k: jnp.asarray(v) for k, v in _stacked(n).items()}
    x = jnp.asarray(_x(i, rows))

    def fn(p, x):
        return jax_gpipe(_jax_stage_fn, p, x, mesh, num_microbatches=m,
                         dp_axis=dp, remat_stages=remat)

    res = {"out": np.asarray(jax.jit(fn)(stacked, x))}
    if grad:
        gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(fn(p, x) ** 2),
                                  argnums=(0, 1)))(stacked, x)
        res.update({f"d{k}": np.asarray(v) for k, v in gp.items()})
        res["dx"] = np.asarray(gx)
    return res


@pytest.mark.parametrize("name", list(CASES))
def test_gpipe_matches_jax(name):
    """Every rank's gathered output (replicated over the stages) and, for
    the gradient cases, the gradients of the stacked params and of x."""
    want = _jax(name)
    for rank, res in _ranks().items():
        got = res[name]
        assert isinstance(got, dict), got
        assert set(got) == set(want)
        for key, w in want.items():
            tol = TOL if key == "out" else GRAD_TOL
            np.testing.assert_allclose(got[key], w, rtol=tol, atol=tol,
                                       err_msg=f"{key} rank {rank}")


def test_stack_and_shape_refusals():
    """stack_stage_params is JAX's stack; a stage block whose leading dim
    is not 1 (this stage's slice) and a batch the microbatches do not
    divide raise JAX's ValueErrors, before any collective."""
    stages = _stages(3)
    got = stack_stage_params([{k: torch.from_numpy(v) for k, v in s.items()}
                              for s in stages])
    want = jax_stack([{k: jnp.asarray(v) for k, v in s.items()}
                      for s in stages])
    for k in ("w1", "w2"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    mesh = Mesh(np.arange(4), ("pp",), rank=0)
    x = torch.zeros(8, D)
    with pytest.raises(ValueError, match="pp axis size"):
        gpipe(None, got, x, mesh, num_microbatches=4)
    ok = {k: v[:1] for k, v in got.items()}
    with pytest.raises(ValueError, match="not divisible"):
        gpipe(None, ok, x, mesh, num_microbatches=3)
