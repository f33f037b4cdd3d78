"""The port's mesh tier (tpunet_torch/parallel/mesh.py and smap.py) against
the JAX package's, on the CPU.

In this process: the layout of ranks over named axes and every group of
ranks along a set of axes against the device array of JAX's mesh on the
virtual 8-device CPU mesh (the same shapes); ``transformer_partition_rules``
and ``vgg_partition_rules`` exactly JAX's tables; ``shard_params``' spec
and block of every leaf against JAX's ``shard_params`` NamedSharding of
the same flax leaf (the spec in flax's layout, the block by
``devices_indices_map``), for the Transformer (fp and int8) and the VGG,
with the fallback to replication where an axis does not divide a dim;
``make_named_mesh`` and ``make_mesh``'s refusals. Then one spawn of 4 port
ranks (tests/torch_mesh_ranks.py, torch only) runs every axis collective
on the meshes {dp: 2, sp: 2} and {pp: 4}, forward and backward, held
exactly to the transposes the module docstring of smap.py states, and
``hierarchical_psum`` over an axis (JAX's psum over that axis: the mesh
spans the world, one host).
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import pytest

from conftest import free_port  # noqa: F401  (pins JAX_PLATFORMS=cpu first)

import jax
import jax.numpy as jnp
import torch
from torch_mesh_ranks import spawn

from tpunet.models import VGG as JaxVGG
from tpunet.models import Transformer as JaxTransformer
from tpunet.models import transformer_partition_rules as jax_tp_rules
from tpunet.parallel import make_named_mesh as jax_make_named_mesh
from tpunet.parallel import shard_params as jax_shard_params
from tpunet.parallel import vgg_partition_rules as jax_vgg_rules
from tpunet_torch.models import VGG, Transformer, from_flax
from tpunet_torch.models.transformer import transformer_partition_rules
from tpunet_torch.parallel import (Mesh, P, batch_sharding, make_mesh,
                                   make_named_mesh, replicated, shard_params,
                                   vgg_partition_rules)
from tpunet_torch.parallel.mesh import _flax_order, flax_path

LAYOUTS = [{"dp": 2, "mdl": 2}, {"dp": 2, "sp": 2, "tp": 2}, {"pp": 4},
           {"dp": 4, "mdl": 2}, {"pp": 2, "dp": 2}]
COLLECTIVE_MESHES = [{"dp": 2, "sp": 2}, {"pp": 4}]


def _port_mesh(sizes: dict, rank: int) -> Mesh:
    n = int(np.prod(list(sizes.values())))
    return Mesh(np.arange(n).reshape(tuple(sizes.values())), tuple(sizes),
                rank)


def _ids(jmesh) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(jmesh.devices)


@pytest.mark.parametrize("sizes", LAYOUTS, ids=lambda s: "x".join(
    f"{k}{v}" for k, v in s.items()))
def test_layout_and_groups_match_jax(sizes):
    """The ranks' layout is JAX's device layout; every group along every
    set of axes is the devices of JAX's mesh that share the rank's other
    coordinates, in order; axis_index is the rank's coordinate."""
    jmesh = jax_make_named_mesh(sizes)
    ids = _ids(jmesh)
    names = tuple(sizes)
    for rank in range(ids.size):
        m = _port_mesh(sizes, rank)
        assert np.array_equal(m.devices, ids)
        assert m.shape == dict(jmesh.shape)
        where = tuple(int(c) for c in np.argwhere(ids == rank)[0])
        assert tuple(m.coords[a] for a in names) == where
        for k in range(1, len(names) + 1):
            for sub in itertools.combinations(names, k):
                idx = tuple(slice(None) if a in sub else where[i]
                            for i, a in enumerate(names))
                assert m.group(sub) == ids[idx].reshape(-1).tolist()
        for i, a in enumerate(names):
            assert m.axis_index(a) == where[i]
            assert m.axis_size(a) == sizes[a]


def test_partition_rule_tables_are_jax_tables():
    """Both tables, entry for entry (regex and spec), for every axis
    choice JAX's callers use."""
    for tp, ep in ((None, None), ("mdl", None), (None, "ep"), ("mdl", "ep"),
                   ("tp", "dp")):
        got = transformer_partition_rules(tp_axis=tp, ep_axis=ep)
        want = jax_tp_rules(tp_axis=tp, ep_axis=ep)
        assert [(r, tuple(s)) for r, s in got] == [
            (r, tuple(s)) for r, s in want]
    assert [(r, tuple(s)) for r, s in vgg_partition_rules()] == [
        (r, tuple(s)) for r, s in jax_vgg_rules()]
    assert batch_sharding(None) == P("dp") and replicated(None) == P()


@functools.lru_cache(maxsize=None)
def _transformer_trees(name: str):
    cfg = {"fp": dict(vocab=64, d_model=32, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=64, mlp_impl="swiglu"),
           # vocab 66 and d_ff 70 divide by no axis of 4: embed, lm_head,
           # up, gate and down fall back to replicated.
           "fallback": dict(vocab=66, d_model=32, n_layers=1, n_heads=4,
                            d_ff=70),
           "int8": dict(vocab=64, d_model=32, n_layers=1, n_heads=4,
                        d_ff=64, weight_quant="int8")}[name]
    jm = JaxTransformer(compute_dtype=jnp.float32, **cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    tm = Transformer(compute_dtype=torch.float32, device="cpu", **cfg)
    return params, from_flax(jax.tree.map(np.asarray, params), tm)


@functools.lru_cache(maxsize=None)
def _vgg_trees(classes: int):
    kw = dict(cfg=(8, "M", 16, "M"), num_classes=classes, hidden=32)
    jm = JaxVGG(compute_dtype=jnp.float32, **kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 8, 8, 3)))["params"]
    vm = VGG(compute_dtype=torch.float32, image_size=8, device="cpu", **kw)
    return params, from_flax(jax.tree.map(np.asarray, params), vm)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("model,sizes,rules", [
    ("fp", {"dp": 2, "mdl": 2}, "tp"),
    ("fp", {"dp": 2, "sp": 2, "tp": 2}, "tp_named"),
    ("fallback", {"dp": 2, "mdl": 4}, "tp"),
    ("int8", {"dp": 4, "mdl": 2}, "tp"),
    ("vgg10", {"dp": 2, "mdl": 4}, "vgg"),
    ("vgg12", {"dp": 2, "mdl": 4}, "vgg"),
])
def test_shard_params_matches_jax(model, sizes, rules):
    """Every leaf's spec (turned back to flax's layout) is the spec of
    JAX's NamedSharding for its flax path, and every rank's block is the
    block JAX's sharding maps to that device (in the port's layout)."""
    if model.startswith("vgg"):
        flax_params, sd = _vgg_trees(int(model[3:]))
    else:
        flax_params, sd = _transformer_trees(model)
    rule_set = {"tp": transformer_partition_rules("mdl"),
                "tp_named": transformer_partition_rules("tp"),
                "vgg": vgg_partition_rules()}[rules]
    jax_rules = {"tp": jax_tp_rules("mdl"), "tp_named": jax_tp_rules("tp"),
                 "vgg": jax_vgg_rules()}[rules]
    jmesh = jax_make_named_mesh(sizes)
    shardings = dict(_flat(jax_shard_params(flax_params, jmesh, jax_rules)))
    flax_leaves = dict(_flat(flax_params))
    replicated_seen = sharded_seen = 0
    for rank in range(jmesh.size):
        m = _port_mesh(sizes, rank)
        specs, local = shard_params(sd, m, rule_set)
        device = jmesh.devices.reshape(-1)[rank]
        for name, t in sd.items():
            path = flax_path(name)
            want = tuple(shardings[path].spec)
            order = _flax_order(name, t.dim())
            got = [specs[name][d] if d < len(specs[name]) else None
                   for d in order]
            assert tuple(got) + (None,) * (len(want) - len(got)) == \
                want + (None,) * (len(got) - len(want)), (rank, path)
            leaf = np.asarray(flax_leaves[path])
            block = leaf[shardings[path].devices_indices_map(
                leaf.shape)[device]]
            assert np.array_equal(np.transpose(local[name].numpy(), order),
                                  block), (rank, path)
            if any(a is not None for a in want):
                sharded_seen += 1
            else:
                replicated_seen += 1
    assert sharded_seen and replicated_seen


def test_mesh_refusals():
    """A mesh of more ranks than one needs an initialized world; a world
    of another size than the mesh, unknown axes and a tuple that repeats
    an axis raise; a layout-only mesh refuses collectives."""
    with pytest.raises(RuntimeError, match="initialize"):
        make_named_mesh({"dp": 2})
    one = make_named_mesh({"dp": 1, "sp": 1})
    assert one.comm("dp") is None and one.axis_index(("dp", "sp")) == 0
    assert make_mesh().shape == {"dp": 1, "mdl": 1}
    with pytest.raises(ValueError, match="mdl"):
        make_mesh(dp=2, mdl=1)
    m = _port_mesh({"dp": 2, "sp": 2}, 3)
    with pytest.raises(ValueError, match="unknown mesh axes"):
        m.axis_size("tp")
    with pytest.raises(ValueError, match="repeated"):
        m.canonical(("dp", "dp"))
    with pytest.raises(RuntimeError, match="layout only"):
        m.comm("dp")
    with pytest.raises(ValueError, match="not one device"):
        _port_mesh({"dp": 2}, 5)


# -- on spawned port ranks ----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ranks() -> dict:
    cases = {f"collectives-{i}": ("collectives", {"axes": tuple(s.items())})
             for i, s in enumerate(COLLECTIVE_MESHES)}
    return spawn(4, cases)


def _expected(sizes: dict, ax: str) -> dict:
    """What every rank's collectives give on x_r = arange(2w) + 10 r, by
    the transposes of smap.py's docstring; (world, ...) arrays."""
    n = int(np.prod(list(sizes.values())))
    w = sizes[ax]
    x = {r: (np.arange(2 * w, dtype=np.float32) + 10 * r).reshape(w, 2)
         for r in range(n)}
    out: dict = {}

    def put(name, r, v):
        out.setdefault(name, [None] * n)[r] = np.asarray(v, np.float32)

    for r in range(n):
        m = _port_mesh(sizes, r)
        grp = m.group(ax)
        i = grp.index(r)
        put("psum", r, sum(x[g] for g in grp))
        put("psum_grad", r, (1 + np.arange(2 * w)).reshape(w, 2))
        put("pvary", r, x[r])
        put("pvary_grad", r, np.full((w, 2), sum(g + 1 for g in grp)))
        put("ppermute", r, x[grp[(i - 1) % w]])
        put("ppermute_grad", r, np.full((w, 2), grp[(i + 1) % w] + 1))
        put("ppermute_back", r, x[grp[(i + 1) % w]])
        put("ppermute_back_grad", r, np.full((w, 2), grp[(i - 1) % w] + 1))
        put("all_to_all", r, np.concatenate([x[g][i:i + 1] for g in grp], 1))
        put("all_to_all_grad", r, np.repeat(
            np.array([[g + 1.0] for g in grp], np.float32), 2, axis=1))
        wts = (1 + np.arange(w * 2 * w)).reshape(w, 2 * w)
        put("all_gather", r, np.concatenate([x[g] for g in grp], 1))
        put("all_gather_grad", r, wts[:, 2 * i:2 * i + 2])
        put("axis_index", r, [i])
        put("hierarchical_psum", r, [w, sum(grp)])
    return {k: np.stack(v) for k, v in out.items()}


@pytest.mark.parametrize("mesh_i,ax", [
    (i, ax) for i, s in enumerate(COLLECTIVE_MESHES) for ax in s])
def test_axis_collectives_and_their_transposes(mesh_i, ax):
    """psum (identity backward), pvary (all-reduce backward), ppermute
    forward and back (inverse permutation), all_to_all (inverse
    all-to-all), all_gather (the rank's slice, no communication),
    axis_index and hierarchical_psum, on every rank, exactly."""
    sizes = COLLECTIVE_MESHES[mesh_i]
    want = _expected(sizes, ax)
    for rank, res in _ranks().items():
        got = res[f"collectives-{mesh_i}"]
        assert isinstance(got, dict), got
        for name, w in want.items():
            np.testing.assert_array_equal(got[f"{name}:{ax}"], w,
                                          err_msg=f"{name} rank {rank}")
