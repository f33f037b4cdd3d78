"""The port's int8 weights (tpunet_torch/models/quant.py, QuantDense,
Transformer(weight_quant="int8"), the int8 leaves of from_flax/to_flax)
against the JAX package's, on the CPU: q and scale bitwise, the
dequantized kernel bitwise, the int8 model's logits within 1e-5 of the
flax int8 model's."""

from __future__ import annotations

import functools

import numpy as np
import pytest

from conftest import free_port  # noqa: F401  (pins JAX_PLATFORMS=cpu first)

import jax
import jax.numpy as jnp
import torch

from tpunet.models import Transformer as JaxTransformer
from tpunet.models import dequantize_kernel as jax_dequantize
from tpunet.models import quantize_params as jax_quantize
from tpunet_torch.models import (QuantDense, Transformer, dequantize_kernel,
                                 from_flax, init_params, quantize_params,
                                 to_flax)
from tpunet_torch.models.quant import quantize_kernel

CFG = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread is ~10x quicker than a pool
    (restored after the module, so other files keep their setting)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _flax(mlp_impl, seed):
    jm = JaxTransformer(compute_dtype=jnp.float32, mlp_impl=mlp_impl, **CFG)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    return jm, jax.tree.map(np.asarray, params)


def _port(mlp_impl, **kw):
    return Transformer(compute_dtype=torch.float32, mlp_impl=mlp_impl,
                       device="cpu", **CFG, **kw)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("mlp_impl,seed", [("gelu", 1), ("swiglu", 2)])
def test_quantize_params_bitwise_jax(mlp_impl, seed):
    """q and scale bitwise the JAX package's for the same fp weights; every
    other leaf passes through untouched, in both packages."""
    _, tree = _flax(mlp_impl, seed)
    want = dict(_flat(jax_quantize(tree)))
    sd = from_flax(tree, _port(mlp_impl))
    got = quantize_params(sd)
    back = dict(_flat(to_flax(got)))
    assert sorted(back) == sorted(want)
    for path, arr in want.items():
        assert back[path].dtype == arr.dtype, path
        np.testing.assert_array_equal(back[path], arr, err_msg=path)
    assert got["block0.attn.q.q"].dtype == torch.int8
    assert got["block0.attn.q.q"].shape == (32, 32)  # (out, in)
    assert int(got["block0.attn.q.q"].abs().max()) == 127
    assert got["embed"] is sd["embed"]
    assert got["block1.norm2.scale"] is sd["block1.norm2.scale"]


def test_dequantize_kernel_bitwise_jax_and_half_a_step():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((48, 24)).astype(np.float32)  # flax (in, out)
    w[:, 5] = 0.0  # an all-zero column keeps the 1e-8 floor
    jq = jax_quantize({"d": {"kernel": w}})["d"]
    got = quantize_kernel(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(got["q"].numpy().T, np.asarray(jq["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(jq["scale"]))
    deq = dequantize_kernel(got).numpy()
    np.testing.assert_array_equal(deq.T, np.asarray(jax_dequantize(jq)))
    err = np.abs(deq.T - w)
    assert (err <= got["scale"].numpy()[None, :] / 2 + 1e-7).all()
    with pytest.raises(ValueError, match="2-D"):
        quantize_kernel(torch.zeros(3))


@pytest.mark.parametrize("mlp_impl,attn_impl", [("gelu", "reference"),
                                                ("swiglu", "flash")])
def test_int8_logits_match_flax(mlp_impl, attn_impl):
    """The int8 model's logits within 1e-5 of the flax int8 model's, its
    int8 leaves carried across by from_flax; to_flax gives them back
    bitwise (the attention's Dense `q` holds a leaf `q`)."""
    jm, tree = _flax(mlp_impl, 1)
    jq = jm.clone(weight_quant="int8", attn_impl=attn_impl)
    qtree = jax.tree.map(np.asarray, jax_quantize(tree))
    tokens = np.random.default_rng(4).integers(0, 64, (2, 16)).astype(
        np.int32)
    want = np.asarray(jax.jit(jq.apply)({"params": qtree},
                                        jnp.asarray(tokens)))
    tq = _port(mlp_impl, weight_quant="int8", attn_impl=attn_impl)
    sd = from_flax(qtree, tq)
    assert sd["block0.attn.q.q"].dtype == torch.int8
    with torch.no_grad():
        got = tq.bind(sd)(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    for path, arr in _flat(to_flax(sd)):
        ref = dict(_flat(qtree))[path]
        assert arr.dtype == ref.dtype
        np.testing.assert_array_equal(arr, ref, err_msg=path)
    # bf16 pre-cast leaves q int8 and every scale f32.
    sd16 = from_flax(qtree, tq, dtype=torch.bfloat16)
    assert sd16["block1.mlp.down.q"].dtype == torch.int8
    assert sd16["block1.mlp.down.scale"].dtype == torch.float32
    assert sd16["embed"].dtype == torch.bfloat16


def test_quant_model_options_and_gradients():
    """weight_quant is validated; MoE and features_only refuse it loudly;
    a fresh int8 init is the zero skeleton; bind(trainable=True) keeps the
    int8 leaves frozen and trains the rest without an autograd error."""
    with pytest.raises(ValueError, match="weight_quant"):
        _port("gelu", weight_quant="int4")
    with pytest.raises(ValueError, match="MoE"):
        _port("gelu", weight_quant="int8", n_experts=4)
    tq = Transformer(compute_dtype=torch.float32, device="meta",
                     weight_quant="int8", **CFG)
    assert isinstance(tq.block0.attn.q, QuantDense)
    assert tq.config()["weight_quant"] == "int8"
    sd = init_params(tq, seed=0, device="cpu")
    assert sd["lm_head.q"].dtype == torch.int8 and not sd["lm_head.q"].any()
    assert torch.equal(sd["lm_head.scale"], torch.ones(64))
    qsd = quantize_params(init_params(_port("gelu").clone(), seed=0,
                                      device="cpu"))
    params = {k: (torch.nn.Parameter(v) if v.is_floating_point() else v)
              for k, v in qsd.items()}
    net = tq.bind(params, trainable=True)
    assert not net.block0.attn.q.q.requires_grad
    assert net.block0.attn.q.scale.requires_grad
    tokens = torch.from_numpy(np.arange(16).reshape(2, 8) % 64)
    net(tokens).float().square().mean().backward()
    assert params["block0.attn.q.scale"].grad is not None
    assert net.block0.attn.q.q.grad is None
    with pytest.raises(ValueError, match="features_only"):
        tq.bind(qsd)(tokens, features_only=True)


def test_quantize_params_passes_layers_with_bias_and_convs():
    """Only bias-free 2-D dense layers are quantized (JAX's structural
    rule): a VGG state_dict, whose dense layers carry a bias and whose
    convs are 4-D, passes through unchanged."""
    from tpunet_torch.models import VGG

    meta = VGG(cfg=(8, "M"), num_classes=4, hidden=8, image_size=8,
               compute_dtype=torch.float32, device="meta")
    sd = meta.init_params(seed=0, device="cpu")
    out = quantize_params(sd)
    assert list(out) == list(sd)
    assert all(out[k] is sd[k] for k in sd)
