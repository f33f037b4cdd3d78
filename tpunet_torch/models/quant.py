"""Post-training weight-only int8 quantization for the Transformer family
(port of ``tpunet/models/quant.py``).

`quantize_params(state_dict)` converts a trained fp state_dict into the one
a ``Transformer(weight_quant="int8")`` consumes: every dense layer's
``<module>.weight`` (out, in) becomes ``<module>.q`` (int8, (out, in)) and
``<module>.scale`` (f32, (out,)), with symmetric per-output-channel absmax
scaling (w ≈ q · scale, q in [-127, 127]). Everything that is not a dense
kernel (the embedding table, RMSNorm scales, layers with a bias, convs)
passes through untouched; module names are identical, so the swap is
purely at the leaf level.

The arithmetic is the JAX package's (f32 absmax, ``max(absmax, 1e-8) /
127``, round half to even, clip), elementwise IEEE f32 on whatever device
the weight lives on, so `q` and `scale` are bitwise JAX's for the same fp
weights (its (in, out) kernel is the transpose of the weight here).

Weight-only: decode streams every weight matrix once per token, so int8
halves the bytes a bf16 step reads; the per-column scale commutes with the
matmul, x @ (q·scale)ᵀ == (x @ qᵀ) · scale, which is how ``QuantDense``
applies it. MoE expert weights are not covered: ``Transformer`` rejects
``weight_quant`` with ``n_experts > 0``.
"""

from __future__ import annotations

import torch


def quantize_kernel(w) -> dict:
    """One (out, in) fp weight -> {"q": int8 (out, in), "scale": f32
    (out,)}, on the weight's device."""
    w = torch.as_tensor(w).detach().float()
    if w.dim() != 2:
        raise ValueError(f"expected a 2-D kernel, got shape {tuple(w.shape)}")
    absmax = w.abs().amax(dim=1)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(
        torch.int8)
    return {"q": q, "scale": scale}


def quantize_params(params: dict) -> dict:
    """fp state_dict -> the weight_quant="int8" state_dict (same module
    paths, same order).

    A dense layer is recognised structurally, as the JAX package does: a
    module whose ONLY parameter is a 2-D ``weight`` (this family's dense
    layers are all bias-free). Anything else passes through unchanged."""
    leaves: dict[str, list[str]] = {}
    for name in params:
        module, _, leaf = name.rpartition(".")
        leaves.setdefault(module, []).append(leaf)
    out = {}
    for name, t in params.items():
        module, _, leaf = name.rpartition(".")
        if (module and leaves[module] == ["weight"]
                and getattr(t, "dim", lambda: 0)() == 2):
            qd = quantize_kernel(t)
            out[module + ".q"] = qd["q"]
            out[module + ".scale"] = qd["scale"]
        else:
            out[name] = t
    return out


def dequantize_kernel(qdict) -> torch.Tensor:
    """The fp reconstruction q · scale, (out, in) f32: what QuantDense's
    matmul sees; round-trip error is at most scale/2 per element."""
    return qdict["q"].float() * qdict["scale"][:, None]
