"""LoRA adapter utilities (the port of ``tpunet/models/lora.py``): masking,
base grafting, merging, on the port's flat state_dicts.

The model side is ``Transformer(lora_rank=r)``: every dense layer becomes a
``LoraDense`` whose base leaves sit under ``<layer>.base`` (``weight``, or
``q`` and ``scale`` under weight_quant="int8") with ``<layer>.lora_a`` (in,
r) and ``<layer>.lora_b`` (r, out) beside it.

  graft_base(adapted_init, base_params)  a trained base state_dict (fp, or
      ``quantize_params`` output) loaded into a fresh adapted one; the
      adapters keep their fresh init (B = 0, so the grafted model is
      bitwise the base model before training).
  lora_mask(params)                      {name: bool}, True exactly on the
      lora_a/lora_b leaves.
  lora_optimizer(tx, params)             the frozen-base optimizer: `tx`
      on the adapters and nothing on every other leaf (optax's
      multi_transform with set_to_zero), so embed, norms and the base stay
      bitwise frozen, with no weight decay either.
  merge_lora(params, alpha=None)         A·B·(alpha/r) folded into each fp
      base weight: a plain state_dict for ``Transformer(lora_rank=0)``.
      An int8 base is refused (it cannot absorb an fp delta losslessly;
      serve the adapted model, QLoRA's deployment mode).

The JAX package's ``lora_apply_updates`` exists only because optax's
gradients of integer leaves are float0, which ``optax.apply_updates``
cannot add. It has no counterpart here: the optimizer steps its tensors in
place, and an integer leaf takes no gradient (the trainer differentiates
the floating leaves only).
"""

from __future__ import annotations

import torch

_ADAPTERS = ("lora_a", "lora_b")


def _leaf(name: str) -> str:
    return name.rpartition(".")[2]


def lora_mask(params: dict) -> dict:
    """{name: True} exactly on the lora_a/lora_b leaves, False elsewhere."""
    return {k: _leaf(k) in _ADAPTERS for k in params}


class lora_optimizer:  # noqa: N801 — named after the JAX function
    """`tx` (an ``adamw``/``sgd`` factory of ``tpunet_torch.train``) on the
    adapters only: ``init(params)`` builds tx's optimizer over the
    lora_a/lora_b tensors of `params`. Every other leaf is in no parameter
    group, so a step leaves it bitwise as it was (no update, no weight
    decay), whatever gradient it holds. `params` names the trainable set,
    as the JAX function's labels do; ``init`` takes the state's params."""

    def __init__(self, tx, params: dict):
        self.tx = tx
        self.trainable = [k for k, m in lora_mask(params).items() if m]
        if not self.trainable:
            raise ValueError("lora_optimizer: the params hold no lora_a/"
                             "lora_b leaves (build the model with "
                             "lora_rank > 0)")

    def init(self, params: dict) -> torch.optim.Optimizer:
        missing = [k for k in self.trainable if k not in params]
        if missing:
            raise KeyError(f"lora_optimizer: params lack {missing[:3]}")
        return self.tx.init({k: params[k] for k in self.trainable})


def _base_name(name: str) -> str | None:
    """The plain model's name of an adapted model's base leaf
    (``x.base.weight`` -> ``x.weight``), or None for any other leaf."""
    module, _, leaf = name.rpartition(".")
    owner, _, last = module.rpartition(".")
    if last != "base":
        return None
    return f"{owner}.{leaf}" if owner else leaf


def graft_base(adapted_init: dict, base_params: dict) -> dict:
    """A fresh adapted state_dict with the base's weights: each adapted
    base leaf takes the base state_dict's leaf of the same path minus the
    ``.base`` nesting, every other non-adapter leaf (embed, norms) the
    base's leaf of the same name, and the adapters stay as initialised."""
    out, used = {}, set()
    for name, t in adapted_init.items():
        if _leaf(name) in _ADAPTERS:
            out[name] = t
            continue
        src = _base_name(name) or name
        if src not in base_params:
            raise ValueError(f"tree mismatch: the adapted leaf {name!r} has "
                             f"no base leaf {src!r}")
        b = base_params[src]
        if tuple(b.shape) != tuple(t.shape):
            raise ValueError(f"tree mismatch: {src!r} is {tuple(b.shape)}, "
                             f"the adapted {name!r} {tuple(t.shape)}")
        out[name] = b
        used.add(src)
    extra = sorted(set(base_params) - used)
    if extra:
        raise ValueError(f"tree mismatch: base leaves {extra[:3]} have no "
                         "place in the adapted model")
    return out


def merge_lora(params: dict, alpha: float | None = None) -> dict:
    """Adapted state_dict -> plain state_dict with A·B·(alpha/r) folded into
    each base weight (for the lora_rank=0 model), in f32 and cast back to
    the weight's dtype. The rank is read off each lora_a; pass the alpha
    the model was built with (None: alpha = rank, scale 1). fp bases
    only."""
    out = {}
    for name, t in params.items():
        module, _, leaf = name.rpartition(".")
        if leaf in _ADAPTERS:
            continue
        plain = _base_name(name)
        if plain is None:
            out[name] = t
            continue
        owner = module.rpartition(".")[0]
        pre = f"{owner}." if owner else ""
        if leaf != "weight":
            raise ValueError(
                "merge_lora requires an fp base (int8 bases can't absorb an "
                "fp delta losslessly) - serve the adapted model instead")
        a = params[pre + "lora_a"].detach().float()
        b = params[pre + "lora_b"].detach().float()
        rank = a.shape[1]
        scale = (alpha if alpha is not None else rank) / rank
        w = t.detach().float() + ((a @ b) * scale).t()
        out[plain] = w.to(t.dtype)
    return out
