"""Prefill tier: prompt ingestion -> shippable KV blocks.

The prefill rank runs exactly the computation the single-host BatchServer's
refill runs for one request: the same ``_prefill`` on the same (1, p) row of
a per-row cache of capacity max_len. The extracted K/V prefix and
final-position logits are therefore bitwise what a local refill produces;
shipped over the exact (f32) wire and adopted into a decode slot, the
greedy token stream cannot be told apart from single-host serving.
"""

from __future__ import annotations

import numpy as np
import torch

from tpunet_torch import _device
from tpunet_torch.models.generate import (_kv_leaves, _prefill,
                                          _set_cache_index, init_cache)
from tpunet_torch.models.serve import refuse_mesh


class PrefillEngine:
    """One-slot prompt-ingestion engine for the frontend tier. Requires a
    dense model with no window (a full-capacity, per-row cache)."""

    def __init__(self, model, params, *, max_len: int,
                 prefill_chunk: int | None = None, device=None):
        refuse_mesh(model, "PrefillEngine")
        if getattr(model, "n_experts", 0):
            raise ValueError("PrefillEngine requires a dense model")
        if model.attn_window is not None:
            raise ValueError(
                "PrefillEngine requires a full-capacity cache: windowed "
                "models do not keep the shipped-prefix layout")
        self.device = _device.resolve(device)
        self.model = model
        self._net = model.bind({k: v.to(self.device)
                                for k, v in params.items()})
        self.max_len = max_len
        self._cache = init_cache(model, 1, max_len, per_row=True,
                                 device=self.device)
        self._chunk = prefill_chunk
        self.stats = {"prefills": 0}

    def kv_leaf_shapes(self, plen: int) -> list[tuple]:
        """Per-leaf KV block shapes for a prompt of length `plen`; equal to
        the decode tier's ``BatchServer.kv_leaf_shapes(plen)``."""
        return [(plen,) + tuple(leaf.shape[2:])
                for leaf in _kv_leaves(self._cache)]

    @torch.no_grad()
    def prefill(self, prompt) -> tuple[list[np.ndarray], np.ndarray]:
        """Run prompt ingestion; returns (kv_rows, last_logits): the
        per-leaf f32 K/V prefixes and the final-position logit row, ready
        for ``kv.encode_kv_block`` / ``BatchServer.submit_kv``."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError(
                f"prompt must be 1-D non-empty, got shape {prompt.shape}")
        if prompt.size >= self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) must leave room for generation "
                f"under max_len {self.max_len}")
        plen = prompt.size
        cache = _set_cache_index(self._cache, 0)
        cache, last = _prefill(
            self._net, cache, torch.as_tensor(prompt[None], device=self.device),
            self._chunk)
        self._cache = cache
        leaves = _kv_leaves(cache)
        # One device-to-host copy for the whole block; compute-dtype values
        # widen to f32 exactly, so the f32 wire carries them bitwise.
        flat = torch.cat([leaf[0, :plen].reshape(-1) for leaf in leaves])
        flat = flat.float().cpu().numpy()
        shape = (plen,) + tuple(leaves[0].shape[2:])
        kv_rows = list(flat.reshape((len(leaves),) + shape))
        self.stats["prefills"] += 1
        return kv_rows, last[0].float().cpu().numpy()
