"""Prefill tier: prompt ingestion -> shippable KV blocks.

The prefill rank runs exactly the computation the single-host BatchServer's
refill runs for one request: the same ``_prefill`` on the same (1, p) row of
a per-row cache of capacity max_len. The extracted K/V prefix and
final-position logits are therefore bitwise what a local refill produces;
shipped over the exact (f32) wire and adopted into a decode slot, the
greedy token stream cannot be told apart from single-host serving.

On a mesh model the engine is a tp group of ranks (``serve.group``): the
leader's ``prefill`` broadcasts the prompt, every rank runs the same
``_prefill`` on its kv heads, and one all-gather a request brings the
ranks' heads to the leader, which ships whole heads (each from the first
rank that holds it): the block a single-rank engine ships. Followers run
``follow()`` until the leader's ``close()``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from tpunet_torch import _device
from tpunet_torch.models.generate import (_kv_leaves, _prefill,
                                          _set_cache_index, init_cache)
from tpunet_torch.serve.group import tier_group


class PrefillEngine:
    """One-slot prompt-ingestion engine for the frontend tier. Requires a
    dense model with no window (a full-capacity, per-row cache)."""

    def __init__(self, model, params, *, max_len: int,
                 prefill_chunk: int | None = None, device=None):
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
        self.group = tier_group(model)
        self._closed = False
        if self.group is not None:
            # Whole head j from (rank, cache position) of its first holder;
            # every rank's block padded to the widest rank's heads.
            layouts = [model.kv_head_ids(i) for i in range(self.group.size)]
            self._width = max(len(ids) for ids in layouts)
            self._owner = [next((r, ids.index(j))
                                for r, ids in enumerate(layouts) if j in ids)
                           for j in range(model.n_kv_heads or model.n_heads)]

    def kv_leaf_shapes(self, plen: int) -> list[tuple]:
        """Per-leaf KV block shapes for a prompt of length `plen` (whole
        heads, on a mesh too); equal to the decode tier's
        ``BatchServer.kv_leaf_shapes(plen)``."""
        kv = self.model.n_kv_heads or self.model.n_heads
        return [(plen, kv, leaf.shape[3]) for leaf in _kv_leaves(self._cache)]

    def prefill(self, prompt) -> tuple[list[np.ndarray], np.ndarray]:
        """Run prompt ingestion; returns (kv_rows, last_logits): the
        per-leaf f32 K/V prefixes and the final-position logit row, ready
        for ``kv.encode_kv_block`` / ``BatchServer.submit_kv``. On a mesh,
        the leader's call (its followers run the same in ``follow``)."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError(
                f"prompt must be 1-D non-empty, got shape {prompt.shape}")
        if prompt.size >= self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) must leave room for generation "
                f"under max_len {self.max_len}")
        if self.group is not None:
            if not self.group.leader:
                raise RuntimeError("a follower of a prefill group runs "
                                   "follow(), not prefill()")
            if self._closed:
                raise RuntimeError("this prefill group was closed")
            self.group.bcast(np.array([prompt.size], np.int64))
            self.group.bcast(prompt)
        return self._run(prompt)

    def follow(self) -> None:
        """A follower's loop: run each prompt the leader broadcasts, until
        its ``close()``."""
        if self.group is None or self.group.leader:
            raise RuntimeError("follow() runs on the followers of a mesh "
                               "model's tp group")
        while True:
            n = int(self.group.bcast(np.zeros(1, np.int64))[0])
            if n == 0:
                self._closed = True
                return
            self._run(self.group.bcast(np.zeros(n, np.int32)))

    def close(self) -> None:
        """Release a mesh group's followers (once; a no-op elsewhere)."""
        if (self.group is not None and self.group.leader
                and self.group.wired and not self._closed):
            self._closed = True
            self.group.bcast(np.zeros(1, np.int64))

    @torch.no_grad()
    def _run(self, prompt: np.ndarray):
        plen = prompt.size
        cache = _set_cache_index(self._cache, 0)
        guard = (self.group.tp_only() if self.group is not None
                 else contextlib.nullcontext())
        with guard:
            cache, last = _prefill(
                self._net, cache,
                torch.as_tensor(prompt[None], device=self.device),
                self._chunk)
        self._cache = cache
        self.stats["prefills"] += 1
        leaves = _kv_leaves(cache)
        if self.group is None:
            # One device-to-host copy for the whole block; compute-dtype
            # values widen to f32 exactly, so the f32 wire carries them
            # bitwise.
            flat = torch.cat([leaf[0, :plen].reshape(-1) for leaf in leaves])
            flat = flat.float().cpu().numpy()
            shape = (plen,) + tuple(leaves[0].shape[2:])
            kv_rows = list(flat.reshape((len(leaves),) + shape))
            return kv_rows, last[0].float().cpu().numpy()
        # (leaves, plen, width, dh) on every rank, one copy and one
        # all-gather a request; the leader keeps each head's first holder.
        block = torch.stack([leaf[0, :plen] for leaf in leaves])
        pad = self._width - block.shape[2]
        if pad:
            block = torch.nn.functional.pad(block, (0, 0, 0, pad))
        every = self.group.gather(block.float().cpu().numpy())
        if not self.group.leader:
            return None
        whole = np.empty(block.shape[:2] + (len(self._owner),)
                         + block.shape[3:], np.float32)
        for j, (r, i) in enumerate(self._owner):
            whole[:, :, j] = every[r, :, :, i]
        return list(whole), last[0].float().cpu().numpy()
