"""Autoregressive generation with a per-layer KV cache (port of
``tpunet/models/generate.py``, non-speculative parts).

The cache is a dict keyed ``block{i}/attn/cached_key``,
``block{i}/attn/cached_value`` (each (batch, capacity, kv_heads, head_dim)
in the compute dtype) and ``block{i}/attn/cache_index`` (int32; () for
lockstep decoding, (batch,) for the per-row cache of continuous batching).
The model's decode step updates it in place.

KV leaf order is a wire contract: the serving tier ships a request's K/V
as the cached_key/cached_value leaves in the order `_kv_leaves` yields,
which is the flax tree-flatten order of the JAX package (dict keys sorted,
so block0, block1, block10, block11, block2, ... at 12 layers). Sorting the
flat keys gives exactly that order.
"""

from __future__ import annotations

import torch

from tpunet_torch import _device

_KV_NAMES = ("cached_key", "cached_value")


def init_cache(model, batch: int, max_len: int, *, per_row: bool = False,
               device=None) -> dict:
    """Allocate a zeroed decode cache for `batch` sequences of capacity
    `max_len` (prompt + generated)."""
    if model.attn_window is not None and model.decode_ring_cache:
        raise NotImplementedError(
            "the rolling ring decode cache (attn_window with "
            "decode_ring_cache=True) is a later slice of the port (model "
            "options slice); pass "
            "decode_ring_cache=False for the full-capacity masked cache")
    dev = _device.resolve(device)
    kv = model.n_kv_heads or model.n_heads
    shape = (batch, max_len, kv, model.head_dim)
    cache = {}
    for i in range(model.n_layers):
        p = f"block{i}/attn/"
        cache[p + "cached_key"] = torch.zeros(shape, dtype=model.compute_dtype,
                                              device=dev)
        cache[p + "cached_value"] = torch.zeros(
            shape, dtype=model.compute_dtype, device=dev)
        cache[p + "cache_index"] = torch.zeros(
            (batch,) if per_row else (), dtype=torch.int32, device=dev)
    return cache


def _validate_sampling(temperature: float, top_k, top_p) -> None:
    if (top_k is not None or top_p is not None) and temperature == 0.0:
        raise ValueError("top_k/top_p require temperature > 0 (greedy "
                         "decoding ignores them silently otherwise)")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def filtered_logits(logits, temperature: float, top_k, top_p):
    """The sampling distribution as masked/scaled logits: temperature, then
    top-k, then nucleus top-p. Requires temperature > 0."""
    logits = logits / temperature
    if top_k is not None and top_k < logits.shape[-1]:
        _, idx = torch.topk(logits, top_k, dim=-1)
        keep = torch.zeros_like(logits, dtype=torch.bool).scatter_(
            -1, idx, True)
        logits = logits.masked_fill(~keep, float("-inf"))
    if top_p is not None and top_p < 1.0:
        # One descending sort; keep the smallest prefix whose cumulative
        # probability reaches top_p (exclusive prefix sum: the top token
        # always survives).
        order = torch.argsort(-logits, dim=-1)
        sorted_logits = torch.gather(logits, -1, order)
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1) - probs
        keep = torch.zeros_like(logits, dtype=torch.bool).scatter_(
            -1, order, cum < top_p)
        logits = logits.masked_fill(~keep, float("-inf"))
    return logits


def make_sampler(temperature: float, top_k, top_p):
    """(logits (b, V), generator) -> (b,) int32 tokens: argmax at
    temperature 0, else a draw from the filtered distribution. The one
    sampler `generate` and the BatchServer both use."""

    def sample(logits, generator=None):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(
            filtered_logits(logits.float(), temperature, top_k, top_p), -1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)

    return sample


def _prefill(net, cache, prompt, chunk: int | None):
    """Fill the decode cache with the prompt through `net` (a bound model);
    returns (cache, logits of the last prompt position). The first block
    goes through the prefill route
    (the configured attention kernel over the block); `chunk` C runs the
    rest in C-token cached steps, which changes only the blocking of the
    same block-causal computation."""
    b, p = prompt.shape

    def step(toks, prefill):
        return net(toks, cache=cache, prefill=prefill)[:, -1, :]

    if chunk is None or chunk >= p:
        return cache, step(prompt, True)
    if chunk < 1:
        raise ValueError(f"prefill_chunk must be >= 1, got {chunk}")
    last = step(prompt[:, :chunk], True)
    for start in range(chunk, p, chunk):
        last = step(prompt[:, start:start + chunk], False)
    return cache, last


@torch.no_grad()
def generate(model, params, prompt, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: int | None = None,
             top_p: float | None = None, generator=None,
             eos_id: int | None = None, prefill_chunk: int | None = None):
    """Generate `max_new_tokens` continuations of `prompt` (b, p). Greedy at
    temperature 0, else sampling from `generator`. After a sequence emits
    `eos_id` every later position is pinned to it. Returns
    (b, p + max_new_tokens) int32, prompt included, on the params' device."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    _validate_sampling(temperature, top_k, top_p)
    dev = _device.params_device(params)
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
    b, p = prompt.shape
    cache = init_cache(model, b, p + max_new_tokens, device=dev)
    sample = make_sampler(temperature, top_k, top_p)
    net = model.bind(params)
    cache, last = _prefill(net, cache, prompt, prefill_chunk)
    tok = sample(last, generator)
    done = (tok == eos_id) if eos_id is not None else None
    out = [prompt, tok[:, None]]
    for _ in range(max_new_tokens - 1):
        logits = net(tok[:, None], cache=cache)
        nxt = sample(logits[:, -1, :], generator)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        tok = nxt
        out.append(tok[:, None])
    return torch.cat(out, dim=1)


def _kv_leaves(cache) -> list:
    """The cached_key/cached_value leaves in flax tree-flatten order (the
    serving tier's KV shipping order). Leaves are (batch, position,
    kv_heads, head_dim)."""
    return [cache[k] for k in sorted(cache)
            if k.rsplit("/", 1)[-1] in _KV_NAMES]


def _map_cache_index(cache, fn) -> dict:
    """A new cache dict with `fn` applied to every cache_index leaf."""
    return {k: fn(v) if k.endswith("/cache_index") else v
            for k, v in cache.items()}


def _get_cache_index(cache):
    """The current cache_index (every layer carries the same one)."""
    for k in sorted(cache):
        if k.endswith("/cache_index"):
            return cache[k]
    raise ValueError("cache has no cache_index leaf")


def _set_cache_index(cache, idx) -> dict:
    """A new cache dict with every cache_index set to `idx` (a scalar, or a
    (b,) vector for per-row caches)."""
    return _map_cache_index(
        cache, lambda leaf: torch.as_tensor(
            idx, dtype=leaf.dtype, device=leaf.device).expand(
                leaf.shape).clone())
