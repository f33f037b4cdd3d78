"""Autoregressive generation with a per-layer KV cache, and speculative
decoding (port of ``tpunet/models/generate.py``).

The cache is a dict keyed ``block{i}/attn/cached_key``,
``block{i}/attn/cached_value`` (each (batch, capacity, kv_heads, head_dim)
in the compute dtype) and ``block{i}/attn/cache_index`` (int32; () for
lockstep decoding, (batch,) for the per-row cache of continuous batching).
The model's decode step updates it in place. A windowed model with
``decode_ring_cache=True`` (the default) gets the rolling ring: leaves of
min(window, capacity) positions.

Sampling draws from explicit ``torch.Generator``s (never the global RNG
state), by inverse CDF over one uniform per row: a token of zero
probability is never drawn, and a NaN-poisoned row (an idle serving slot
parked past its capacity) draws garbage instead of raising, as
``jax.random.categorical`` does.

On a mesh (a ``Transformer`` with ``mesh`` and ``tp_axis``, its params the
rank's blocks) every entry point runs on the rank's rows of the batch over
the data axis (JAX's ``batch_sharding`` of the prompt) and returns them;
the cache holds the rank's kv heads, and the logits are gathered over the
tp axis, so every rank of a tp group picks its tokens from the same
logits: greedy needs nothing more, and sampled decoding draws the same
tokens when the ranks of a group pass generators of one seed.

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
    `max_len` (prompt + generated). A windowed model on the ring cache
    gets leaves of min(window, max_len) positions. A model over a mesh
    with tensor parallelism holds the rank's kv heads
    (``Transformer.local_kv_heads``)."""
    dev = _device.resolve(device)
    kv = model.local_kv_heads()
    length = max_len
    if model.attn_window is not None and model.decode_ring_cache:
        length = min(model.attn_window, max_len)
    shape = (batch, length, kv, model.head_dim)
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


def _categorical(probs, generator=None):
    """(b, V) probabilities -> (b,) int32 draws, one uniform u per row: the
    first token whose cumulative probability exceeds u times the row's
    total. A zero-probability token is never the first to exceed it; a
    NaN row gives token 0 instead of an error."""
    cdf = torch.cumsum(probs.float(), dim=-1)
    total = cdf[..., -1:]
    u = torch.rand(total.shape, generator=generator,
                   device=probs.device) * total
    # Strictly below the total, whatever the product's rounding.
    u = torch.minimum(u, torch.nextafter(total, torch.zeros_like(total)))
    return (cdf <= u).sum(-1).clamp(max=probs.shape[-1] - 1).to(torch.int32)


def make_sampler(temperature: float, top_k, top_p):
    """(logits (b, V), generator) -> (b,) int32 tokens: argmax at
    temperature 0, else a draw from the filtered distribution. The one
    sampler `generate` and the BatchServer both use."""

    def sample(logits, generator=None):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return _categorical(torch.softmax(
            filtered_logits(logits.float(), temperature, top_k, top_p), -1),
            generator)

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


# -- speculative decoding ----------------------------------------------------


def _leading_accepts(accept):
    """(b, g) bool -> (b,) count of leading True per row: the number of
    draft tokens accepted before the first rejection."""
    return torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)


def _residual_probs(p, q):
    """The rejection-sampling residual norm(max(p - q, 0)): sampling from
    it after rejecting a draft from q makes the combined marginal exactly
    p. Where p == q the residual has no mass (that branch is never taken);
    p stands in so the draw stays well defined."""
    r = torch.clamp(p - q, min=0.0)
    z = r.sum(dim=-1, keepdim=True)
    return torch.where(z > 0, r / torch.clamp(z, min=1e-30), p)


def _spec_ring_ok(m, gamma: int) -> bool:
    """True when speculative rounds of this gamma can run on the model's
    rolling ring cache: a round writes gamma + 1 positions, which must not
    lap the ring (the stash would hold one slot twice)."""
    return (m.attn_window is not None
            and getattr(m, "decode_ring_cache", True)
            and gamma + 1 <= m.attn_window)


def _spec_ring_stash(cache, idx0, span: int) -> dict:
    """The ring slots a speculative round is about to overwrite, slots
    (idx0 + i) mod cap for i < span, per row: {leaf name: (b, span, kv,
    dh) copy} for the cached_key/cached_value leaves."""
    rows = torch.arange(idx0.shape[0], device=idx0.device)[:, None]
    steps = torch.arange(span, device=idx0.device)
    out = {}
    for name, leaf in cache.items():
        if name.rsplit("/", 1)[-1] in _KV_NAMES:
            out[name] = leaf[rows, (idx0[:, None] + steps) % leaf.shape[1]]
    return out


def _spec_ring_restore(cache, stash: dict, idx0, new_idx, span: int) -> dict:
    """Undo a round's ring writes past the committed frontier, in place:
    slots whose position p >= new_idx get their stashed (previous
    occupant's) K/V back; committed positions keep the round's writes,
    whose evicted predecessors lie outside every later query's window."""
    rows = torch.arange(idx0.shape[0], device=idx0.device)[:, None]
    pos = idx0[:, None] + torch.arange(span, device=idx0.device)
    rollback = (pos >= new_idx[:, None])[..., None, None]
    for name, saved in stash.items():
        leaf = cache[name]
        slot = pos % leaf.shape[1]
        leaf[rows, slot] = torch.where(rollback, saved, leaf[rows, slot])
    return cache


def _make_spec_round_core(t_net, d_net, gamma: int, greedy: bool, probs_of,
                          t_ring: bool, d_ring: bool):
    """The device core of one speculative round, shared by
    `speculative_generate` and the speculative BatchServer: gamma + 1 draft
    steps, one verify forward, accept/reject, the fix or bonus token, the
    committed block, the ring stash and restore. `t_net` / `d_net` are
    bound models; the caches are updated in place.

    The caller supplies the schedule: `adjust_n(n_rows)` turns per-row
    acceptance into the commit length (identity per row; done-freeze and
    batch min in lockstep) and `commit_index(n_eff)` the post-round
    frontier the ring restore keys on; it then sets the cache index.
    Returns (w, n_rows, n_eff) with w (b, gamma+1): each row's committed
    tokens are w[:n_eff+1]."""

    def draft(d_cache, tok, generator):
        # gamma draft tokens plus ONE extra step whose token is discarded:
        # it feeds d_gamma through the draft so its K/V lands in the draft
        # cache. Without it a fully accepted round leaves the committed
        # frontier's last token missing from the draft cache, and every
        # later round drafts against a zero K/V slot.
        toks, qs = [], []
        for _ in range(gamma + 1):
            row = d_net(tok[:, None], cache=d_cache)[:, -1, :]
            if greedy:
                tok = torch.argmax(row, dim=-1).to(torch.int32)
            else:
                q = probs_of(row)
                tok = _categorical(q, generator)
                qs.append(q)
            toks.append(tok)
        return (torch.stack(toks[:gamma], dim=1),
                torch.stack(qs[:gamma], dim=1) if qs else None)

    def round_core(t_cache, d_cache, last_tok, idx0, generator, adjust_n,
                   commit_index):
        b = last_tok.shape[0]
        dev = last_tok.device
        rows = torch.arange(b, device=dev)
        # Both caches sit at idx0 (the round-boundary invariant); on the
        # ring, stash the slots this round overwrites.
        d_stash = (_spec_ring_stash(d_cache, idx0, gamma + 1)
                   if d_ring else None)
        t_stash = (_spec_ring_stash(t_cache, idx0, gamma + 1)
                   if t_ring else None)
        d_toks, q_probs = draft(d_cache, last_tok, generator)
        # Verify: ONE target forward over [last, d_1..d_gamma]; row j
        # scores draft position j, row gamma is the bonus distribution.
        block = torch.cat([last_tok[:, None], d_toks], dim=1)
        t_logits = t_net(block, cache=t_cache)
        d_idx = d_toks.long()[..., None]
        if greedy:
            t_argmax = torch.argmax(t_logits, dim=-1).to(torch.int32)
            accept = d_toks == t_argmax[:, :gamma]
        else:
            vocab = t_logits.shape[-1]
            p_probs = probs_of(t_logits.reshape(b * (gamma + 1), vocab)
                               ).reshape(b, gamma + 1, vocab)
            p_tok = torch.gather(p_probs[:, :gamma], 2, d_idx)[..., 0]
            q_tok = torch.gather(q_probs, 2, d_idx)[..., 0]
            u = torch.rand((b, gamma), generator=generator, device=dev)
            accept = u * q_tok < p_tok
        n_rows = _leading_accepts(accept)
        n_eff = adjust_n(n_rows)
        # The (n_eff+1)-th token of the round, per row: its own accepted
        # draft token when its rejection came later (lockstep only), else
        # the residual sample at its rejection, else (all accepted) a bonus
        # sample from the target's row gamma.
        last_draft = n_eff.clamp(max=gamma - 1)
        if greedy:
            fix_tok = t_argmax[rows, n_eff]
        else:
            p_n = p_probs[rows, n_eff]
            res = _residual_probs(p_n, q_probs[rows, last_draft])
            fix_tok = _categorical(
                torch.where((n_eff >= gamma)[:, None], p_n, res), generator)
        keep_own = (n_rows > n_eff) & (n_eff < gamma)
        e_tok = torch.where(keep_own, d_toks[rows, last_draft], fix_tok)
        # The committed block (static width; entries past n_eff are junk
        # the caller discards or overwrites).
        w = torch.cat([d_toks, e_tok[:, None]], dim=1)
        offs = torch.arange(gamma + 1, device=dev)[None, :]
        w = torch.where(offs == n_eff[:, None], e_tok[:, None], w)
        new_idx = commit_index(n_eff)
        if t_ring:
            _spec_ring_restore(t_cache, t_stash, idx0, new_idx, gamma + 1)
        if d_ring:
            _spec_ring_restore(d_cache, d_stash, idx0, new_idx, gamma + 1)
        return w, n_rows, n_eff

    return round_core


@torch.no_grad()
def speculative_generate(model, params, draft_model, draft_params, prompt,
                         max_new_tokens: int, *, gamma: int = 4,
                         temperature: float = 0.0, top_k: int | None = None,
                         top_p: float | None = None, generator=None,
                         eos_id: int | None = None,
                         prefill_chunk: int | None = None,
                         per_row: bool = False, return_stats: bool = False):
    """Speculative decoding: draft `gamma` tokens with the cheap
    `draft_model`, verify them in ONE target forward, keep the accepted
    prefix. Exact with respect to the target's sampling distribution:
    greedy output is `generate`'s token for token (up to ties the verify
    block's and the one-token step's matmul shapes may break differently),
    sampled output follows the same per-position distribution through the
    accept/residual rule.

    Lockstep by default: the batch commits min over its rows of the
    accepted-prefix length plus one token each round (a shared scalar cache
    index). `per_row=True` runs per-row cache indexes, so each row commits
    its own prefix; finished rows keep drafting into their frozen tail
    until the slowest row ends. A windowed model speculates on its ring
    cache when gamma + 1 <= window (stash and restore of the overwritten
    slots), else on the full-capacity masked cache.

    The draft shares the target's vocabulary and its quality moves only
    throughput. Everything runs on the params' device; the draft's params
    and `generator` must be on it too. Returns (b, p + max_new_tokens)
    int32 like `generate`; with return_stats=True also {"rounds",
    "draft_accept_rate"} (acceptance over rows still doing real work).
    On the card the host reads the loop condition one round late, so the
    last call may run one round more, which changes no output or stat."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    _validate_sampling(temperature, top_k, top_p)
    if draft_model.vocab != model.vocab:
        raise ValueError("draft vocab must match the target")
    dev = _device.params_device(params)
    if not _device.same(_device.params_device(draft_params), dev):
        raise ValueError("draft_params must be on the target params' "
                         f"device {dev}")
    if generator is not None and not _device.same(generator.device, dev):
        raise ValueError(f"generator must be on the params' device {dev}, "
                         f"got {generator.device}")
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
    b, p = prompt.shape
    # Slack past max_new: the verify block overshoots by < gamma + 1, and a
    # finished row's frozen frontier rewrites one block each extra round.
    cap = p + max_new_tokens + gamma + 1
    t_ring = _spec_ring_ok(model, gamma)
    d_ring = _spec_ring_ok(draft_model, gamma)
    tm = model.clone(decode_ring_cache=t_ring)
    dm = draft_model.clone(decode_ring_cache=d_ring)
    t_net, d_net = tm.bind(params), dm.bind(draft_params)
    t_cache = init_cache(tm, b, cap, per_row=per_row, device=dev)
    d_cache = init_cache(dm, b, cap, per_row=per_row, device=dev)
    greedy = temperature == 0.0

    def probs_of(logits):
        return torch.softmax(
            filtered_logits(logits.float(), temperature, top_k, top_p), -1)

    # Prefill both; the first token is an ordinary target sample.
    t_cache, last = _prefill(t_net, t_cache, prompt, prefill_chunk)
    d_cache, _ = _prefill(d_net, d_cache, prompt, prefill_chunk)
    tok0 = (torch.argmax(last, dim=-1).to(torch.int32) if greedy
            else _categorical(probs_of(last), generator))
    done = (tok0 == eos_id if eos_id is not None
            else torch.zeros(b, dtype=torch.bool, device=dev))
    out = torch.zeros((b, cap), dtype=torch.int32, device=dev)
    out[:, :p] = prompt
    out[:, p] = tok0
    n_out = torch.ones(b, dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)
    offs = torch.arange(gamma + 1, device=dev)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    rounds, acc_sum, prop_sum = zero.clone(), zero.clone(), zero.clone()
    core = _make_spec_round_core(t_net, d_net, gamma, greedy, probs_of,
                                 t_ring, d_ring)
    lagged = None  # the card's (pinned flag, event) of the previous round
    while max_new_tokens > 1:
        rounds += n_out.min() < max_new_tokens
        L = p + n_out                       # committed tokens per row
        idx0 = L - 1                        # the round-boundary invariant

        def adjust_n(n_raw, done=done):
            # A finished row must not hold the batch back; lockstep commits
            # the batch min (one shared frontier).
            frozen = torch.where(done, gamma, n_raw)
            return frozen if per_row else frozen.min().expand(b)

        def commit_index(n_eff, n_out=n_out):
            # Clamped at the schedule: a finished row's frontier freezes.
            return p + torch.clamp(n_out + n_eff + 1, max=max_new_tokens) - 1

        w, n_rows, n_eff = core(t_cache, d_cache, out[rows, idx0], idx0,
                                generator, adjust_n, commit_index)
        active = (n_out < max_new_tokens) & ~done
        acc_sum += torch.where(active, n_rows, 0).sum()
        prop_sum += gamma * active.sum()
        if eos_id is not None:
            seen, cols = done, []
            for j in range(gamma + 1):
                wj = torch.where(seen, eos_id, w[:, j])
                seen = seen | (wj == eos_id)
                cols.append(wj)
            w = torch.stack(cols, dim=1)
            done = done | ((w == eos_id) & (offs <= n_eff[:, None])).any(1)
        # Rows sit at different offsets; L + gamma <= cap - 1 always, and a
        # finished row's writes land in the slack past max_new.
        out[rows[:, None], L[:, None] + offs] = w
        n_out = torch.clamp(n_out + n_eff + 1, max=max_new_tokens)
        cidx = p + n_out - 1
        if not per_row:
            cidx = cidx[0]  # lockstep caches take a scalar index
        t_cache = _set_cache_index(t_cache, cidx)
        d_cache = _set_cache_index(d_cache, cidx)
        more = n_out.min() < max_new_tokens
        if dev.type != "cuda":
            if not bool(more):
                break
            continue
        # The card: read the previous round's flag, so the host queues this
        # round without waiting for it; a finished batch's extra round only
        # rewrites its slack columns and frozen cache tails.
        flag = torch.empty((), dtype=torch.bool, pin_memory=True)
        flag.copy_(more, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        if lagged is not None:
            lagged[1].synchronize()
            if not bool(lagged[0]):
                break
        lagged = (flag, event)
    result = out[:, :p + max_new_tokens]
    if not return_stats:
        return result
    return result, {"rounds": int(rounds),
                    "draft_accept_rate": float(acc_sum) / max(
                        int(prop_sum), 1)}
