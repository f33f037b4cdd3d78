"""Continuous batching: a slot server over the per-row decode cache (port of
``tpunet/models/serve.py``).

The model runs with a per-row cache (each batch row has its own
cache_index), so rows are independent sequences: a finished row's slot is
refilled for the next queued request while the other rows keep decoding.
The decode step always runs all `slots` rows, live or not, so its shapes
never change; idle rows decode garbage into their own dead cache rows, a
refill resets the row's index to 0, and stale K/V above a row's frontier
stays masked (`key_pos <= q_pos`) until overwritten.

A refill runs `_prefill` on the claimed rows, grouped by prompt length as
(n, p) batches; a single claim is a (1, p) row, the very shape the serving
tier's PrefillEngine runs, which is what makes shipped-KV serving bitwise
equal to this server on an exact wire. `submit_kv` is the disaggregated
refill: the prompt K/V computed elsewhere is written into the slot and the
first token is sampled from the shipped logits.

Speculative mode (`draft_model=`, `draft_params=`, `gamma=`): each decode
window is `steps_per_call` speculative rounds over every slot (draft gamma,
verify in one target forward, commit each row's own accepted prefix plus
the fix or bonus token), through the same round core as
`speculative_generate`. A window commits up to gamma + 1 tokens a row; the
draft cache rides the same slot lifecycle (a refill prefills both). Both
caches hold gamma + 1 positions of slack past `max_len`, and idle rows
park at that capacity.

On a mesh (a model with ``mesh`` and ``tp_axis``, its params the rank's
blocks) every rank runs the whole server: all slots, the same submissions
and admissions, so the same tokens, with the layers split over the tp
axis and each dp replica repeating its group's work (JAX's dry run
shards only the params; GSPMD then replicates the slots and the cache
over dp). ``submit_kv`` takes whole-head rows there too and installs
the rank's kv heads (``Transformer.kv_head_ids``): the KV wire is the
single-rank tier's.

Device work is issued asynchronously; the host reads a window's tokens
back once (`run(pipeline=2)` keeps a second window in flight meanwhile).
The cache is updated in place.
"""

from __future__ import annotations

from collections import deque
from itertools import count

import numpy as np
import torch

from tpunet_torch import _device
from tpunet_torch.models.generate import (_get_cache_index, _kv_leaves,
                                          _make_spec_round_core,
                                          _map_cache_index, _prefill,
                                          _set_cache_index, _spec_ring_ok,
                                          _validate_sampling, filtered_logits,
                                          init_cache, make_sampler)


def refuse_mesh(model, what: str) -> None:
    """What the serving tiers still refuse for a model over a mesh with a
    tp axis (ROADMAP A.12b): a live weight swap into its tp group."""
    if (getattr(model, "mesh", None) is not None
            and getattr(model, "tp_axis", None) is not None):
        raise NotImplementedError(
            f"{what} with a model over a mesh: a live weight swap into a "
            "tp group of ranks is not ported (ROADMAP A.12b); restart the "
            "group on the new weights")


class BatchServer:
    """Continuous-batching decode server.

    submit() enqueues a request; slots are assigned at the next
    step()/run() boundary, so a burst of submissions prefills together.
    step() advances every live slot `steps_per_call` tokens (or
    speculative rounds of up to gamma + 1 tokens, with a draft model) and
    returns the requests that finished. Greedy by default;
    temperature/top-k/top-p sample per row from `generator`, which must be
    on the server's device."""

    def __init__(self, model, params, *, slots: int, max_len: int,
                 temperature: float = 0.0, top_k: int | None = None,
                 top_p: float | None = None, eos_id: int | None = None,
                 generator=None, prefill_chunk: int | None = None,
                 steps_per_call: int = 1, refill_coalesce: int = 1,
                 draft_model=None, draft_params=None, gamma: int = 4,
                 on_first_token=None, device=None):
        _validate_sampling(temperature, top_k, top_p)
        spec = draft_model is not None
        if (draft_model is None) != (draft_params is None):
            raise ValueError("draft_model and draft_params come together")
        if spec and gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        if spec and getattr(draft_model, "n_experts", 0):
            raise ValueError("draft_model must be dense (same MoE "
                             "batch-coupling argument as the target)")
        if spec and draft_model.vocab != model.vocab:
            raise ValueError("draft vocab must match the target")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if steps_per_call < 1:
            raise ValueError(
                f"steps_per_call must be >= 1, got {steps_per_call}")
        if refill_coalesce < 1:
            raise ValueError(
                f"refill_coalesce must be >= 1, got {refill_coalesce}")
        if getattr(model, "n_experts", 0):
            # MoE capacity is computed batch-wide (t = b*s slots claimed by
            # a cross-row cumulative count), so other rows' tokens, idle
            # ones included, change which of a live row's tokens are
            # dropped: the per-slot parity contract cannot hold.
            raise ValueError(
                "BatchServer requires a dense model: MoE capacity couples "
                "rows (batch-wide expert slots), breaking per-slot "
                "independence")
        self.device = _device.resolve(device)
        if generator is not None and not _device.same(generator.device,
                                                      self.device):
            raise ValueError(f"generator must be on the server's device "
                             f"{self.device}, got {generator.device}")
        self.model = model
        # Speculation keeps a windowed model on its ring only when a
        # round's gamma + 1 writes cannot lap it.
        tm = (model.clone(decode_ring_cache=_spec_ring_ok(model, gamma))
              if spec else model)
        self._net = tm.bind({k: v.to(self.device)
                             for k, v in params.items()})
        self.slots, self.max_len = slots, max_len
        # A freed slot is not refilled until this many are free (or nothing
        # decodes, or the queue drains anyway); see the JAX BatchServer.
        self.refill_coalesce = min(refill_coalesce, slots)
        self.eos_id = eos_id
        self.steps_per_call = steps_per_call
        self._prefill_chunk = prefill_chunk
        # A verify block overshoots a live row's frontier by up to gamma:
        # speculation adds gamma + 1 positions of slack (submit() still
        # bounds prompt + max_new <= max_len).
        cache_cap = max_len + (gamma + 1 if spec else 0)
        self._cache = init_cache(tm, slots, cache_cap, per_row=True,
                                 device=self.device)
        self._draft = draft_model
        self._free = list(range(slots))
        self._live: dict[int, dict] = {}       # slot -> request record
        self._pending: list[dict] = []
        self._ids = count()
        self._toks = torch.zeros(slots, dtype=torch.int32, device=self.device)
        self._gen = generator
        self._sample = make_sampler(temperature, top_k, top_p)
        self._done_buffer: list[dict] = []
        self.stats = {"decode_windows": 0, "prefills": 0, "kv_adopts": 0}
        # Called with a request's id when its first token is committed
        # (TTFT instrumentation for the disaggregated decode worker).
        self._on_first_token = on_first_token
        if spec:
            d_ring = _spec_ring_ok(draft_model, gamma)
            dm = draft_model.clone(decode_ring_cache=d_ring)
            self._dnet = dm.bind({k: v.to(self.device)
                                  for k, v in draft_params.items()})
            self._dcache = init_cache(dm, slots, cache_cap, per_row=True,
                                      device=self.device)
            self.gamma = gamma
            self._spec_cap = cache_cap

            def probs_of(logits):
                return torch.softmax(filtered_logits(
                    logits.float(), temperature, top_k, top_p), -1)

            self._round_core = _make_spec_round_core(
                self._net, self._dnet, gamma, temperature == 0.0, probs_of,
                _spec_ring_ok(model, gamma), d_ring)
            self.stats["spec_rounds"] = 0
            self.stats["spec_committed"] = 0

    # -- device programs ---------------------------------------------------

    @torch.no_grad()
    def _decode_step(self):
        """One window: `steps_per_call` tokens for every slot; returns the
        (slots, window) device tensor of sampled tokens."""
        outs = []
        for _ in range(self.steps_per_call):
            logits = self._net(self._toks[:, None], cache=self._cache)
            self._toks = self._sample(logits[:, -1, :], self._gen)
            outs.append(self._toks)
        # Idle rows' indexes park at max_len: their writes land past the
        # end (dropped) and their outputs stay NaN-poisoned.
        self._cache = _map_cache_index(
            self._cache, lambda leaf: leaf.clamp(max=self.max_len))
        return torch.stack(outs, dim=1)

    @torch.no_grad()
    def _spec_decode_step(self):
        """One speculative window: `steps_per_call` rounds over every slot,
        each committing its row's own accepted prefix plus one token.
        Returns the (slots, rounds, gamma + 2) device tensor of committed
        blocks, each round's commit count in its last column."""
        g = self.gamma
        rows = torch.arange(self.slots, device=self.device)
        outs = []
        for _ in range(self.steps_per_call):
            idx0 = _get_cache_index(self._cache).long()  # round frontier
            w, _, n_eff = self._round_core(
                self._cache, self._dcache, self._toks, idx0, self._gen,
                lambda n_raw: n_raw,                      # per-row commits
                lambda n_eff, idx0=idx0: idx0 + n_eff + 1)
            counts = n_eff + 1
            # Idle rows park at the capacity (the slack keeps live rows
            # below it), not at max_len.
            new_idx = torch.clamp(idx0 + counts, max=self._spec_cap)
            self._cache = _set_cache_index(self._cache, new_idx)
            self._dcache = _set_cache_index(self._dcache, new_idx)
            self._toks = w[rows, n_eff]
            outs.append(torch.cat([w, counts[:, None].to(w.dtype)], dim=1))
        return torch.stack(outs, dim=1)

    def _refill(self, net, cache, prompts, rows):
        """Row surgery on one cache: gather the claimed rows, reset their
        indexes, prefill, scatter back; returns the last prompt logits."""
        row = {k: v[rows] for k, v in cache.items()}
        row = _set_cache_index(row, 0)
        row, last = _prefill(net, row, prompts, self._prefill_chunk)
        for k, v in cache.items():
            v[rows] = row[k]
        return last

    @torch.no_grad()
    def _prefill_slots(self, prompts, rows):
        """Refill the claimed rows of the cache (and, speculating, of the
        draft cache: the draft must hold the prompt before it proposes);
        returns the sampled first tokens."""
        last = self._refill(self._net, self._cache, prompts, rows)
        if self._draft is not None:
            self._refill(self._dnet, self._dcache, prompts, rows)
        tok = self._sample(last, self._gen)
        self._toks[rows] = tok
        return tok

    @torch.no_grad()
    def _adopt_slots(self, kv, last, rows):
        """Disaggregated refill: write the shipped prompt K/V (one (n, p,
        kv_heads, head_dim) block per _kv_leaves leaf, in that order) into
        the claimed rows, set their indexes to p, and sample the first token
        from the shipped final-position logits."""
        plen = kv[0].shape[1]
        span = torch.arange(plen, device=self.device)
        for leaf, blk in zip(_kv_leaves(self._cache), kv):
            leaf[rows[:, None], span[None, :]] = blk.to(leaf.dtype)
        for k, v in self._cache.items():
            if k.endswith("/cache_index"):
                v[rows] = plen
        tok = self._sample(last, self._gen)
        self._toks[rows] = tok
        return tok

    # -- requests ----------------------------------------------------------

    def _check_request(self, prompt, max_new_tokens: int) -> np.ndarray:
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError(f"prompt must be 1-D non-empty, got "
                             f"shape {prompt.shape}")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new ({max_new_tokens}) "
                f"exceeds max_len {self.max_len}")
        return prompt

    def submit(self, prompt, max_new_tokens: int) -> int:
        """Enqueue one request; returns its id. The prompt is uploaded now
        so the refill reads a device tensor."""
        prompt = self._check_request(prompt, max_new_tokens)
        req = {"id": next(self._ids), "prompt": prompt,
               "prompt_dev": torch.as_tensor(prompt[None],
                                             device=self.device),
               "max_new": max_new_tokens, "chunks": [], "n_out": 0}
        self._pending.append(req)
        return req["id"]

    def kv_leaf_shapes(self, plen: int) -> list[tuple]:
        """Per-leaf KV block shapes `submit_kv` takes for a prompt of
        length `plen`, in shipping order: (plen, kv_heads, head_dim), whole
        heads on a mesh too."""
        kv = self.model.n_kv_heads or self.model.n_heads
        return [(plen, kv, leaf.shape[3]) for leaf in _kv_leaves(self._cache)]

    def submit_kv(self, prompt, max_new_tokens: int, kv_rows,
                  last_logits) -> int:
        """Enqueue one request whose prompt K/V was computed elsewhere (a
        prefill rank) and shipped here: `kv_rows` are numpy arrays matching
        kv_leaf_shapes(len(prompt)), `last_logits` the prefill's
        final-position logit row (vocab,). On a mesh the rows are whole
        heads; the rank keeps its own (``kv_head_ids``)."""
        if self._draft is not None:
            raise ValueError(
                "submit_kv requires a non-speculative server: the draft "
                "cache has no shipped prompt K/V to propose from")
        if self.model.attn_window is not None:
            raise ValueError(
                "submit_kv requires a full-capacity cache (attn_window "
                "models do not keep the shipped prefix layout)")
        prompt = self._check_request(prompt, max_new_tokens)
        shapes = self.kv_leaf_shapes(prompt.size)
        if len(kv_rows) != len(shapes):
            raise ValueError(f"expected {len(shapes)} KV blocks, "
                             f"got {len(kv_rows)}")
        kv_rows = [np.asarray(b, np.float32) for b in kv_rows]
        for i, (blk, want) in enumerate(zip(kv_rows, shapes)):
            if tuple(blk.shape) != want:
                raise ValueError(f"KV block {i} has shape "
                                 f"{tuple(blk.shape)}, expected {want}")
        ids = self.model.kv_head_ids()
        if ids != list(range(shapes[0][1])):
            kv_rows = [b[:, ids] for b in kv_rows]
        last_logits = np.asarray(last_logits, np.float32)
        if last_logits.shape != (self.model.vocab,):
            raise ValueError(f"last_logits must be ({self.model.vocab},), "
                             f"got {last_logits.shape}")
        req = {"id": next(self._ids), "prompt": prompt,
               "max_new": max_new_tokens, "chunks": [], "n_out": 0,
               "kv_rows": kv_rows, "kv_logits": last_logits}
        self._pending.append(req)
        return req["id"]

    def _fill_slots(self, defer: bool = False) -> None:
        if not (self._free and self._pending):
            return
        if (len(self._free) < self.refill_coalesce and self._live
                and len(self._pending) > len(self._free)):
            return  # hold out for a batched refill (see refill_coalesce)
        claims = []
        while self._free and self._pending:
            claims.append((self._pending.pop(0), self._free.pop()))
        by_len: dict[int, list] = {}
        by_len_kv: dict[int, list] = {}
        for req, r in claims:
            target = by_len_kv if "kv_rows" in req else by_len
            target.setdefault(req["prompt"].size, []).append((req, r))

        def commit(group, tok):
            if defer:
                # Pipelined mode: no readback now; the next absorb resolves
                # the held device vector before that window's tokens.
                holder = {"dev": tok, "np": None}
                for i, (req, r) in enumerate(group):
                    self._live[r] = req
                    req["_pending"] = (holder, i)
            else:
                arr = tok.cpu().numpy()
                for i, (req, r) in enumerate(group):
                    self._live[r] = req
                    self._append_tokens(r, req, arr[i: i + 1])

        for group in by_len.values():
            reqs = [q for q, _ in group]
            rows = torch.as_tensor([r for _, r in group], device=self.device)
            prompts = torch.cat([q["prompt_dev"] for q in reqs], dim=0)
            tok = self._prefill_slots(prompts, rows)
            self.stats["prefills"] += len(group)
            commit(group, tok)
        for group in by_len_kv.values():
            reqs = [q for q, _ in group]
            rows = torch.as_tensor([r for _, r in group], device=self.device)
            kv = [torch.from_numpy(np.stack([q["kv_rows"][i] for q in reqs])
                                   ).to(self.device)
                  for i in range(len(reqs[0]["kv_rows"]))]
            last = torch.from_numpy(
                np.stack([q["kv_logits"] for q in reqs])).to(self.device)
            for q in reqs:  # the device copies own the data now
                q.pop("kv_rows")
                q.pop("kv_logits")
            tok = self._adopt_slots(kv, last, rows)
            self.stats["kv_adopts"] += len(group)
            commit(group, tok)

    def _append_tokens(self, r: int, req: dict, toks_np) -> None:
        """Commit a window's tokens to a request: cut at max_new, then at
        the first eos; retire the request when either bound is hit."""
        take = min(req["max_new"] - req["n_out"], len(toks_np))
        first = req["n_out"] == 0
        chunk = toks_np[:take]
        if self.eos_id is not None:
            hits = np.nonzero(chunk == self.eos_id)[0]
            if hits.size:
                chunk = chunk[: hits[0] + 1]  # keep the eos itself
        req["chunks"].append(chunk)
        req["n_out"] += len(chunk)
        if first and len(chunk) and self._on_first_token is not None:
            self._on_first_token(req["id"])  # TTFT hook (serving tier)
        if (req["n_out"] >= req["max_new"]
                or (self.eos_id is not None and chunk.size
                    and chunk[-1] == self.eos_id)):
            del self._live[r]
            self._free.append(r)
            self._done_buffer.append(
                {"id": req["id"], "prompt": req["prompt"],
                 "tokens": np.concatenate(req["chunks"]).astype(np.int32)})

    def _dispatch_window(self):
        """Issue one decode window without reading it back; returns it with
        a {slot: request_id} snapshot of occupancy at dispatch time."""
        window = (self._spec_decode_step() if self._draft is not None
                  else self._decode_step())
        self.stats["decode_windows"] += 1
        return window, {r: req["id"] for r, req in self._live.items()}

    def _absorb_window(self, window, ids_at_dispatch) -> None:
        window = window.cpu().numpy()  # the window's one readback
        for r, rid in ids_at_dispatch.items():
            req = self._live.get(r)
            if req is None or req["id"] != rid:
                continue  # retired or recycled since this window launched
            if "_pending" in req:
                holder, i = req.pop("_pending")
                if holder["np"] is None:
                    holder["np"] = holder["dev"].cpu().numpy()
                self._append_tokens(r, req, holder["np"][i: i + 1])
                if r not in self._live:
                    continue
            if self._draft is None:
                self._append_tokens(r, req, window[r])
                continue
            for blk in window[r]:  # speculative rounds: tokens, then count
                c = int(blk[-1])
                self.stats["spec_rounds"] += 1
                self.stats["spec_committed"] += c
                self._append_tokens(r, req, blk[:c])
                if r not in self._live:
                    break  # the row's later rounds are garbage

    def step(self) -> list[dict]:
        """Advance every live slot one window; returns the requests that
        finished as {"id", "prompt", "tokens"} dicts."""
        self._fill_slots()
        if self._live:
            window, ids = self._dispatch_window()
            self._absorb_window(window, ids)
            self._fill_slots()
        finished, self._done_buffer = self._done_buffer, []
        return finished

    def run(self, *, pipeline: int = 1) -> dict[int, np.ndarray]:
        """Drive until every submitted request finishes; returns
        {request_id: generated tokens}. `pipeline` keeps that many windows
        in flight, so host bookkeeping overlaps device compute; greedy
        outputs do not depend on it."""
        if pipeline < 1:
            raise ValueError(f"pipeline must be >= 1, got {pipeline}")
        results = {}
        inflight = deque()
        defer = pipeline >= 2
        while (self._live or self._pending or self._done_buffer
               or inflight):
            finished, self._done_buffer = self._done_buffer, []
            for rec in finished:
                results[rec["id"]] = rec["tokens"]
            self._fill_slots(defer=defer)
            while self._live and len(inflight) < pipeline:
                inflight.append(self._dispatch_window())
            if inflight:
                window, ids = inflight.popleft()
                self._absorb_window(window, ids)
                self._fill_slots(defer=defer)
        return results
