"""MoE expert dispatch/combine over the typed AllToAll (the port of
``tpunet/workloads/moe.py``, numpy in and out as there).

The expert-parallel layout: W ranks, one expert shard per rank (expert e
lives on rank e). Every rank routes its local tokens top-1 to experts with
a Zipf-skewed popularity (exponent ``TPUNET_MOE_SKEW``), packs them into
capacity-bounded per-expert blocks, and ships them with ONE typed AllToAll
(``Communicator.all_to_all_typed``). The expert computes, and a second
typed AllToAll combines results back to the source positions.

Determinism contract: routing, packing and slot bookkeeping are pure
functions of (tokens, expert assignment, capacity), so the combine scatter
needs no extra metadata round: each dispatcher remembers which token sat
in which (expert, slot) and the A2A geometry is its own inverse. Tokens
beyond an expert's capacity are DROPPED (standard MoE overflow semantics)
and counted. Under an int8/bf16 wire codec the shipped blocks obey the
per-block |err| <= amax/254 bound (scale blocks restart per (src, dst)
block), and dropped-slot padding rides as zeros. For one
``np.random.Generator`` state, ``route_tokens`` draws the JAX package's
ids.
"""

from __future__ import annotations

import os

import numpy as np


def zipf_weights(n_experts: int, skew: float) -> np.ndarray:
    """Expert popularity: w_k proportional to 1/(k+1)^skew, normalized.
    skew=0 is uniform; larger skews concentrate load on low-index experts
    (expert ids are shuffled per routing call, so "expert 0" is not
    structurally hot across seeds)."""
    if n_experts < 1:
        raise ValueError(f"n_experts must be >= 1, got {n_experts}")
    if skew < 0:
        raise ValueError(f"skew must be >= 0, got {skew}")
    w = 1.0 / np.power(np.arange(1, n_experts + 1, dtype=np.float64), skew)
    return w / w.sum()


def route_tokens(n_tokens: int, n_experts: int, skew: float | None = None,
                 rng: np.random.Generator | None = None) -> np.ndarray:
    """Top-1 expert id per token, sampled from the Zipf popularity.
    ``skew=None`` reads TPUNET_MOE_SKEW (default 1.0 — the registered knob,
    validated by Config.from_env). The popularity ranking is permuted by
    ``rng`` so hotness lands on a random expert, not always expert 0."""
    if skew is None:
        try:
            skew = float(os.environ.get("TPUNET_MOE_SKEW", "1.0"))
        except ValueError:
            skew = 1.0
    rng = rng or np.random.default_rng(0)
    w = zipf_weights(n_experts, skew)[rng.permutation(n_experts)]
    return rng.choice(n_experts, size=n_tokens, p=w).astype(np.int64)


class MoeDispatcher:
    """Capacity-bounded top-1 dispatch/combine for one expert-parallel group.

    ``comm`` is a ``tpunet_torch.collectives.Communicator`` whose world
    size is the expert count (one expert shard per rank). ``capacity``
    bounds how many tokens any single (source rank -> expert) block
    carries per dispatch — the A2A
    block size is ``capacity * d_model`` f32 elements, identical on every
    rank, which is what lets the exchange run as one typed AllToAll with
    zero per-block metadata."""

    def __init__(self, comm, d_model: int, capacity: int):
        if d_model < 1 or capacity < 1:
            raise ValueError("d_model and capacity must be >= 1")
        self.comm = comm
        self.d_model = int(d_model)
        self.capacity = int(capacity)
        self._slot_of_token: np.ndarray | None = None
        self._kept: np.ndarray | None = None
        # Cumulative stats — the bench reads these next to the native
        # tpunet_a2a_bytes_total counters.
        self.tokens_routed = 0
        self.tokens_dropped = 0
        self.dispatches = 0

    # -- dispatch ----------------------------------------------------------

    def pack(self, tokens: np.ndarray, experts: np.ndarray):
        """Pack tokens into the (W, capacity, d) dispatch buffer. Returns
        (buf, counts) where counts[e] is the number of valid slots bound
        for expert e. Overflow tokens (beyond capacity per expert) are
        dropped and counted; their slot entry stays -1 so combine scatters
        nothing back into their output rows."""
        E = self.comm.world_size
        tokens = np.ascontiguousarray(tokens, np.float32)
        experts = np.asarray(experts, np.int64)
        if tokens.ndim != 2 or tokens.shape[1] != self.d_model:
            raise ValueError(f"tokens must be (T, {self.d_model}), got {tokens.shape}")
        if experts.shape != (tokens.shape[0],):
            raise ValueError("experts must be one id per token")
        if experts.size and (experts.min() < 0 or experts.max() >= E):
            raise ValueError(f"expert ids must be in [0, {E})")
        buf = np.zeros((E, self.capacity, self.d_model), np.float32)
        counts = np.zeros(E, np.int64)
        slot_of_token = np.full(tokens.shape[0], -1, np.int64)
        for i, e in enumerate(experts):
            c = counts[e]
            if c >= self.capacity:
                self.tokens_dropped += 1
                continue
            buf[e, c] = tokens[i]
            slot_of_token[i] = e * self.capacity + c
            counts[e] = c + 1
        self.tokens_routed += int(tokens.shape[0])
        self._slot_of_token = slot_of_token
        self._kept = slot_of_token >= 0
        return buf, counts

    def dispatch(self, tokens: np.ndarray, experts: np.ndarray):
        """Route this rank's tokens to their experts. Returns
        (expert_tokens, counts_by_source): expert_tokens is the
        (W, capacity, d) buffer of tokens THIS rank's expert received
        (indexed by source rank), counts_by_source[s] how many of source
        s's slots are valid. One typed AllToAll for the payload plus one
        8-byte-per-rank byte AllToAll for the counts."""
        buf, counts = self.pack(tokens, experts)
        expert_tokens = self.comm.all_to_all_typed(buf)
        counts_by_source = self.comm.all_to_all(
            np.ascontiguousarray(counts.reshape(-1, 1))).reshape(-1)
        self.dispatches += 1
        return expert_tokens, counts_by_source

    # -- combine -----------------------------------------------------------

    def combine(self, expert_out: np.ndarray, out: np.ndarray | None = None):
        """Inverse of dispatch: ship each processed (W, capacity, d) buffer
        back to its source rank (the A2A geometry is its own inverse) and
        scatter rows to the original token positions recorded by pack().
        Dropped tokens keep their ``out`` rows untouched (zeros by
        default — standard MoE overflow)."""
        if self._slot_of_token is None:
            raise RuntimeError("combine() before dispatch()")
        expert_out = np.ascontiguousarray(expert_out, np.float32)
        returned = self.comm.all_to_all_typed(expert_out)
        flat = returned.reshape(-1, self.d_model)
        n_tok = self._slot_of_token.shape[0]
        if out is None:
            out = np.zeros((n_tok, self.d_model), np.float32)
        kept = self._kept
        out[kept] = flat[self._slot_of_token[kept]]
        return out

    @property
    def drop_fraction(self) -> float:
        return self.tokens_dropped / max(1, self.tokens_routed)
