"""Token datasets over flat binary files: a copy of
``tpunet/data/tokens.py`` (numpy only; the port imports nothing of the JAX
package, so it keeps its own).

Storage format: one flat array of token ids (uint16 when vocab < 65536,
else int32) in a .bin file, produced once by `pack_documents`. Training
reads it through numpy memmap — the OS page cache is the shuffle buffer,
and a (batch, seq+1) slice costs one strided gather, no Python-loop
tokenization anywhere near the step loop.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np


def pack_documents(
    docs: Iterator[list[int] | np.ndarray],
    path: str,
    *,
    vocab: int,
    eos_id: int | None = None,
) -> int:
    """Concatenate token documents into a flat .bin at `path` (uint16 if
    vocab fits, else int32), appending `eos_id` after each doc when given.
    Returns the total token count. One-time preprocessing — training never
    re-tokenizes."""
    dtype = np.uint16 if vocab <= (1 << 16) else np.int32
    if eos_id is not None and not 0 <= eos_id < vocab:
        raise ValueError(f"eos_id {eos_id} outside [0, {vocab})")
    total = 0
    with open(path, "wb") as f:
        for doc in docs:
            # Range-check BEFORE the storage-dtype cast — casting first
            # would wrap out-of-range ids into the valid range and pass.
            raw = np.asarray(doc)
            if raw.size and (int(raw.min()) < 0 or int(raw.max()) >= vocab):
                raise ValueError(
                    f"token ids [{int(raw.min())}, {int(raw.max())}] outside "
                    f"[0, {vocab})"
                )
            arr = raw.astype(dtype)
            arr.tofile(f)
            total += arr.size
            if eos_id is not None:
                np.asarray([eos_id], dtype=dtype).tofile(f)
                total += 1
    return total


class TokenDataset:
    """A flat token .bin exposed as fixed-length (seq+1)-token windows.

    Window i covers tokens [i*seq, i*seq + seq + 1): the +1 overlap supplies
    the shifted-by-one labels without a second read. Windows are
    non-overlapping in their first `seq` tokens, so one epoch sees each
    token once as an input position.
    """

    def __init__(self, path: str, seq: int, *, vocab: int):
        dtype = np.uint16 if vocab <= (1 << 16) else np.int32
        size = os.path.getsize(path) // np.dtype(dtype).itemsize
        self._mm = np.memmap(path, dtype=dtype, mode="r", shape=(size,))
        self.seq = seq
        self.vocab = vocab
        self.n_windows = (size - 1) // seq
        if self.n_windows < 1:
            raise ValueError(
                f"{path}: {size} tokens < one {seq}+1-token window"
            )

    def window(self, i: int) -> np.ndarray:
        """(seq+1,) int32 tokens of window i."""
        if not 0 <= i < self.n_windows:
            raise IndexError(i)
        off = i * self.seq
        return np.asarray(self._mm[off : off + self.seq + 1], dtype=np.int32)

    def batch(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(inputs, labels) int32 of shape (len(idx), seq) for window ids
        `idx` — labels are inputs shifted by one inside each window."""
        idx = np.asarray(idx, dtype=np.int64)
        if idx.ndim != 1:
            raise ValueError(f"idx must be 1-D, got shape {idx.shape}")
        if idx.size and (idx.min() < 0 or idx.max() >= self.n_windows):
            raise IndexError(
                f"window ids [{idx.min()}, {idx.max()}] outside "
                f"[0, {self.n_windows})"
            )
        # One vectorized gather for the whole (batch, seq+1) block — the
        # memmap fancy-index reads each window's pages directly, with no
        # per-row Python loop on the training hot path.
        gather = idx[:, None] * self.seq + np.arange(self.seq + 1)
        rows = np.asarray(self._mm[gather], dtype=np.int32)
        return rows[:, :-1], rows[:, 1:]


def token_batches(
    ds: TokenDataset,
    batch: int,
    *,
    rank: int = 0,
    world: int = 1,
    seed: int = 0,
    epochs: int | None = None,
):
    """Yield (inputs, labels) batches of `batch` rows for this rank.

    Index-level dp sharding: each epoch draws ONE shared permutation of all
    windows from `seed` (identical on every rank — no coordination needed),
    then rank r takes positions r, r+world, ... so ranks see disjoint rows
    and together cover the epoch. Trailing windows that don't fill a full
    per-rank batch are dropped (keeps batch shapes fixed).

    epochs=None iterates forever (epoch counter feeds the permutation, so
    order differs every epoch but is reproducible from seed).
    """
    if batch < 1 or world < 1 or not 0 <= rank < world:
        raise ValueError(f"bad batch/rank/world: {batch}/{rank}/{world}")
    per_epoch = ds.n_windows // (batch * world)
    if per_epoch < 1:
        raise ValueError(
            f"{ds.n_windows} windows < one global batch of {batch * world}"
        )
    epoch = 0
    while epochs is None or epoch < epochs:
        order = np.random.default_rng((seed, epoch)).permutation(ds.n_windows)
        mine = order[rank::world]
        for b in range(per_epoch):
            yield ds.batch(mine[b * batch : (b + 1) * batch])
        epoch += 1
