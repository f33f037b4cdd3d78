"""Which rows of a natural-order sequence each rank holds under sequence
parallelism, written apart from the port's own layout code
(`tpunet_torch.parallel.to_zigzag`) so the checks that use it hold that
code to an independent answer. `chip_smoke.py` and the CPU tests' spawned
ranks (`tests/torch_sp_ranks.py`) both cut their references with it."""

from __future__ import annotations

import numpy as np


def shard(x: np.ndarray, world: int, rank: int, zigzag: bool) -> np.ndarray:
    """Rank `rank`'s sequence shard (axis 1) of `x`: the contiguous one, or
    its chunk pair (rank, 2W-1-rank) of the natural order."""
    if zigzag:
        c = x.shape[1] // (2 * world)
        lo, hi = rank * c, (2 * world - 1 - rank) * c
        return np.concatenate([x[:, lo:lo + c], x[:, hi:hi + c]], axis=1)
    s = x.shape[1] // world
    return x[:, rank * s:(rank + 1) * s]
