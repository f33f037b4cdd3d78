"""A serving tier's process over a tensor-parallel group of ranks.

JAX runs a tier as one process whatever its params' shardings, and
gathers the decode cache to whole kv heads when it exports a KV block.
The port's counterpart of that process is the tp group of a mesh model's
ranks (``Transformer.mesh``, ``tp_axis``; as a mesh is one host's ranks): the
tp-index-0 rank, the *leader*, owns the tier's link or router, and the
other ranks, the *followers*, repeat its device work from what it
broadcasts over the group's communicator (``mesh.comm(tp_axis)``). The
wire, the hello and the model signature stay the single-rank tier's, so
any pairing of a group and a single rank works.

The groups of one mesh (its dp replicas) may serve different tiers, so a
tier's forward must run no collective over another axis: the dense
serving forward runs only the tp axis's, and ``TierGroup.tp_only`` holds
each tier step to that.
"""

from __future__ import annotations

import contextlib

import numpy as np


class TierGroup:
    """This rank's tp group of a mesh model: its index, its size and the
    leader's broadcasts. The communicator is looked up at the first
    collective, so a group over a layout-only mesh still builds."""

    def __init__(self, model):
        self.mesh, self.axis = model.mesh, model.tp_axis
        self.size = self.mesh.axis_size(self.axis)
        self.index = self.mesh.axis_index(self.axis)

    @property
    def leader(self) -> bool:
        return self.index == 0

    @property
    def wired(self) -> bool:
        """False over a layout-only mesh: no follower process exists."""
        return self.mesh._wired

    def bcast(self, arr: np.ndarray) -> np.ndarray:
        """The leader's `arr` on every rank of the group (a follower
        passes a buffer of the same shape and dtype)."""
        comm = self.mesh.comm(self.axis)
        return arr if comm is None else comm.broadcast(arr, 0)

    def gather(self, arr: np.ndarray) -> np.ndarray:
        """(size, *arr.shape): every rank's `arr` in tp order, on every
        rank."""
        comm = self.mesh.comm(self.axis)
        return arr[None] if comm is None else comm.all_gather(arr)

    @contextlib.contextmanager
    def tp_only(self):
        """Raise if the body ran a collective over any axis but the tp
        axis (a dp collective would pair this tier with another)."""
        from tpunet_torch.parallel import smap

        def calls():
            return {k: sum(c["calls"] for c in d.values())
                    for k, d in smap.axis_stats().items() if k != self.axis}

        before = calls()
        yield
        crossed = sorted(k for k, n in calls().items()
                         if n > before.get(k, 0))
        if crossed:
            raise RuntimeError(
                f"a serving tier's step ran collectives over {crossed}: a "
                f"tier group may use only its tp axis {self.axis!r}")


def tier_group(model) -> TierGroup | None:
    """The tp group `model`'s tier runs over, or None for a model off a
    mesh or without a tp axis (each rank holds every weight and serves as
    one process)."""
    if (getattr(model, "mesh", None) is None
            or getattr(model, "tp_axis", None) is None):
        return None
    return TierGroup(model)
