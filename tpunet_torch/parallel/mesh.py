"""The port's mesh: named axes over the ranks of one host's processes.

The port of ``tpunet/parallel/mesh.py``. In JAX a mesh device is a chip and
XLA inserts the collectives of an axis from the shardings. On the port a
mesh device is a RANK: a process of ``tpunet_torch.distributed``'s world.
The ranks may share one card (NCCL refuses two ranks on one device; the
tpunet transport does not), and the collectives of an axis are tpunet's
own over TCP (``smap.py``). A mesh of N devices therefore needs N
processes, every one of which builds the same mesh.

A mesh is one HOST's ranks. A JAX process drives its host's chips and its
DCN world is the processes; the port's counterpart of a JAX process is a
host of N ranks, and a world of H·N ranks holds H hosts: host h is ranks
``h·N + np.arange(N)``. At H = 1 the mesh spans the world. At H > 1 each
rank also joins its DCN GROUP: the H ranks at its mesh coordinates, one a
host, in host order. It is the counterpart of the JAX process's DCN world:
while a host mesh is active, ``tpunet_torch.interop``'s ``dcn_*`` calls
run over it (``dcn_comm``, ``n_hosts``, ``host``).

  * ``Mesh``: axis names and sizes, the host's ranks laid out as
    ``h·N + np.arange(N).reshape(sizes)`` (axis order outermost first),
    this rank's coordinates, and one ``Communicator`` for each GROUP: the
    ranks of the host that differ only along a set of axes.
    ``make_named_mesh`` wires a group for every set of axes whose ranks
    number more than one (a tuple such as the data axes ``("dp", "sp")``
    is a group too); at H = 1 the whole mesh is the world communicator
    itself. The DCN group takes the world communicator's wire codec,
    algorithm and traffic class, as the JAX process's DCN tier is the
    world's. Wiring is collective over the world: world rank 0 picks a
    free loopback port for every group of every host and for every DCN
    group, broadcasts them over the world communicator, and every rank
    joins its groups in one fixed order, its DCN group last.
  * ``PartitionSpec`` (``P``): one entry a dim, an axis name, a tuple of
    names, or None.
  * ``shard_params(params, mesh, rules)``: the rules are JAX's own tables
    (path regex over the flax path, spec in flax's layout); each leaf of
    the port's state_dict is matched by its flax path and its spec turned
    into the port's layout (a dense kernel is transposed, a conv kernel is
    OIHW), with JAX's fallback to replication where an axis does not
    divide the dim. It returns (specs, this rank's slices).

``batch_sharding`` and ``replicated`` return the spec alone: there is no
placement to name, a process holds its own block.
"""

from __future__ import annotations

import itertools
import re
import socket
from collections.abc import Sequence

import numpy as np

_active: list = []  # the meshes that axis names resolve against, innermost last


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry a dim, each an axis name,
    a tuple of axis names, or None (not sharded); trailing dims left out
    are not sharded."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _axes(axis) -> tuple:
    """An axis entry (a name, a tuple of names or None) as a tuple."""
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


class Mesh:
    """Named axes over ranks. `devices` is the array of world ranks
    (``h·n + np.arange(n).reshape(sizes)`` from ``make_named_mesh``),
    `rank` this process's world rank. A mesh built directly is a layout
    only (its groups are not wired; one host): ``make_named_mesh`` wires
    them.

    ``with mesh:`` makes it the mesh that axis names resolve against
    (``smap.shard_map`` does the same around its function)."""

    def __init__(self, devices, axis_names: Sequence[str], rank: int = 0):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")
        #: axis name -> size, in axis order (JAX's ``mesh.shape``).
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        self.rank = int(rank)
        where = np.argwhere(self.devices == self.rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not one device of the mesh")
        #: axis name -> this rank's coordinate.
        self.coords = dict(zip(self.axis_names, (int(c) for c in where[0])))
        #: The hosts of the world (each holds one such mesh) and this one.
        self.n_hosts = 1
        self.host = 0
        self._comms: dict = {}
        self._dcn = None
        self._opened: list = []
        self._wired = False

    def __repr__(self) -> str:
        hosts = f", host={self.host} of {self.n_hosts}" if (
            self.n_hosts > 1) else ""
        return f"Mesh({self.shape}, rank={self.rank}{hosts})"

    def __enter__(self) -> "Mesh":
        _active.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _active.remove(self)

    def canonical(self, axes) -> tuple:
        """`axes` (a name or a tuple of names) as a tuple in mesh order,
        checked."""
        axes = _axes(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"unknown mesh axes {unknown}; the mesh has "
                             f"{self.axis_names}")
        if len(set(axes)) != len(axes):
            raise ValueError(f"repeated axis in {axes}")
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in self.canonical(axes)]))

    def axis_index(self, axes) -> int:
        """This rank's index along `axes` (row-major over them in the
        order given, as ``lax.axis_index`` of a tuple)."""
        idx = 0
        for a in _axes(axes):
            self.canonical(a)
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes) -> list[int]:
        """The world ranks of this rank's group along `axes`, in group-rank
        order (row-major over the axes in mesh order)."""
        axes = self.canonical(axes)
        index = tuple(slice(None) if a in axes else self.coords[a]
                      for a in self.axis_names)
        return [int(r) for r in self.devices[index].reshape(-1)]

    def comm(self, axes):
        """The communicator of this rank's group along `axes` (None for a
        group of one: its collectives are the identity)."""
        axes = self.canonical(axes)
        if self.axis_size(axes) == 1:
            return None
        if not self._wired:
            raise RuntimeError(
                f"{self!r} is a layout only: build it with make_named_mesh "
                "(tpunet_torch.distributed initialized) to run collectives "
                "over its axes")
        return self._comms[axes]

    def dcn_comm(self):
        """The communicator of this rank's DCN group: the ranks at its
        coordinates in every host, ranked by host (None at one host)."""
        if self.n_hosts > 1 and not self._wired:
            raise RuntimeError(f"{self!r} is not wired")
        return self._dcn

    def _subsets(self) -> list[tuple]:
        """Every set of axes whose groups hold more than one rank, in one
        fixed order (by size, then mesh order)."""
        out = []
        for k in range(1, len(self.axis_names) + 1):
            for sub in itertools.combinations(self.axis_names, k):
                if self.axis_size(sub) > 1:
                    out.append(sub)
        return out

    def _wire(self, world_comm, host: str) -> None:
        """Join one communicator for each of this rank's groups, then its
        DCN group. Collective over the world: every rank must call it, in
        the same order as every other mesh it builds."""
        from tpunet_torch.collectives import Communicator

        hosts = self.n_hosts
        # At one host a set of axes spanning every rank is the world itself.
        subsets = [s for s in self._subsets()
                   if hosts > 1 or self.axis_size(s) < self.size]
        # Group j of a subset in host h: port h·groups + j, j the index of
        # the rank's coordinates off the subset; then one DCN group a mesh
        # position. Rank 0 picks every port.
        n_groups = [self.size // self.axis_size(s) for s in subsets]
        n_dcn = self.size if hosts > 1 and self.size > 1 else 0
        ports = np.zeros(max(1, hosts * sum(n_groups) + n_dcn),
                         dtype=np.int64)
        if self.rank == 0:
            for i in range(len(ports)):
                ports[i] = _free_port(host)
        if world_comm is not None:
            ports = world_comm.broadcast(ports, 0)
        base = 0
        for sub, n in zip(subsets, n_groups):
            members = self.group(sub)
            others = [a for a in self.axis_names if a not in sub]
            gid = 0
            for a in others:
                gid = gid * self.shape[a] + self.coords[a]
            port = int(ports[base + self.host * n + gid])
            self._comms[sub] = Communicator(
                f"{host}:{port}", members.index(self.rank), len(members))
            self._opened.append(self._comms[sub])
            base += hosts * n
        if n_dcn:
            position = self.rank - self.host * self.size
            self._dcn = Communicator(
                f"{host}:{int(ports[base + position])}", self.host, hosts,
                wire_dtype=world_comm.wire_dtype, algo=world_comm.algo,
                traffic_class=world_comm.traffic_class)
            self._opened.append(self._dcn)
        elif hosts > 1:
            # A mesh of one rank a host: its DCN group is the world.
            self._dcn = world_comm
        for sub in self._subsets():
            self._comms.setdefault(sub, world_comm)
        self._wired = True

    def close(self) -> None:
        """Close the communicators this mesh opened (not the world
        communicator), dropping the DCN group's pending async tickets."""
        import sys

        interop = sys.modules.get("tpunet_torch.interop")
        for c in self._opened:
            if interop is not None and c is self._dcn:
                interop._drop_pending_for(c)
            c.close()
        self._opened.clear()
        self._comms.clear()
        self._dcn = None
        self._wired = False


def _free_port(host: str) -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def active_mesh() -> Mesh:
    """The mesh of the innermost ``with mesh:`` or ``shard_map``."""
    if not _active:
        raise RuntimeError("no active mesh: call inside shard_map or a "
                           "`with mesh:` block")
    return _active[-1]


def make_named_mesh(axis_sizes: dict[str, int], devices=None,
                    host: str = "127.0.0.1") -> Mesh:
    """A mesh with arbitrary named axes, e.g. {"dp": 2, "tp": 2, "sp": 2},
    over the processes of ``tpunet_torch.distributed`` (initialized; a
    mesh of one device needs no world). Axis order is the dict order,
    outermost first. A world of H·n ranks, n the mesh's size, is H hosts:
    rank r is host r // n, at ``np.unravel_index(r % n, sizes)`` of its
    host's mesh, and joins its DCN group (the module docstring). A world
    that n does not divide raises.

    Collective: every rank of the world builds the same meshes in the
    same order. `devices`, JAX's argument, is the world's ranks
    (``range(world)``) if given. `host`: the address the communicators
    listen on (every rank of the world runs on this machine)."""
    from tpunet_torch import distributed

    sizes = tuple(int(s) for s in axis_sizes.values())
    n = int(np.prod(sizes)) if sizes else 1
    if n == 1 and not distributed.is_initialized():
        world, rank, world_comm = 1, 0, None
    else:
        world_comm = distributed.global_communicator()
        world, rank = world_comm.world_size, world_comm.rank
    if devices is not None and list(devices) != list(range(world)):
        raise ValueError("a port mesh's devices are the world's ranks, "
                         f"range({world})")
    if world % n:
        raise ValueError(f"mesh {axis_sizes} of {n} ranks does not divide "
                         f"the world of {world} into hosts")
    h = rank // n
    mesh = Mesh(h * n + np.arange(n).reshape(sizes), tuple(axis_sizes), rank)
    mesh.n_hosts, mesh.host = world // n, h
    mesh._wire(world_comm, host)
    return mesh


def make_mesh(dp: int | None = None, mdl: int = 1, devices=None) -> Mesh:
    """A (dp, mdl) mesh. dp defaults to world / mdl."""
    from tpunet_torch import distributed

    n = distributed.world_size() if distributed.is_initialized() else 1
    if dp is None:
        if n % mdl != 0:
            raise ValueError(f"{n} ranks not divisible by mdl={mdl}")
        dp = n // mdl
    if dp * mdl != n:
        raise ValueError(f"dp({dp}) * mdl({mdl}) != ranks({n})")
    return make_named_mesh({"dp": dp, "mdl": mdl}, devices)


def batch_sharding(mesh: Mesh) -> PartitionSpec:
    """Leading (batch) axis over dp; everything else replicated."""
    del mesh
    return P("dp")


def replicated(mesh: Mesh) -> PartitionSpec:
    del mesh
    return P()


# ---------------------------------------------------------------------------
# Parameter partition rules: list of (path_regex, PartitionSpec) over the
# flax path and in flax's layout, JAX's tables verbatim. First match wins;
# no match = replicated.

def vgg_partition_rules() -> list[tuple[str, PartitionSpec]]:
    """Megatron-style TP for the VGG classifier over the `mdl` axis: fc1
    column-parallel (output dim sharded), fc2 row-parallel (input dim
    sharded, its partial sums all-reduced), head column-parallel. Conv
    kernels stay replicated."""
    return [
        (r".*fc1/kernel", P(None, "mdl")),
        (r".*fc1/bias", P("mdl")),
        (r".*fc2/kernel", P("mdl", None)),
        (r".*head/kernel", P(None, "mdl")),
        (r".*head/bias", P("mdl")),
    ]


def _spec_for_path(path: str, rules) -> PartitionSpec:
    for pattern, spec in rules:
        if re.fullmatch(pattern, path):
            return P(*spec)
    return P()


def flax_path(name: str) -> str:
    """The flax path of a port state_dict name (``convert.py``'s rename)."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


def _flax_order(name: str, ndim: int) -> tuple:
    """The port dims of a leaf in flax's dim order: a dense kernel (or an
    int8 q) is transposed, a conv kernel is OIHW of flax's HWIO."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight" or (leaf == "q" and ndim == 2):
        return (2, 3, 1, 0) if ndim == 4 else tuple(reversed(range(ndim)))
    return tuple(range(ndim))


def leaf_spec(name: str, shape, mesh: Mesh, rules) -> PartitionSpec:
    """The spec of one port leaf, in the port's layout: the first rule
    matching its flax path, replicated when none does or when a spec axis
    does not divide its dim (JAX's fallback)."""
    order = _flax_order(name, len(shape))
    flax_shape = [shape[d] for d in order]
    spec = _spec_for_path(flax_path(name), rules)
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        size = mesh.axis_size(axis)
        if dim >= len(flax_shape) or flax_shape[dim] % size != 0:
            return P()
    entries = list(spec) + [None] * (len(shape) - len(spec))
    port = [None] * len(shape)
    for flax_dim, port_dim in enumerate(order):
        port[port_dim] = entries[flax_dim]
    while port and port[-1] is None:
        port.pop()
    return P(*port)


def local_slices(spec, shape, mesh: Mesh) -> tuple:
    """The index of this rank's block of a tensor of `shape` under
    `spec`: one slice a dim."""
    idx = []
    for dim, n in enumerate(shape):
        axis = spec[dim] if dim < len(spec) else None
        if axis is None:
            idx.append(slice(None))
            continue
        size = mesh.axis_size(axis)
        if n % size:
            raise ValueError(f"dim {dim} of {tuple(shape)} not divisible by "
                             f"{axis}={size}")
        blk = n // size
        i = mesh.axis_index(axis)
        idx.append(slice(i * blk, (i + 1) * blk))
    return tuple(idx)


def shard_params(params: dict, mesh: Mesh, rules=None) -> tuple[dict, dict]:
    """(specs, local) for a port state_dict: `specs` maps each name to its
    PartitionSpec in the port's layout (``leaf_spec``), `local` to this
    rank's block of the leaf (a contiguous copy where it is sharded, the
    leaf itself where it is not; channels-last conv kernels stay so)."""
    import torch

    rules = list(rules) if rules is not None else []
    specs, local = {}, {}
    for name, t in params.items():
        spec = leaf_spec(name, tuple(t.shape), mesh, rules)
        specs[name] = spec
        if any(a is not None for a in spec):
            blk = t[local_slices(spec, t.shape, mesh)]
            fmt = (torch.channels_last if t.dim() == 4
                   and t.is_contiguous(memory_format=torch.channels_last)
                   else torch.contiguous_format)
            local[name] = blk.contiguous(memory_format=fmt)
        else:
            local[name] = t
    return specs, local
