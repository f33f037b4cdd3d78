"""Parallelism layer of the port: meshes, sharding rules, and the DP/TP/SP
and pipeline building blocks, in two tiers.

In-pod (the port of JAX's ``shard_map`` tier): a mesh device is a RANK, a
process of ``tpunet_torch.distributed``'s world, and the ranks may share
one card, so a mesh of N devices needs N processes. ``mesh.py`` lays the
ranks out over named axes and wires one tpunet communicator a group of
ranks along a set of axes; ``smap.py`` runs ``shard_map`` over the ranks'
own blocks and the differentiable collectives over an axis (psum, pvary,
ppermute, all_to_all, all_gather, psum_scatter). On them: ``ring_attention``,
``zigzag_ring_attention`` and ``ulysses_attention`` with their
``*_self_attention`` entry points, and ``gpipe``. Every entry point takes
and returns the rank's own block where JAX's takes global arrays.

Across processes (the DCN tier, through ``tpunet_torch.interop``):
``dcn_ring_attention``, ``dcn_zigzag_attention`` and
``dcn_ulysses_attention``, inference paths.
"""

from tpunet_torch.parallel.dcn_ring_attention import (  # noqa: F401
    dcn_ring_attention,
    dcn_zigzag_attention,
)
from tpunet_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    P,
    PartitionSpec,
    batch_sharding,
    make_mesh,
    make_named_mesh,
    replicated,
    shard_params,
    vgg_partition_rules,
)
from tpunet_torch.parallel.pipeline import (  # noqa: F401
    gpipe,
    stack_stage_params,
)
from tpunet_torch.parallel.ring_attention import (  # noqa: F401
    causal_block_mode,
    ring_attention,
    ring_self_attention,
)
from tpunet_torch.parallel.smap import (  # noqa: F401
    shard,
    shard_map,
    unshard,
)
from tpunet_torch.parallel.ulysses import (  # noqa: F401
    dcn_ulysses_attention,
    ulysses_attention,
    ulysses_self_attention,
)
from tpunet_torch.parallel.zigzag_attention import (  # noqa: F401
    from_zigzag,
    to_zigzag,
    zigzag_chunk_order,
    zigzag_positions,
    zigzag_ring_attention,
    zigzag_self_attention,
)
