"""Parallelism layer of the port: sequence parallelism across processes.

The port of ``tpunet/parallel`` so far holds its cross-process (DCN) tier,
which rides the tpunet transport between processes through
``tpunet_torch.interop``: ring attention with its contiguous and zigzag
schedules (``dcn_ring_attention``, ``dcn_zigzag_attention``), Ulysses
attention over the all-to-all (``dcn_ulysses_attention``), and the zigzag
layout's helpers.

The in-pod tier waits for the port's mesh (ROADMAP A.6b): ``make_mesh``,
``make_named_mesh``, ``batch_sharding``, ``replicated``, ``shard_params``
and ``vgg_partition_rules`` (mesh.py), ``ring_attention``,
``ring_self_attention``, ``zigzag_ring_attention``,
``zigzag_self_attention``, ``ulysses_attention``,
``ulysses_self_attention``, and ``gpipe`` with ``stack_stage_params``
(pipeline.py).
"""

from tpunet_torch.parallel.dcn_ring_attention import (  # noqa: F401
    dcn_ring_attention,
    dcn_zigzag_attention,
)
from tpunet_torch.parallel.ring_attention import (  # noqa: F401
    causal_block_mode,
)
from tpunet_torch.parallel.ulysses import dcn_ulysses_attention  # noqa: F401
from tpunet_torch.parallel.zigzag_attention import (  # noqa: F401
    from_zigzag,
    to_zigzag,
    zigzag_chunk_order,
    zigzag_positions,
)
