"""Workloads that drive the transport: the port of ``tpunet/workloads``.

  moe       Mixture-of-Experts dispatch/combine over the typed AllToAll:
            Zipf-skewed top-1 expert routing (TPUNET_MOE_SKEW) and
            capacity-bounded packing, one expert shard per rank.
  pipeline  pipeline-parallel stage driver: directed microbatch send/recv
            chains over per-stage P2P links with ticket `after=` ordering.
"""

from tpunet_torch.workloads.moe import (MoeDispatcher, route_tokens,
                                        zipf_weights)
from tpunet_torch.workloads.pipeline import PipelineStage, Ticket

__all__ = ["MoeDispatcher", "PipelineStage", "Ticket", "route_tokens",
           "zipf_weights"]
