"""Workloads that drive the transport: the port of ``tpunet/workloads``.

  moe  Mixture-of-Experts dispatch/combine over the typed AllToAll:
       Zipf-skewed top-1 expert routing (TPUNET_MOE_SKEW) and
       capacity-bounded packing, one expert shard per rank.

The pipeline-stage workload (``workloads/pipeline.py``) waits for the
port's pipeline parallelism (ROADMAP A.11b, beside A.6).
"""

from tpunet_torch.workloads.moe import (MoeDispatcher, route_tokens,
                                        zipf_weights)

__all__ = ["MoeDispatcher", "route_tokens", "zipf_weights"]
