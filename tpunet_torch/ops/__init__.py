"""tpunet_torch.ops — hand-written CUDA kernels and their plain versions.

``flash_attention`` launches the flash-attention kernels (forward
``csrc/flash_fwd.cu``; backward dQ and dK/dV ``csrc/flash_bwd.cu``) on CUDA
tensors and runs their plain versions on CPU tensors.
``blockwise_cross_entropy`` is the vocab-blocked fused cross-entropy (no
kernel: a loop of matrix products under checkpointing).
"""

from tpunet_torch.ops.flash_attention import (attention_reference,
                                              flash_attention,
                                              flash_attention_bwd,
                                              flash_attention_dkv_plain,
                                              flash_attention_dq_plain,
                                              flash_attention_fwd,
                                              flash_attention_plain)
from tpunet_torch.ops.fused_xent import blockwise_cross_entropy

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_plain",
           "flash_attention_bwd", "flash_attention_dq_plain",
           "flash_attention_dkv_plain", "attention_reference",
           "blockwise_cross_entropy"]
