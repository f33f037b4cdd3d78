"""tpunet_torch.ops — hand-written CUDA kernels and their plain versions.

``flash_attention`` launches the flash-attention forward kernel
(``csrc/flash_fwd.cu``) on CUDA tensors and runs ``attention_reference`` on
CPU tensors.
"""

from tpunet_torch.ops.flash_attention import (attention_reference,
                                              flash_attention,
                                              flash_attention_fwd,
                                              flash_attention_plain)

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_plain",
           "attention_reference"]
