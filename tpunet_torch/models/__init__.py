"""The Transformer and VGG families, generation (plain and speculative),
continuous batching, int8 weight quantization, MoE and LoRA/QLoRA,
ported."""

from tpunet_torch.models.convert import from_flax, to_flax  # noqa: F401
from tpunet_torch.models.generate import (  # noqa: F401
    generate,
    init_cache,
    speculative_generate,
)
from tpunet_torch.models.lora import (  # noqa: F401
    graft_base,
    lora_mask,
    lora_optimizer,
    merge_lora,
)
from tpunet_torch.models.quant import (  # noqa: F401
    dequantize_kernel,
    quantize_params,
)
from tpunet_torch.models.serve import BatchServer  # noqa: F401
from tpunet_torch.models.transformer import (  # noqa: F401
    LoraDense,
    MoeMlp,
    QuantDense,
    Transformer,
    init_params,
    transformer_partition_rules,
)
from tpunet_torch.models.vgg import VGG, VGG16, VGG16_CFG, vgg16  # noqa: F401
