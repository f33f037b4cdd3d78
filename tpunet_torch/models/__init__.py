"""The Transformer and VGG families, generation (plain and speculative),
continuous batching and int8 weight quantization, ported."""

from tpunet_torch.models.convert import from_flax, to_flax  # noqa: F401
from tpunet_torch.models.generate import (  # noqa: F401
    generate,
    init_cache,
    speculative_generate,
)
from tpunet_torch.models.quant import (  # noqa: F401
    dequantize_kernel,
    quantize_params,
)
from tpunet_torch.models.serve import BatchServer  # noqa: F401
from tpunet_torch.models.transformer import (  # noqa: F401
    QuantDense,
    Transformer,
    init_params,
)
from tpunet_torch.models.vgg import VGG, VGG16, VGG16_CFG, vgg16  # noqa: F401
