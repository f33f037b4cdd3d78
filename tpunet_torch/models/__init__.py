"""The Transformer and VGG families, generation and continuous batching,
ported."""

from tpunet_torch.models.convert import from_flax, to_flax  # noqa: F401
from tpunet_torch.models.generate import generate, init_cache  # noqa: F401
from tpunet_torch.models.serve import BatchServer  # noqa: F401
from tpunet_torch.models.transformer import (  # noqa: F401
    Transformer,
    init_params,
)
from tpunet_torch.models.vgg import VGG, VGG16, VGG16_CFG, vgg16  # noqa: F401
