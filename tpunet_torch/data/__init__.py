"""tpunet_torch.data — token datasets, host->device prefetch and the byte
tokenizer (the port of ``tpunet.data``)."""

from tpunet_torch.data.prefetch import prefetch_to_device
from tpunet_torch.data.text import ByteTokenizer
from tpunet_torch.data.tokens import TokenDataset, pack_documents, token_batches

__all__ = ["ByteTokenizer", "TokenDataset", "pack_documents",
           "prefetch_to_device", "token_batches"]
