"""tpunet_torch.data — token datasets and host->device prefetch (the port
of ``tpunet.data`` without the byte tokenizer, a later slice)."""

from tpunet_torch.data.prefetch import prefetch_to_device
from tpunet_torch.data.tokens import TokenDataset, pack_documents, token_batches

__all__ = ["TokenDataset", "pack_documents", "prefetch_to_device",
           "token_batches"]
