"""tpunet_torch — the PyTorch/CUDA port of tpunet for NVIDIA Hopper.

A package beside the JAX reference ``tpunet`` that imports none of it. It
binds the same native transport core (``cpp/`` -> libtpunet.so) through its
own ctypes loader and runs its compute on torch tensors, with a hand-written
CUDA kernel where the JAX package has a Pallas kernel. Layers, bottom up:

- ``_native`` / ``transport`` / ``telemetry`` / ``config`` — the binding,
  multi-stream P2P comms and codec, metrics, serving knobs;
- ``ops``    — flash attention: the CUDA forward kernel and its plain version;
- ``models`` — the Transformer, the decode cache, ``generate`` and the
  continuous-batching ``BatchServer``;
- ``serve``  — the disaggregated prefill/decode tier over the transport.

Entry points run on the GPU unless given ``device="cpu"``.
"""

__version__ = "0.1.0"

from tpunet_torch import config as config  # noqa: F401

__all__ = ["config", "__version__"]
