"""tpunet_torch — the PyTorch/CUDA port of tpunet for NVIDIA Hopper.

A package beside the JAX reference ``tpunet`` that imports none of it. It
binds the same native transport core (``cpp/`` -> libtpunet.so) through its
own ctypes loader and runs its compute on torch tensors, with a hand-written
CUDA kernel where the JAX package has a Pallas kernel. Layers, bottom up:

- ``_native`` / ``transport`` / ``telemetry`` / ``config`` — the binding,
  multi-stream P2P comms, codec, fault injection and the native goldens;
  metrics, tracing (``profile``, ``merge_traces``) and the flight recorder;
  the whole env-var inventory;
- ``collectives`` / ``distributed`` / ``interop`` — the ring communicator
  on host buffers, its process group, and the DCN collectives on torch
  tensors (CUDA tensors staged through pinned host memory);
- ``ops``    — flash attention: the CUDA forward and backward (dQ, dK/dV)
  kernels and their plain versions; the blockwise fused cross-entropy;
- ``models`` — the Transformer, the decode cache, ``generate`` and the
  continuous-batching ``BatchServer``;
- ``data``   — token datasets, host->device prefetch, the byte tokenizer;
- ``train``  — the data-parallel train step (replicated or ZeRO-1),
  ``fit``, checkpoints and elastic recovery (``run_elastic``);
- ``elastic`` — the churn engine: shrink or grow the world mid-run
  (``ElasticWorld``), scripted by the chaos grammar;
- ``serve``  — the disaggregated prefill/decode tier over the transport,
  with re-admission of recovered decode hosts and live weight updates
  (``WeightPublisher``/``WeightReceiver``: version-pinned hot swap).
- ``parallel`` — sequence parallelism across processes: ring, zigzag and
  Ulysses attention over the DCN collectives;
- ``workloads`` — the MoE dispatcher over the all-to-all and the pipeline
  stage driver over per-stage P2P links.

Entry points run on the GPU unless given ``device="cpu"``.
"""

__version__ = "0.1.0"

from tpunet_torch import config as config  # noqa: F401

__all__ = ["config", "__version__"]
