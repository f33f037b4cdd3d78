"""KV-block wire codec for the disaggregated serving tier.

A KV block is one request's prompt K/V: the cached_key / cached_value
prefixes [0:plen] of every layer, in ``generate._kv_leaves`` order,
flattened to ONE f32 vector and encoded with the native wire codec: f32
passthrough, bf16 RNE, or block-scaled int8 (|err| <= amax/254). One encode
call per block, so int8 scale blocks restart per KV block. The bytes are
those of ``tpunet.serve.kv.encode_kv_block`` for the same rows.

The final-position logits ride next to the block as raw f32, never through
the codec, so the first sampled token is exact under every KV codec.
"""

from __future__ import annotations

import math

import numpy as np

from tpunet_torch import transport

#: Wire dtypes a KV block can ship as.
KV_CODECS = ("f32", "bf16", "int8")


def kv_block_elems(shapes: list[tuple]) -> int:
    """Total f32 element count of a KV block with these per-leaf shapes."""
    return sum(int(math.prod(s)) for s in shapes)


def kv_wire_bytes(codec: str, shapes: list[tuple]) -> int:
    """Encoded byte count of a KV block under `codec`."""
    return transport.codec_wire_bytes(codec, kv_block_elems(shapes))


def encode_kv_block(kv_rows: list[np.ndarray], codec: str) -> np.ndarray:
    """Flatten the per-leaf KV prefixes into one f32 vector and encode it
    (one encode call); returns the wire bytes (uint8). Feeds the
    tpunet_codec_* counters like every codec call."""
    if codec not in KV_CODECS:
        raise ValueError(f"unknown KV wire codec {codec!r}")
    flat = np.concatenate(
        [np.ascontiguousarray(b, np.float32).ravel() for b in kv_rows])
    return transport.codec_encode(flat, codec)


def decode_kv_block(wire, codec: str, shapes: list[tuple]) -> list[np.ndarray]:
    """Decode a KV block's wire bytes into per-leaf f32 arrays of `shapes`;
    ValueError when the wire size does not match the shapes."""
    if codec not in KV_CODECS:
        raise ValueError(f"unknown KV wire codec {codec!r}")
    n = kv_block_elems(shapes)
    flat = transport.codec_decode(np.frombuffer(bytes(wire), np.uint8),
                                  codec, n)
    out = []
    off = 0
    for s in shapes:
        m = int(math.prod(s))
        out.append(flat[off:off + m].reshape(s))
        off += m
    return out


def model_signature(model) -> int:
    """Config fingerprint both tiers check at wiring: CRC32C of the model's
    architecture fields (vocab, depth, heads, widths, MLP, compute dtype,
    window). Two tiers of this package agree exactly when their configs
    do; a tier of the JAX package (which hashes its flax repr) gets the
    typed mismatch error. Parameter values are not covered."""
    fields = sorted(model.config().items())
    return transport.crc32c(("tpunet_torch:" + repr(fields)).encode())
