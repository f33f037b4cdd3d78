"""Byte-level tokenizer: the port of ``tpunet/data/text.py`` (numpy only,
so a copy).

token id = byte value (0..255), with special ids appended ABOVE the byte
range so no byte is ever shadowed (BOS = 256, EOS = 257; vocab = 258).
Lossless on arbitrary UTF-8 (it sees bytes, never codepoints),
deterministic, nothing to train. Pair with ``pack_documents`` for the flat
.bin training path and with ``generate``/``BatchServer`` for inference:

    tok = ByteTokenizer()
    pack_documents((tok.encode(t) for t in texts), "corpus.bin",
                   vocab=tok.vocab, eos_id=tok.eos_id)
    ...
    text = tok.decode(generate(model, params, prompt[None], 64)[0])
"""

from __future__ import annotations

import numpy as np


class ByteTokenizer:
    """Lossless byte-level tokenizer with BOS/EOS above the byte range."""

    def __init__(self, add_bos: bool = False):
        self.bos_id = 256
        self.eos_id = 257
        self.vocab = 258
        self.add_bos = add_bos

    def encode(self, text: str | bytes, *, eos: bool = False) -> np.ndarray:
        """UTF-8 bytes of `text` as int32 ids, optional BOS prefix / EOS
        suffix. (pack_documents appends EOS itself via eos_id — don't
        double up when packing.)"""
        raw = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        ids = np.frombuffer(raw, np.uint8).astype(np.int32)
        parts = []
        if self.add_bos:
            parts.append(np.asarray([self.bos_id], np.int32))
        parts.append(ids)
        if eos:
            parts.append(np.asarray([self.eos_id], np.int32))
        return np.concatenate(parts) if len(parts) > 1 else ids

    def decode(self, ids, *, errors: str = "replace") -> str:
        """ids -> text. Special ids (and any out-of-range id a sampler
        might produce under a larger model vocab) are dropped, not
        crashed on; invalid UTF-8 decodes per `errors`."""
        ids = np.asarray(ids).reshape(-1)
        keep = ids[(ids >= 0) & (ids < 256)].astype(np.uint8)
        return keep.tobytes().decode("utf-8", errors=errors)
