"""Tokenizers: the dependency-free byte-level tokenizer.

The port's own copy of `shellac_tpu/training/tokenizer.py`
(`ByteTokenizer` :19, `get_tokenizer` :104), kept as a copy because the
port imports nothing of the JAX package. UTF-8 bytes are the ids
(0..255), with BOS/EOS/PAD appended above: no vocabulary file, and any
text round-trips exactly.

Not ported yet: `HFTokenizer` and `BPETokenizer` raise
NotImplementedError (they need the `transformers` and `tokenizers`
packages, which the card's host does not have).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np


class ByteTokenizer:
    """UTF-8 bytes as token ids; specials above the byte range."""

    BOS = 256
    EOS = 257
    PAD = 258

    vocab_size = 259

    def encode(self, text: str, *, bos: bool = False,
               eos: bool = False) -> np.ndarray:
        ids: List[int] = list(text.encode("utf-8"))
        if bos:
            ids.insert(0, self.BOS)
        if eos:
            ids.append(self.EOS)
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(int(i) for i in np.asarray(ids).reshape(-1)
                     if int(i) < 256)
        return data.decode("utf-8", errors="replace")

    def token_bytes(self, tid: int):
        """Exact surface bytes of one token (None for specials)."""
        return bytes([tid]) if 0 <= tid < 256 else None

    def encode_documents(
        self, docs: Iterable[str], *, eos_between: bool = True
    ) -> np.ndarray:
        """Concatenate documents into one token stream (EOS-separated)."""
        parts = []
        for d in docs:
            parts.append(self.encode(d))
            if eos_between:
                parts.append(np.asarray([self.EOS], np.int32))
        if not parts:
            return np.zeros((0,), np.int32)
        return np.concatenate(parts)


class HFTokenizer:
    """A local HuggingFace tokenizer directory: not ported yet."""

    def __init__(self, path: str):
        raise NotImplementedError(
            f"HF tokenizers ({path!r}) are not ported yet; use 'byte'")


class BPETokenizer:
    """A trained byte-level BPE file: not ported yet."""

    def __init__(self, path: str):
        raise NotImplementedError(
            f"BPE tokenizers ({path!r}) are not ported yet; use 'byte'")


def get_tokenizer(spec: str = "byte"):
    """"byte"; a BPE .json file or an HF tokenizer dir raises
    NotImplementedError."""
    if spec == "byte":
        return ByteTokenizer()
    if spec.endswith(".json"):
        return BPETokenizer(spec)
    return HFTokenizer(spec)
