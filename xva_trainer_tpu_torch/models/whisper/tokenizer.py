"""Decode-only byte-level BPE tokenizer for whisper output ids (the port's
copy of ``xva_trainer_tpu/models/whisper/tokenizer.py``).

Token ids → text needs only the vocabulary (no merges). Supports both asset
formats a user's whisper install provides:
- tiktoken ``*.tiktoken``: one ``base64(bytes) rank`` pair per line
  (multilingual.tiktoken / gpt2.tiktoken);
- HuggingFace ``vocab.json``: token-string → id with GPT-2 byte-level
  unicode escaping.
"""
from __future__ import annotations

import base64
import json
import os
from typing import Dict, List, Optional


def _gpt2_byte_decoder() -> Dict[str, int]:
    """Inverse of GPT-2's bytes_to_unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


class BpeDecoder:
    def __init__(self, id_to_bytes: Dict[int, bytes]):
        self.id_to_bytes = id_to_bytes

    @classmethod
    def from_tiktoken(cls, path: str) -> "BpeDecoder":
        table: Dict[int, bytes] = {}
        with open(path, "rb") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                tok, rank = line.split()
                table[int(rank)] = base64.b64decode(tok)
        return cls(table)

    @classmethod
    def from_vocab_json(cls, path: str) -> "BpeDecoder":
        with open(path, encoding="utf8") as f:
            vocab = json.load(f)
        bd = _gpt2_byte_decoder()
        table: Dict[int, bytes] = {}
        for tok, idx in vocab.items():
            try:
                table[int(idx)] = bytes(bd[ch] for ch in tok)
            except KeyError:
                table[int(idx)] = tok.encode("utf8")
        return cls(table)

    @classmethod
    def find(cls, *dirs: str) -> Optional["BpeDecoder"]:
        """Look for tokenizer assets next to the model weights."""
        for d in dirs:
            if not d or not os.path.isdir(d):
                continue
            for name in ("multilingual.tiktoken", "gpt2.tiktoken"):
                p = os.path.join(d, name)
                if os.path.exists(p):
                    return cls.from_tiktoken(p)
            p = os.path.join(d, "vocab.json")
            if os.path.exists(p):
                return cls.from_vocab_json(p)
        return None

    def decode(self, ids: List[int]) -> str:
        data = b"".join(self.id_to_bytes.get(i, b"") for i in ids)
        return data.decode("utf8", errors="replace")
