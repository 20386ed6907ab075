"""Text → symbol-id encoding for v2 (FastPitch).

Reference: python/fastpitch1_1/common/text/text_processing.py (TextProcessing):
clean text, optionally swap words for {ARPABET PHONES} with probability p via
CMUdict, encode against the symbol table. CMUdict itself is user-supplied data
(path to cmudict-0.7b); without it we fall back to character-level encoding.
"""
from __future__ import annotations

import os
import random
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from .cleaners import english_cleaners
from .symbols import get_pad_idx, get_symbols

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")
_words_re = re.compile(r"([a-zA-Z']+|[^a-zA-Z']+)")


class CMUDict:
    """Minimal CMUdict reader: WORD  PH0 PH1 ... (with (2) alternates)."""

    def __init__(self, path: Optional[str] = None):
        self.entries: Dict[str, List[str]] = {}
        if path and os.path.exists(path):
            with open(path, encoding="latin-1") as f:
                for line in f:
                    if not line or line.startswith((";;;", "##")):
                        continue
                    parts = line.strip().split("  ")
                    if len(parts) != 2:
                        continue
                    word = parts[0]
                    if word.endswith(")"):  # alternate pronunciation
                        continue
                    self.entries[word.lower()] = parts[1].split(" ")

    def lookup(self, word: str) -> Optional[List[str]]:
        return self.entries.get(word.lower())


class TextProcessor:
    def __init__(
        self,
        symbol_set: str = "english_basic",
        p_arpabet: float = 0.0,
        cmudict_path: Optional[str] = None,
        seed: int = 1234,
        cleaner: str = "english_cleaners_v2",
    ):
        self.symbols = get_symbols(symbol_set)
        self.pad_idx = get_pad_idx(symbol_set)
        self.id_by_symbol = {s: i for i, s in enumerate(self.symbols)}
        self.p_arpabet = p_arpabet
        self.cmudict = CMUDict(cmudict_path)
        self.rng = random.Random(seed)
        if cleaner == "english_cleaners_v2":
            # the reference trains with english_cleaners_v2
            # (fastpitch1_1/xva_train.py:308): adds datestime,
            # letters+numbers, and acronym->{ARPA} spelling
            from .cleaners_v2 import english_cleaners_v2

            self.cleaner = english_cleaners_v2
        else:
            self.cleaner = english_cleaners

    # -- encoding --

    def _symbols_to_ids(self, syms: Sequence[str]) -> List[int]:
        return [self.id_by_symbol[s] for s in syms if s in self.id_by_symbol and s != "_"]

    def _arpabet_ids(self, phones: Sequence[str]) -> List[int]:
        return self._symbols_to_ids(["@" + p for p in phones])

    def encode(self, text: str) -> np.ndarray:
        """Text (+ optional {ARPA} spans + dict-based phoneme mix) → ids.

        Plain segments are cleaned first (the v2 cleaner may itself introduce
        {ARPA} spans for acronyms), then the combined string is re-parsed for
        braces — cleaners never run inside braces, as in the reference
        TextProcessing."""
        def split_braces(s: str):
            out = []
            while s:
                m = _curly_re.match(s)
                if m:
                    if m.group(1):
                        out.append(("plain", m.group(1)))
                    out.append(("arpa", m.group(2)))
                    s = m.group(3)
                else:
                    out.append(("plain", s))
                    break
            return out

        segments = []
        for kind, content in split_braces(text):
            if kind == "arpa":
                segments.append((kind, content))
            else:
                # the v2 cleaner may itself emit {ARPA} spans (acronyms)
                segments.extend(split_braces(self.cleaner(content)))

        ids: List[int] = []
        for kind, content in segments:
            if kind == "arpa":
                ids += self._arpabet_ids(content.upper().split())
            else:
                ids += self._encode_plain(content)
        return np.asarray(ids, dtype=np.int32)

    def _encode_plain(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in _words_re.findall(text):
            if (
                self.p_arpabet > 0
                and token[0].isalpha()
                and self.rng.random() < self.p_arpabet
            ):
                phones = self.cmudict.lookup(token)
                if phones:
                    ids += self._arpabet_ids(phones)
                    continue
            ids += self._symbols_to_ids(list(token))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(
            self.symbols[i] if not self.symbols[i].startswith("@") else " " + self.symbols[i]
            for i in ids
        )
