"""Live G2P backends for out-of-cache words: a copy of the JAX package's
``data/text/g2p_backends.py``.

The reference fills cache misses at runtime via eSpeak-NG (espeak langs),
epitran (am/ha/mn/th/yo), or g2pC (zh), appending each new word to the on-disk
``word|ipa`` cache (reference
python/xvapitch/text/text_preprocessing.py:304-448, factory :1523-1807).

This module provides the same capability without bundling binaries:

- ``espeak_word_to_ipa``: subprocess call to an ``espeak-ng``/``espeak``
  binary found on PATH (or ``XVA_ESPEAK_BIN``), ``-q --ipa=3 -v <voice>``,
  phoneme separators ``_`` → the pipe separator the reference's wrapper used,
  ``(xx)`` language-switch markers stripped (reference
  ipa_to_xvaarpabet.py:456-485 phonemize_espeak).
- ``epitran`` / ``pypinyin`` backends when those packages are installed.
- ``make_live_backend(lang)``: best available backend for a language, or
  None — the preprocessor then degrades to its caches, dicts and rules.

Backends return IPA with ``|`` between phonemes; the caller caches
``out.replace("|", " ")`` (reference :398-401 stores the same).
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
from typing import Callable, Optional

# espeak voice per language (the reference's lang_code2 constructor args,
# text_preprocessing.py:558-1002)
ESPEAK_VOICES = {
    "ar": "ar", "da": "da", "de": "de", "el": "el", "en": "en-us",
    "es": "es", "fi": "fi", "fr": "fr-fr", "hi": "hi", "hu": "hu",
    "it": "it", "jp": "ja", "ko": "ko", "la": "la", "nl": "nl",
    "pl": "pl", "pt": "pt", "ro": "ro", "ru": "ru", "sv": "sv",
    "sw": "sw", "tr": "tr", "uk": "uk", "vi": "vi",
}

# epitran code per language (reference lang_code2 for the epitran-cache
# languages, text_preprocessing.py:742,764,952,... )
EPITRAN_CODES = {
    "am": "amh-Ethi", "ha": "hau-Latn", "mn": "mon-Cyrl",
    "th": "tha-Thai", "yo": "yor-Latn",
}

_LANG_SWITCH = re.compile(r"\([a-z][a-z]\)")


def find_espeak() -> Optional[str]:
    """Locate the espeak binary: XVA_ESPEAK_BIN env override, else PATH."""
    env = os.environ.get("XVA_ESPEAK_BIN")
    if env and (os.path.exists(env) or shutil.which(env)):
        return env
    for name in ("espeak-ng", "espeak"):
        p = shutil.which(name)
        if p:
            return p
    return None


def espeak_word_to_ipa(word: str, voice: str, binary: str,
                       timeout: float = 10.0) -> str:
    """One word → IPA via the espeak CLI (reference phonemize_espeak
    semantics: --ipa=3 '_' separators → '|', language-switch markers
    stripped).

    Hardened against real espeak-ng 1.50 output quirks:

    - each output line starts with a space and ends with a newline; clause
      breaks produce multiple lines → lines are joined with a space;
    - affricates carry U+0361 combining ties (``t͡ʃ``) and some builds join
      with U+200D; the shipped IPA tables store affricates plain (``tʃ``),
      so both joiners are removed;
    - language-switch markers ``(en)`` appear when the voice switches;
    - a failed run (unknown voice, rc != 0) or empty output returns "" so
      the caller degrades to cache+dict+rules instead of caching garbage.
    """
    out = subprocess.run(
        [binary, "-q", "--ipa=3", "-v", voice, word],
        capture_output=True, timeout=timeout, check=False,
    )
    if out.returncode != 0:
        return ""
    text = out.stdout.decode("utf8", errors="replace")
    text = " ".join(ln.strip() for ln in text.splitlines() if ln.strip())
    text = _LANG_SWITCH.sub("", text)
    text = text.replace("͡", "").replace("‍", "")
    return text.replace("_", "|").strip()


def make_espeak_backend(lang: str) -> Optional[Callable[[str], str]]:
    voice = ESPEAK_VOICES.get(lang)
    binary = find_espeak()
    if not voice or not binary:
        return None

    def backend(word: str) -> str:
        return espeak_word_to_ipa(word, voice, binary)

    return backend


def make_epitran_backend(lang: str) -> Optional[Callable[[str], str]]:
    code = EPITRAN_CODES.get(lang)
    if not code:
        return None
    try:
        import epitran  # optional dependency, not in the base image
    except ImportError:
        return None
    try:
        epi = epitran.Epitran(code)
    except Exception:
        return None
    return lambda word: epi.transliterate(word)


def make_pinyin_backend(lang: str) -> Optional[Callable[[str], str]]:
    """zh: g2pC-equivalent — tone-numbered pinyin ('ni3 hao3'), the format
    the shipped g2pc_cache_zh.txt stores and pinyin_symbols() consumes."""
    if lang != "zh":
        return None
    try:
        from pypinyin import Style, pinyin  # optional dependency
    except ImportError:
        return None

    def backend(word: str) -> str:
        syls = pinyin(word, style=Style.TONE3, neutral_tone_with_five=False)
        return " ".join(s[0] for s in syls if s and s[0])

    return backend


def make_live_backend(lang: str) -> Optional[Callable[[str], str]]:
    """Best available live G2P for a language, else None (degrade to the
    shipped caches + dicts + rules)."""
    for maker in (make_espeak_backend, make_epitran_backend,
                  make_pinyin_backend):
        backend = maker(lang)
        if backend is not None:
            return backend
    return None
