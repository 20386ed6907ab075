"""english_cleaners_v2 — the v2 training-path cleaner semantics
(reference python/fastpitch1_1/common/text/cleaners.py:91-102 composition:
datestime → letters+numbers → numbers → abbreviations → acronym spelling →
lowercase → whitespace).

Acronyms (runs of capitals) are spelled out as {LETTER-ARPA} brace spans the
encoder consumes directly (reference acronyms.py letter table).
"""
from __future__ import annotations

import re

from .cleaners import collapse_whitespace, expand_abbreviations, strip_accents
from .numbers import normalize_numbers

# ---------------- dates / times (reference datestime.py) ----------------

_ampm_re = re.compile(
    r"([0-9]|0[0-9]|1[0-9]|2[0-3]):?([0-5][0-9])?\s*([AaPp][Mm]\b)"
)


def expand_datestime(text: str) -> str:
    def sub(m):
        hour, minute, half = m.group(1), m.group(2) or "00", m.group(3)
        out = hour if int(minute) == 0 else f"{hour} {minute}"
        return out + (" a.m." if half[0].lower() == "a" else " p.m.")

    return _ampm_re.sub(sub, text)


# ------------- letters+numbers / hardware / dimensions ------------------

_hardware_re = re.compile(
    r"([0-9]+(?:[.,][0-9]+)?)(?:\s?)(tb|gb|mb|kb|ghz|mhz|khz|hz|mm)",
    re.IGNORECASE,
)
_HARDWARE = {
    "tb": "terabyte", "gb": "gigabyte", "mb": "megabyte", "kb": "kilobyte",
    "ghz": "gigahertz", "mhz": "megahertz", "khz": "kilohertz", "hz": "hertz",
    "mm": "millimeter",
}
_dimension_re = re.compile(
    r"\b(\d+(?:[.,]\d+)?)\s*[xX]\s*(\d+(?:[.,]\d+)?)\b"
)
_mixed_re = re.compile(
    r"((?:[a-zA-Z]+[0-9]|[0-9]+[a-zA-Z])[a-zA-Z0-9']*)"
)


def _expand_mixed(m) -> str:
    parts = [p for p in re.split(r"(\d+)", m.group(0)) if p != ""]
    # keep ordinal/possessive suffixes glued to their digits (1920s, 20th)
    if len(parts) >= 2 and parts[-1] in ("'s", "s", "th", "nd", "st", "rd") \
            and parts[-2].isdigit():
        parts[-2:] = [parts[-2] + parts[-1]]
    out = []
    for p in parts:
        if p.isdigit() and len(p) < 5:
            # read digit runs pairwise ("747" -> "7 47", "1080" -> "10 80")
            if len(p) > 2 and p[-2] == "0":
                chunks = [p] if p[-1] == "0" else [p[:-2], p[-2], p[-1]]
            elif len(p) % 2 == 0:
                chunks = [p[i:i + 2] for i in range(0, len(p), 2)]
            elif len(p) > 2:
                chunks = [p[0]] + [p[i:i + 2] for i in range(1, len(p), 2)]
            else:
                chunks = [p]
            out.extend(chunks)
        else:
            out.append(p)
    return " ".join(out)


def expand_letters_and_numbers(text: str) -> str:
    def hw(m):
        qty, unit = m.group(1), _HARDWARE[m.group(2).lower()]
        plural = "s" if (not unit.endswith("z")
                         and float(qty.replace(",", "")) > 1) else ""
        return f"{qty} {unit}{plural}"

    text = _hardware_re.sub(hw, text)
    text = _dimension_re.sub(lambda m: f"{m.group(1)} by {m.group(2)}", text)
    return _mixed_re.sub(_expand_mixed, text)


# ---------------- acronym spelling (reference acronyms.py) --------------

LETTER_ARPA = {
    "A": "EY1", "B": "B IY1", "C": "S IY1", "D": "D IY1", "E": "IY1",
    "F": "EH1 F", "G": "JH IY1", "H": "EY1 CH", "I": "AY1", "J": "JH EY1",
    "K": "K EY1", "L": "EH1 L", "M": "EH1 M", "N": "EH1 N", "O": "OW1",
    "P": "P IY1", "Q": "K Y UW1", "R": "AA1 R", "S": "EH1 S", "T": "T IY1",
    "U": "Y UW1", "V": "V IY1", "W": "D AH1 B AH0 L Y UW0", "X": "EH1 K S",
    "Y": "W AY1", "Z": "Z IY1",
}

_acronym_re = re.compile(r"\b([A-Z][A-Z]+)(s?)\b\.?")
# words kept verbatim despite being all-caps (roman numerals etc.)
_ROMAN = re.compile(r"^[IVXLCDM]+$")


def spell_acronyms(text: str) -> str:
    def sub(m):
        word, plural = m.group(1), m.group(2)
        if _ROMAN.match(word) and len(word) <= 4 and word not in ("MIX", "DIM"):
            return m.group(0)
        phones = [LETTER_ARPA[ch] for ch in word if ch in LETTER_ARPA]
        if not phones:
            return m.group(0)
        if plural:
            phones[-1] = phones[-1] + " Z"
        return " ".join("{" + p + "}" for p in phones)

    return _acronym_re.sub(sub, text)


def english_cleaners_v2(text: str) -> str:
    text = strip_accents(text)
    text = expand_datestime(text)
    text = expand_letters_and_numbers(text)
    text = normalize_numbers(text)
    text = expand_abbreviations(text)
    text = spell_acronyms(text)
    text = text.lower()
    text = re.sub(r"/+", " ", text)
    return collapse_whitespace(text).strip()
