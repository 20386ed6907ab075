"""English number normalization with the v3 pipeline's semantics
(reference python/xvapitch/text/en_numbers.py — keithito lineage), fully
self-contained (no `inflect`):

- commas stripped from grouped numbers;
- "£N" → "N pounds" (digits expanded later by the plain-number pass);
- "$N[.C]" → "N dollars, C cents" digit form, expanded later;
- decimals read digit-group-wise: "3.14" → "three point fourteen";
- ordinals: "21st" → "twenty-first";
- years 1001-2999: "1984" → "nineteen eighty-four", "1905" →
  "nineteen oh five", "2007" → "two thousand seven", "1900" →
  "nineteen hundred".
"""
from __future__ import annotations

import re

_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALE_NAMES = ["", "thousand", "million", "billion", "trillion",
                "quadrillion", "quintillion"]

_ORDINAL_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _below_100(n: int) -> str:
    if n < 20:
        return _UNITS[n]
    t, u = divmod(n, 10)
    return _TENS[t] + (f"-{_UNITS[u]}" if u else "")


def _below_1000(n: int, andword: str = "") -> str:
    h, r = divmod(n, 100)
    parts = []
    if h:
        parts.append(f"{_UNITS[h]} hundred")
    if r:
        # inflect default inserts "and" between hundreds and the remainder
        if h and andword:
            parts.append(andword)
        parts.append(_below_100(r))
    return " ".join(parts) if parts else "zero"


def number_to_words(n, zero: str = "zero", group: int = 0,
                    andword: str = "") -> str:
    """inflect.number_to_words equivalent for cardinals. andword='' matches
    the reference's cardinal path (_expand_number, en_numbers.py:105);
    andword='and' matches inflect's default used by the ordinal path."""
    n = int(str(n).replace(",", "").strip())
    if n < 0:
        return "minus " + number_to_words(-n, zero=zero, group=group,
                                          andword=andword)
    if group == 2:
        digits = str(n)
        if len(digits) % 2:
            digits = "0" + digits
        pairs = [digits[i:i + 2] for i in range(0, len(digits), 2)]
        words = []
        for p in pairs:
            v = int(p)
            if v == 0:
                words.append(zero + " " + zero if zero == "oh" else "hundred")
            elif v < 10 and p[0] == "0":
                words.append(f"{zero} {_UNITS[v]}")
            else:
                words.append(_below_100(v))
        return " ".join(words)
    if n == 0:
        return zero
    groups = []
    scale = 0
    last_is_sub100 = False
    while n > 0:
        n, r = n // 1000, n % 1000
        if r:
            name = _SCALE_NAMES[scale]
            if scale == 0:
                last_is_sub100 = r < 100
            groups.append(_below_1000(r, andword) + (f" {name}" if name else ""))
        scale += 1
    groups = list(reversed(groups))
    if andword and last_is_sub100 and len(groups) > 1:
        # inflect: "one thousand and five" (no comma before a final <100)
        return ", ".join(groups[:-1]) + f" {andword} " + groups[-1]
    return ", ".join(groups)


def ordinal_words(n: int) -> str:
    # the reference ordinal path goes through inflect's DEFAULT andword
    # ("one hundred and first") — en_numbers.py:91-92
    words = number_to_words(n, andword="and")
    # ordinalize the final word (after the last space or hyphen)
    m = re.search(r"([a-z]+)$", words)
    last = m.group(1)
    if last in _ORDINAL_SPECIAL:
        repl = _ORDINAL_SPECIAL[last]
    elif last.endswith("y"):
        repl = last[:-1] + "ieth"
    elif last == "hundred":
        repl = "hundredth"
    elif last in ("thousand", "million", "billion", "trillion"):
        repl = last + "th"
    else:
        repl = last + "th"
    return words[: m.start(1)] + repl


_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _expand_dollars(m):
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        du = "dollar" if dollars == 1 else "dollars"
        cu = "cent" if cents == 1 else "cents"
        return f"{dollars} {du}, {cents} {cu}"
    if dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_number(m):
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return number_to_words(num, zero="oh", group=2).replace(", ", " ")
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, lambda m: m.group(1).replace(",", ""), text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re,
                  lambda m: m.group(1).replace(".", " point "), text)
    text = re.sub(_ordinal_re, lambda m: ordinal_words(int(
        re.sub(r"[a-z]", "", m.group(0)))), text)
    text = re.sub(_number_re, _expand_number, text)
    return text
