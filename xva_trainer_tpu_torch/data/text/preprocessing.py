"""Multilingual text → xVAARPAbet-id front end (31 languages): a copy of the
JAX package's ``data/text/preprocessing.py``.

Functional parity with the reference pipeline
(python/xvapitch/text/text_preprocessing.py:87-1521), rebuilt as one
data-driven processor instead of 31 subclasses:

- pronunciation dicts (.txt ARPAbet / .json xvadict) with the English
  CMUdict symbol remap (:587-622), custom dicts taking priority (:201);
- brace-aware ``dict_replace`` word → {ARPABET} substitution (:201-263);
- on-disk G2P caches in the reference's ``word|ipa`` format (:279-303),
  fed through ``ipa_to_xvaarpabet``; optional live G2P backends can be
  registered (eSpeak/epitran equivalents), plus the built-in rule G2P for
  Wolof (:1013-1087);
- English number normalization (en_numbers.py semantics), Romanian number
  words, per-language abbreviation expansion;
- heteronym resolution from the h2p dict (DEFAULT/VERB) with a light
  verb-context heuristic standing in for the reference's nltk POS tagger;
- the exact ``text_to_sequence`` contract: brace/punctuation separation,
  ``manual_phone_replacements``, '#' comment cut, optional ``<PAD>``-blank
  interleave (index len(ALL_SYMBOLS)-2) (:478-537).

The user's language assets (dicts/, g2p_cache/) are consumed from a
``base_dir`` laid out like the reference's ``python/xvapitch/text``; the
shipped tiers are this package's own ``assets/`` (dicts/*.gz,
g2p_cache/*.gz, heteronyms.json), found relative to this file.
"""
from __future__ import annotations

import codecs
import json
import os
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .ipa import ipa_to_xvaarpabet
from .symbols import xva_symbols
from .en_numbers_v3 import normalize_numbers as en_normalize_numbers

PUNCTUATION = [".", ",", "!", "?", "-", ";", ":", "—"]
MANUAL_PHONE_REPLACEMENTS = {"AX0": "AX"}

# CMUdict carries symbols the shipped models were never trained on
# (reference EnglishTextPreprocessor.post_process_dict :587-622)
CMU_ARPABET_REMAP = {
    "YO": "IY0 UW0", "UH": "UH0", "AR": "R", "EY": "EY0", "A": "AA0",
    "AW": "AW0", "X": "K S", "CX": "K HH", "AO": "AO0", "PF": "P F",
    "AY": "AY0", "OE": "OW0 IY0", "IY": "IY0", "EH": "EH0", "OY": "OY0",
    "IH": "IH0", "H": "HH",
}

EN_ABBREVIATIONS = [
    ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
    ("jr", "junior"), ("maj", "major"), ("drs", "doctors"),
    ("rev", "reverend"), ("lt", "lieutenant"), ("sgt", "sergeant"),
    ("capt", "captain"), ("esq", "esquire"), ("ltd", "limited"),
    ("col", "colonel"), ("ft", "fort"),
]

FR_ABBREVIATIONS = [
    ("M", "monsieur"), ("Mlle", "mademoiselle"), ("Mlles", "mesdemoiselles"),
    ("Mme", "Madame"), ("Mmes", "Mesdames"), ("N.B", "nota bene"),
    ("p.c.q", "parce que"), ("Pr", "professeur"), ("qqch", "quelque chose"),
    ("rdv", "rendez-vous"), ("no", "numéro"), ("adr", "adresse"),
    ("dr", "docteur"), ("st", "saint"), ("jr", "junior"), ("sgt", "sergent"),
    ("capt", "capitain"), ("col", "colonel"), ("av", "avenue"),
    ("av. J.-C", "avant Jésus-Christ"), ("apr. J.-C", "après Jésus-Christ"),
    ("boul", "boulevard"), ("c.-à-d", "c’est-à-dire"), ("etc", "et cetera"),
    ("ex", "exemple"), ("excl", "exclusivement"),
]

# (dict file, cache backend, cache file, abbreviations, flags)
# mirrors the reference factory table (:1523-1807)
LANGS: Dict[str, Dict] = {
    "am": dict(name="Amharic", dicts=[], cache="epitran/epitran_cache_am.txt"),
    "ar": dict(name="Arabic", dicts=["arabic.txt"],
               cache="espeak/espeak_cache_ar.txt"),
    "da": dict(name="Danish", dicts=["danish.txt"],
               cache="espeak/espeak_cache_da.txt"),
    "de": dict(name="German", dicts=["german.txt"],
               cache="espeak/espeak_cache_de.txt"),
    "el": dict(name="Greek", dicts=["greek.txt"],
               cache="espeak/espeak_cache_el.txt"),
    "en": dict(name="English", dicts=["cmudict.txt"],
               custom_dicts=["xvadict-elder_scrolls.json"],
               cache="espeak/espeak_cache_en.txt",
               abbreviations=EN_ABBREVIATIONS, numbers="en",
               remap_cmu=True, heteronyms=True, translit=True),
    "es": dict(name="Spanish", dicts=["spanish.txt"],
               cache="espeak/espeak_cache_es.txt"),
    "fi": dict(name="Finnish", dicts=["finnish.txt"],
               cache="espeak/espeak_cache_fi.txt"),
    "fr": dict(name="French", dicts=["french.txt"],
               cache="espeak/espeak_cache_fr.txt",
               abbreviations=FR_ABBREVIATIONS),
    "ha": dict(name="Hausa", dicts=[], cache="epitran/epitran_cache_ha.txt"),
    "hi": dict(name="Hindi", dicts=["hindi.txt"],
               cache="espeak/espeak_cache_hi.txt"),
    "hu": dict(name="Hungarian", dicts=["hungarian.txt"],
               cache="espeak/espeak_cache_hu.txt"),
    "it": dict(name="Italian", dicts=["italian.txt"],
               cache="espeak/espeak_cache_it.txt"),
    "jp": dict(name="Japanese", dicts=["japanese.txt"],
               cache="espeak/espeak_cache_jp.txt"),
    "ko": dict(name="Korean", dicts=["korean.txt"],
               cache="espeak/espeak_cache_ko.txt"),
    "la": dict(name="Latin", dicts=["latin.txt"],
               cache="espeak/espeak_cache_la.txt"),
    "mn": dict(name="Mongolian", dicts=["mongolian.txt"],
               cache="epitran/epitran_cache_mn.txt"),
    "nl": dict(name="Dutch", dicts=["dutch.txt"],
               cache="espeak/espeak_cache_nl.txt"),
    "pl": dict(name="Polish", dicts=["polish.txt"],
               cache="espeak/espeak_cache_pl.txt"),
    "pt": dict(name="Portuguese", dicts=["portuguese_br.txt"],
               cache="espeak/espeak_cache_pt.txt"),
    # note: the reference assigns Romanian number wording but never calls it
    # (only English overrides clean_numbers) — parity keeps numbers=None;
    # pass numbers="ro" explicitly to enable ro_normalize_numbers
    "ro": dict(name="Romanian", dicts=["romanian.txt"],
               cache="espeak/espeak_cache_ro.txt"),
    "ru": dict(name="Russian", dicts=["russian.txt"],
               cache="espeak/espeak_cache_ru.txt"),
    "sv": dict(name="Swedish", dicts=["swedish.txt"],
               cache="espeak/espeak_cache_sv.txt"),
    "sw": dict(name="Swahili", dicts=["swahili.txt"],
               cache="espeak/espeak_cache_sw.txt"),
    "th": dict(name="Thai", dicts=["thai.txt"],
               cache="epitran/epitran_cache_th.txt"),
    "tr": dict(name="Turkish", dicts=["turkish.txt"],
               cache="espeak/espeak_cache_tr.txt"),
    "uk": dict(name="Ukrainian", dicts=["ukrainian.txt"],
               cache="espeak/espeak_cache_uk.txt"),
    "vi": dict(name="Vietnamese", dicts=["vietnamese.txt"],
               cache="espeak/espeak_cache_vi.txt"),
    "wo": dict(name="Wolof", dicts=[], cache="g2p_cache_wo.txt", wolof=True),
    "yo": dict(name="Yoruba", dicts=["yoruba.txt"],
               cache="epitran/epitran_cache_yo.txt"),
    "zh": dict(name="Chinese", dicts=[], cache="g2pc_cache_zh.txt",
               pinyin=True),
}


# pinyin initials (reference ChineseTextPreprocessor.split_pinyin :1115-1130)
_PINYIN_INITIALS = ["zh", "ch", "sh", "b", "p", "m", "f", "d", "t", "n", "l",
                    "g", "k", "h", "z", "c", "s", "r", "j", "q", "x"]

# pinyin initials that are not themselves vocab symbols map to ARPAbet
# (reference pinyin_to_arpabet_mappings, ipa_to_xvaarpabet.py:105-112)
PINYIN_TO_ARPABET = {"C": "TS", "E": "EH0", "H": "HH", "J": "ZH", "Q": "K",
                     "X": "S"}

_CJK_PUNCT = {"\u3002": ".", "\uff0c": ",", "\uff01": "!", "\uff1f": "?",
              "\uff1a": ":", "\uff1b": ";", "\u3001": ",", "\u201c": '"',
              "\u201d": '"', "\uff08": "(", "\uff09": ")"}


def split_pinyin(pinyin: str) -> list:
    """'zhang1' → ['ZH', 'ANG1'] (reference split_pinyin :1115-1130)."""
    pinyin = pinyin.lower()
    out = []
    for ss in _PINYIN_INITIALS:
        if pinyin.startswith(ss):
            out.append(ss.upper())
            pinyin = pinyin[len(ss):]
            break
    out.append(pinyin.upper())
    return out


def pinyin_symbols(g2p_out: str) -> list:
    """Cached g2pC pinyin ('ni3 hao3') → vocab symbols ['N','I3','H','AO3']
    (reference post_process_pinyin_symbs :1133-1155)."""
    out = []
    for symb in g2p_out.split(" "):
        if symb:
            out.extend(split_pinyin(symb))
    return out


def _ascii_translit(text: str) -> str:
    """unidecode-lite: strip combining marks on latin letters (the English
    processor transliterates non-English letters, reference :654)."""
    import unicodedata

    out = []
    for ch in text:
        if ord(ch) < 128:
            out.append(ch)
            continue
        d = unicodedata.normalize("NFKD", ch)
        stripped = "".join(c for c in d if not unicodedata.combining(c))
        out.append(stripped if all(ord(c) < 128 for c in stripped) else ch)
    return "".join(out)


def wolof_g2p(word: str) -> str:
    """Rule-based Wolof orthography → IPA — an EXACT mirror of the reference
    WolofTextPreprocessor.custom_g2p_fn (:1025-1087), including its quirks:
    the (?!:) lookaheads use an ASCII colon, so they also rewrite the vowel
    inside 'aː'/'eː' (aː→ɐː etc.), and the final lossy folds turn ŋ→n."""
    word = word.lower()
    # lossy
    word = word.replace("à", "a").replace("ó", "o")
    word = word.replace("aa", "aː")
    word = re.sub("a(?!:)", "ɐ", word)
    word = word.replace("bb", "bː")
    word = word.replace("cc", "cːʰ")
    word = word.replace("dd", "dː")
    word = word.replace("ee", "ɛː")
    word = word.replace("ée", "eː")
    word = word.replace("ëe", "əː")
    word = re.sub("e(?!:)", "ɛ", word)
    word = re.sub("ë(?!:)", "ə", word)
    word = word.replace("gg", "gː")
    word = word.replace("ii", "iː")
    word = word.replace("jj", "ɟːʰ")
    word = re.sub("j(?!:)", "ɟ", word)
    word = word.replace("kk", "kːʰ")
    word = word.replace("ll", "ɫː")
    word = word.replace("mb", "m̩b")
    word = word.replace("mm", "mː")
    word = word.replace("nc", "ɲc")
    word = word.replace("nd", "n̩d")
    word = word.replace("ng", "ŋ̩g")
    word = word.replace("nj", "ɲɟ")
    word = word.replace("nk", "ŋ̩k")
    word = word.replace("nn", "nː")
    word = word.replace("nq", "ɴq")
    word = word.replace("nt", "n̩t")
    word = word.replace("ññ", "ɲː")
    word = word.replace("ŋŋ", "ŋː")
    word = re.sub("ñ(?!:)", "ɲ", word)
    word = word.replace("oo", "oː")
    word = word.replace("o", "ɔ")
    word = word.replace("pp", "pːʰ")
    word = word.replace("rr", "rː")
    word = word.replace("tt", "tːʰ")
    word = word.replace("uu", "uː")
    word = word.replace("ww", "wː")
    word = word.replace("yy", "jː")
    word = word.replace("y", "j")
    # lossy
    word = word.replace("é", "e")
    word = word.replace("ë", "e")
    word = word.replace("ñ", "n")
    word = word.replace("ŋ", "n")
    return word


def _ro_number_words(n: int) -> str:
    """Romanian cardinal words (reference ro_numbers.py generateWords role)."""
    if n < 0:
        return "minus " + _ro_number_words(-n)
    ones = ["zero", "unu", "doi", "trei", "patru", "cinci", "șase", "șapte",
            "opt", "nouă"]
    teens = ["zece", "unsprezece", "doisprezece", "treisprezece",
             "paisprezece", "cincisprezece", "șaisprezece", "șaptesprezece",
             "optsprezece", "nouăsprezece"]
    if n < 10:
        return ones[n]
    if n < 20:
        return teens[n - 10]
    if n < 100:
        t, r = divmod(n, 10)
        tens_names = {2: "douăzeci", 3: "treizeci", 4: "patruzeci",
                      5: "cincizeci", 6: "șaizeci", 7: "șaptezeci",
                      8: "optzeci", 9: "nouăzeci"}
        return tens_names[t] + (f" și {ones[r]}" if r else "")
    if n < 1000:
        h, r = divmod(n, 100)
        if h == 1:
            head = "o sută"
        elif h == 2:
            head = "două sute"
        else:
            head = f"{ones[h]} sute"
        return head + (f" {_ro_number_words(r)}" if r else "")
    if n < 1_000_000:
        th, r = divmod(n, 1000)
        if th == 1:
            head = "o mie"
        elif th == 2:
            head = "două mii"
        else:
            head = f"{_ro_number_words(th)} mii"
        return head + (f" {_ro_number_words(r)}" if r else "")
    mi, r = divmod(n, 1_000_000)
    head = "un milion" if mi == 1 else f"{_ro_number_words(mi)} milioane"
    return head + (f" {_ro_number_words(r)}" if r else "")


def ro_normalize_numbers(text: str) -> str:
    return re.sub(r"\d+", lambda m: _ro_number_words(int(m.group(0))), text)


class XvaTextPreprocessor:
    """One processor per language; see module docstring."""

    def __init__(
        self,
        lang: str = "en",
        base_dir: Optional[str] = None,
        add_blank: bool = True,
        g2p_backend: Optional[Callable[[str], str]] = None,
        use_heteronyms: bool = True,
    ):
        if lang not in LANGS:
            raise ValueError(f"unknown language {lang!r}")
        self.lang = lang
        self.spec = LANGS[lang]
        self.base_dir = base_dir
        self.add_blank = add_blank
        self.symbols = xva_symbols()
        self.g2p_backend = g2p_backend  # live eSpeak/epitran equivalent
        if self.spec.get("wolof"):
            self.g2p_backend = lambda w: wolof_g2p(w)
        elif self.g2p_backend is None:
            # auto-wire a live backend when one is available on this machine
            # (espeak-ng on PATH / epitran / pypinyin — reference
            # fill_missing_via_g2p:304-448 always has one); cache misses
            # degrade to dicts+rules otherwise
            from .g2p_backends import make_live_backend

            self.g2p_backend = make_live_backend(lang)

        self.dicts: List[Dict[str, str]] = []
        self.dict_is_custom: List[bool] = []
        self.g2p_cache: Dict[str, str] = {}
        # read-only fallback tier: shipped phonemizations captured from the
        # REAL espeak-ng/epitran backends (the reference's committed
        # g2p_cache tree — genuine binary output, not hand-written). Consulted
        # on user-cache miss; never written, never saved back.
        self.g2p_cache_shipped: Dict[str, str] = {}
        self.g2p_cache_path: Optional[str] = None
        self._g2p_cache_dirty = False

        abbrevs = self.spec.get("abbreviations", [])
        self.re_abbreviations = [
            (re.compile(r"\b%s\." % re.escape(a), re.IGNORECASE), b)
            for a, b in abbrevs
        ]

        self.heteronyms: Dict[str, Dict[str, str]] = {}
        # dictionary tiers: a user-provided <base_dir>/dicts/<name> always
        # wins; otherwise the shipped gzipped lexicon (assets/dicts/) fills
        # in, so dict G2P works on a stock install with no base_dir at all
        # (the reference always has its bundled dicts available,
        # text_preprocessing.py:304-448)
        shipped_dicts = os.path.normpath(os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            "..", "..", "assets", "dicts"))
        for is_custom, key in ((False, "dicts"), (True, "custom_dicts")):
            for d in self.spec.get(key, []):
                cands = ([os.path.join(base_dir, "dicts", d)]
                         if base_dir else [])
                cands.append(os.path.join(shipped_dicts, d + ".gz"))
                for p in cands:
                    if os.path.exists(p):
                        self.load_dict(p, is_custom=is_custom)
                        break
        cache = self.spec.get("cache")
        if base_dir and cache:
            self.load_g2p_cache(os.path.join(base_dir, "g2p_cache", cache))
        if cache:
            # shipped tier (assets/g2p_cache/): makes live-G2P words that the
            # reference ecosystem has seen phonemize identically on a stock
            # install with no espeak-ng binary — the same role as the
            # reference's bundled eSpeak data tree
            # (text_preprocessing.py:304-448). User-cache entries win.
            shipped = os.path.normpath(os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "..", "..",
                "assets", "g2p_cache", os.path.basename(cache) + ".gz"))
            if os.path.exists(shipped):
                self.g2p_cache_shipped = self._load_shipped_g2p_cache(shipped)
        if use_heteronyms and self.spec.get("heteronyms"):
            # user override in base_dir, else the shipped h2p dict
            # (374 DEFAULT/VERB ARPAbet entries — parity data with the
            # reference's lib/_dev/h2p_parser/data/dict.json)
            shipped = os.path.normpath(os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "..", "assets", "heteronyms.json"))
            cands = ([os.path.join(base_dir, "heteronyms.json")]
                     if base_dir else []) + [shipped]
            for cand in cands:
                if os.path.exists(cand):
                    with open(cand, encoding="utf8") as f:
                        self.heteronyms = json.load(f)
                    break

    # ---------------- dictionaries ----------------

    # parsed+remapped lexicons are immutable once loaded — cache them
    # process-wide so repeated preprocessor construction (one per dataset /
    # tool run) doesn't re-parse the 135k-word cmudict each time
    _DICT_CACHE: Dict[tuple, Dict[str, str]] = {}

    def load_dict(self, path: str, is_custom: bool = False):
        key = (os.path.abspath(path), os.path.getmtime(path),
               bool(self.spec.get("remap_cmu")))
        cached = self._DICT_CACHE.get(key)
        if cached is not None:
            self.dicts.append(cached)
            self.dict_is_custom.append(is_custom)
            return
        pron: Dict[str, str] = {}
        inner = path[:-3] if path.endswith(".gz") else path

        def _read_text(p):
            if p.endswith(".gz"):
                import gzip

                with gzip.open(p, "rt", encoding="utf-8") as f:
                    return f.read()
            with codecs.open(p, encoding="utf-8") as f:
                return f.read()

        if inner.endswith(".txt"):
            for line in _read_text(path).split("\n"):
                if line.strip():
                    word = line.split(" ")[0].lower()
                    pron[word] = " ".join(line.split(" ")[1:]).strip().upper()
        elif inner.endswith(".json"):
            data = json.loads(_read_text(path))
            for word, entry in data.get("data", {}).items():
                if entry.get("enabled"):
                    pron[word.lower()] = entry["arpabet"].upper()
        # post_process_dict applies to custom dicts too (reference
        # load_dict:150-158 remaps every dict it loads)
        if self.spec.get("remap_cmu"):
            for word, phones in pron.items():
                for k, v in CMU_ARPABET_REMAP.items():
                    # twice: adjacent replacements share the space separator
                    phones = phones.replace(f" {k} ", f" {v} ")
                    phones = phones.replace(f" {k} ", f" {v} ")
                pron[word] = phones
        self._DICT_CACHE[key] = pron
        self.dicts.append(pron)
        self.dict_is_custom.append(is_custom)

    def dict_replace(self, text: str, custom: bool) -> str:
        """Replace known words with {ARPABET} (reference :201-263)."""
        for di, pron in enumerate(self.dicts):
            if self.dict_is_custom[di] != custom:
                continue
            graphites = re.sub(r"{([^}]*)}", "", text)
            words = (
                (graphites + " ")
                .replace("}", "").replace("{", "").replace(",", "")
                .replace("?", "").replace("!", "").replace(";", "")
                .replace("...", ".").replace(". ", " ").lower().split(" ")
            )
            words = [w.strip() for w in words if w.strip() and w in pron]
            if not words:
                continue
            text = (
                " " + text.replace(",", " ,").replace(".", " .")
                .replace("!", " !").replace("?", " ?") + " "
            )
            for w in words:
                repl = "{" + pron[w] + "}"
                esc = (w.strip().replace(".", r"\.").replace("(", r"\(")
                       .replace(")", r"\)"))
                for _ in range(2):
                    text = re.sub(
                        r"(?<!\{)\b" + esc + r"\b(?![\w\s\(\)]*[\}])",
                        repl, text, flags=re.IGNORECASE,
                    )
            text = (text.replace(" ,", ",").replace(" .", ".")
                    .replace(" !", "!").replace(" ?", "?"))
            text = re.sub(r"^\s+", " ", text) if text.startswith("  ") \
                else re.sub(r"^\s*", "", text)
            text = re.sub(r"\s+$", " ", text) if text.endswith("  ") \
                else re.sub(r"\s*$", "", text)
        return text

    # ---------------- heteronyms ----------------

    _VERB_CUES = {"to", "will", "would", "can", "could", "should", "shall",
                  "may", "might", "must", "did", "do", "does", "don't",
                  "didn't", "doesn't", "i", "we", "they", "you", "please",
                  "cannot", "can't", "won't", "wouldn't", "couldn't",
                  "shouldn't", "he", "she", "it"}
    _NOUN_CUES = {"the", "a", "an", "this", "that", "these", "those", "my",
                  "your", "his", "her", "its", "our", "their", "every",
                  "each", "any", "some", "no", "new", "old", "broken",
                  "world", "of"}
    _ADVERBS = {"quickly", "slowly", "carefully", "really", "just", "now",
                "then", "also", "always", "never", "not", "only", "even"}

    @staticmethod
    def _nltk_tagger():
        """nltk pos_tag when its averaged-perceptron data is installed (the
        reference's h2p parser backend, lib/_dev/h2p_parser); None otherwise
        (e.g. zero-egress images where the tagger data can't be fetched)."""
        try:
            import nltk

            nltk.pos_tag(["test"])  # raises LookupError without the data
            return nltk.pos_tag
        except Exception:
            return None

    def replace_heteronyms(self, text: str) -> str:
        """DEFAULT/VERB choice, matching the reference's nltk-POS-backed h2p
        parser (text_preprocessing.py:201-263 + lib/_dev/h2p_parser): uses
        nltk's tagger when its data is installed, else a rule heuristic
        (verb cues before, determiner/possessive context → noun, adverb
        skipping, X-followed-by-determiner → verb)."""
        if not self.heteronyms:
            return text
        if not hasattr(self, "_pos_tag"):
            self._pos_tag = self._nltk_tagger()
        tokens = text.split(" ")
        bares = [t.strip().lower().strip(".,!?;:\"'") for t in tokens]
        nltk_tags = None
        if self._pos_tag is not None and any(b in self.heteronyms for b in bares):
            try:
                nltk_tags = [t for _, t in self._pos_tag(bares)]
            except Exception:
                nltk_tags = None
        out = []
        for i, tok in enumerate(tokens):
            bare = bares[i]
            entry = self.heteronyms.get(bare)
            if not entry or "{" in tok:
                out.append(tok)
                continue
            if nltk_tags is not None:
                is_verb = nltk_tags[i].startswith("VB")
            else:
                # look back past adverbs for a cue word
                j = i - 1
                while j >= 0 and bares[j] in self._ADVERBS:
                    j -= 1
                prev = bares[j] if j >= 0 else ""
                nxt = bares[i + 1] if i + 1 < len(tokens) else ""
                if prev in self._NOUN_CUES:
                    is_verb = False
                elif prev in self._VERB_CUES:
                    is_verb = True
                elif nxt in {"the", "a", "an", "your", "my", "their", "his",
                             "her", "our", "it", "them", "me", "us"}:
                    # "record the data" — object follows a verb
                    is_verb = True
                else:
                    is_verb = False
            key = "VERB" if (is_verb and "VERB" in entry) else "DEFAULT"
            pron = entry.get(key) or entry.get("DEFAULT")
            # keep trailing punctuation outside the braces
            suffix = tok[len(tok.rstrip(".,!?;:\"'")):]
            out.append("{" + pron + "}" + suffix)
        return " ".join(out)

    # ---------------- G2P cache ----------------

    # shipped caches are immutable — parse each .gz once per process
    _SHIPPED_G2P: Dict[str, Dict[str, str]] = {}

    @classmethod
    def _load_shipped_g2p_cache(cls, path: str) -> Dict[str, str]:
        cached = cls._SHIPPED_G2P.get(path)
        if cached is None:
            import gzip

            entries: Dict[str, str] = {}
            with gzip.open(path, "rt", encoding="utf8") as f:
                for line in f:
                    if "|" in line:
                        word, _, phones = line.partition("|")
                        entries[word.lower().strip()] = phones.strip()
            cached = cls._SHIPPED_G2P[path] = entries
        return cached

    def g2p_lookup(self, word: str) -> Optional[str]:
        """Cached phonemization for ``word`` (already lowercased): the user's
        on-disk cache first, then the shipped real-backend capture."""
        hit = self.g2p_cache.get(word)
        if hit is None:
            hit = self.g2p_cache_shipped.get(word)
        return hit

    def load_g2p_cache(self, path: str):
        self.g2p_cache_path = path
        if not os.path.exists(path):
            return
        with open(path, encoding="utf8") as f:
            for line in f.read().split("\n"):
                if "|" in line:
                    word = line.split("|")[0]
                    phones = "|".join(line.split("|")[1:])
                    self.g2p_cache[word.lower().strip()] = phones.strip()

    def save_g2p_cache(self, path: Optional[str] = None):
        path = path or self.g2p_cache_path
        if not path:
            return
        lines = [f"{k}|{self.g2p_cache[k]}" for k in sorted(self.g2p_cache)]
        with open(path, "w+", encoding="utf8") as f:
            f.write("\n".join(lines))

    # ---------------- G2P fill (reference :304-448) ----------------

    def fill_missing_via_g2p(self, text: str) -> str:
        orig_text = text
        text_parts = text.split("{")
        text_parts2 = [(p.split("}")[1] if "}" in p else p) for p in text_parts]

        phonemised = []
        for part in text_parts2:
            part_phonemes = []
            for word in part.split(" "):
                word = word.strip()
                if not word:
                    continue
                # split punctuation away from the word, preserving order
                sub_parts = [word]
                for punc in [p for p in PUNCTUATION if p in word]:
                    nxt = []
                    for sp in sub_parts:
                        sp = sp.strip()
                        if sp in PUNCTUATION:
                            nxt.append(sp)
                            continue
                        pieces = sp.split(punc)
                        if len(pieces) == 1:
                            nxt.append(pieces[0])
                        else:
                            for pi, piece in enumerate(pieces):
                                nxt.append(piece)
                                if pi < len(pieces) - 1:
                                    nxt.append(punc)
                    sub_parts = nxt

                sub_phonemes = []
                for sp in sub_parts:
                    if sp in PUNCTUATION:
                        sub_phonemes.append(sp)
                        continue
                    sp = (sp.replace('"', "").replace(")", "").replace("(", "")
                          .replace("]", "").replace("[", "").strip())
                    if not sp:
                        continue
                    cached = self.g2p_lookup(sp.lower())
                    if self.spec.get("pinyin"):
                        # zh: cache values are PINYIN (g2pC output); a
                        # whole-phrase miss asks the live backend first
                        # (pypinyin-equivalent of g2pC), then falls back to
                        # per-character lookups (han has no segmentation)
                        if cached is None and self.g2p_backend is not None:
                            try:
                                pin = (self.g2p_backend(sp)
                                       .replace("|", " ").strip())
                            except Exception:
                                pin = ""
                            if pin:
                                cached = self.g2p_cache[sp.lower()] = pin
                                self._g2p_cache_dirty = True
                        if cached is not None:
                            sub_phonemes.append(" ".join(pinyin_symbols(cached)))
                        else:
                            # greedy longest-match against the cache
                            # vocabulary (multi-char words): the role of the
                            # reference's pkuseg segmentation ahead of g2pC
                            # (lib/_dev/pkuseg); per-character is only the
                            # last resort within each match step
                            pos = 0
                            max_w = min(8, len(sp))
                            while pos < len(sp):
                                for w in range(min(max_w, len(sp) - pos), 0, -1):
                                    c = self.g2p_lookup(sp[pos: pos + w].lower())
                                    if c is not None:
                                        sub_phonemes.append(
                                            " ".join(pinyin_symbols(c)))
                                        pos += w
                                        break
                                else:
                                    pos += 1  # unknown char: drop it
                        continue
                    if cached is not None:
                        sub_phonemes.append(" ".join(ipa_to_xvaarpabet(cached)))
                    elif self.g2p_backend is not None:
                        # backend failures (empty stdout, dead binary,
                        # timeout) must neither crash phonemization nor be
                        # cached: an empty cache entry would permanently
                        # silence the word even after the backend recovers
                        try:
                            ipa = self.g2p_backend(sp).replace("|", " ").strip()
                        except Exception:
                            ipa = ""
                        if ipa:
                            self.g2p_cache[sp.lower()] = ipa
                            self._g2p_cache_dirty = True
                            sub_phonemes.append(" ".join(ipa_to_xvaarpabet(ipa)))
                    # cache miss with no backend (or a failed backend call):
                    # drop the word (reference behavior when use_g2p=False)
                part_phonemes.append(" ".join(sub_phonemes))
            phonemised.append(" _ ".join(part_phonemes))

        # persist newly G2P'd words back to the on-disk cache (the reference
        # rewrites the cache file per new word, :400-401; batching per call
        # keeps the same durability at a fraction of the writes)
        if self._g2p_cache_dirty and self.g2p_cache_path:
            try:
                self.save_g2p_cache()
                self._g2p_cache_dirty = False
            except OSError:
                pass  # read-only assets dir: keep the in-memory entries

        text_out = []
        for ppi, phon_part in enumerate(phonemised):
            prefix = ""
            if "}" in text_parts[ppi]:
                if (ppi < len(phonemised) - 1
                        and text_parts[ppi].split("}")[1].startswith(" ")):
                    prefix = text_parts[ppi].split("}")[0] + " _ "
                else:
                    prefix = text_parts[ppi].split("}")[0] + " "
            text_out.append(f"{prefix} {phon_part}")

        text_final = []
        for tpi, tp in enumerate(text_out):
            if tpi != 0 or tp.strip() != "" or not orig_text.startswith("{"):
                text_final.append(tp)
            if (tpi or orig_text.startswith(" ")) and (
                (tpi < len(text_parts2) - 1
                 and text_parts2[tpi + 1].startswith(" "))
                or text_parts2[tpi].endswith(" ")
            ):
                text_final.append("_")

        return (" ".join(text_final).replace("  ", " ").replace("  ", " ")
                .replace(" _ _ ", " _ ").replace(" _ _ ", " _ "))

    # ---------------- cleaning ----------------

    def clean_numbers(self, text: str) -> str:
        mode = self.spec.get("numbers")
        if mode is None:
            return text
        fn = en_normalize_numbers if mode == "en" else ro_normalize_numbers
        # skip {BRACED} regions (reference :624-648)
        final_parts = []
        skip_next = False
        for part in re.split(r"({([^}]*)})", text):
            if part is None:
                continue
            if "{" in part:
                final_parts.append(part)
                skip_next = True
            elif skip_next:
                skip_next = False
            else:
                final_parts.append(fn(part))
        return "".join(final_parts)

    def clean_abbreviations(self, text: str) -> str:
        for regex, repl in self.re_abbreviations:
            text = re.sub(regex, repl, text)
        return text

    @staticmethod
    def collapse_whitespace(text: str) -> str:
        return re.sub(r"\s+", " ", text)

    # ---------------- pipeline ----------------

    def text_to_phonemes(self, text: str) -> str:
        text = text.replace("*", "")
        text = self.collapse_whitespace(text).replace(" }", "}").replace("{ ", "{")
        text = self.clean_numbers(text)
        text = self.clean_abbreviations(text)
        text = self.dict_replace(text, custom=True)
        text = self.replace_heteronyms(text)
        text = self.dict_replace(text, custom=False)
        text = self.fill_missing_via_g2p(text)
        return text

    def text_to_sequence(self, text: str) -> Tuple[List[int], str]:
        if self.spec.get("translit"):
            text = _ascii_translit(text)
        if self.spec.get("pinyin"):
            for k, v in _CJK_PUNCT.items():
                text = text.replace(k, v)
        # separate braces from punctuation (reference :482-499)
        for p in [".", "!", "?", ",", '"', "'", "-", ")"]:
            text = text.replace("}" + p, "} " + p)
        for p in [".", "!", "?", ",", '"', "'", "-", "("]:
            text = text.replace(p + "{", p + " {")

        text = self.text_to_phonemes(text)
        text = self.collapse_whitespace(text).strip()
        phonemes = [
            MANUAL_PHONE_REPLACEMENTS.get(p, p) for p in text.split(" ")
        ]
        sequence: List[int] = []
        for phone in phonemes:
            if phone == "#":  # g2p comment marker — cut the rest
                break
            if phone.strip():
                if phone not in self.symbols and phone in PINYIN_TO_ARPABET:
                    # single-letter pinyin initials map to ARPAbet (reference
                    # pinyin_to_arpabet_mappings, ipa_to_xvaarpabet.py:105)
                    for sub in PINYIN_TO_ARPABET[phone].split(" "):
                        sequence.append(self.symbols.index(sub))
                    continue
                sequence.append(self.symbols.index(phone))
        if self.add_blank:
            blank = len(self.symbols) - 2  # <PAD>
            inter: List[int] = []
            for si, s in enumerate(sequence):
                inter.append(s)
                if si < len(sequence) - 1:
                    inter.append(blank)
            sequence = inter
        cleaned = "|".join(self.symbols[i] for i in sequence)
        return sequence, cleaned

    def cleaned_text_to_sequence(self, text: str) -> List[int]:
        text = self.collapse_whitespace(text).strip()
        return [self.symbols.index(p) for p in text.split(" ")]

    def sequence_to_text(self, sequence: Sequence[int]) -> List[str]:
        return [self.symbols[i] for i in sequence]


_PROCESSORS: Dict[Tuple, XvaTextPreprocessor] = {}


def get_text_preprocessor(
    lang: str, base_dir: Optional[str] = None, **kw
) -> XvaTextPreprocessor:
    """Factory with per-(lang, base_dir) caching (reference :1523-1807)."""
    key = (lang, base_dir, tuple(sorted(kw.items())))
    if key not in _PROCESSORS:
        _PROCESSORS[key] = XvaTextPreprocessor(lang, base_dir, **kw)
    return _PROCESSORS[key]
