"""Port parity of the multilingual text front end: the port's
``data/text/preprocessing.py``, ``g2p_backends.py``, ``pre_cache_g2p`` and
``data/language_manager.py`` against the JAX package's, on the same inputs,
with no tolerance: ids, the cleaned string, cache files byte for byte.

Every processor here has its live backend pinned (``None``, or one fake
``espeak-ng`` script through ``XVA_ESPEAK_BIN``) and its POS tagger pinned
(``None``: the rule heuristic; or one stub tagger given to both), so that a
host with espeak-ng or nltk's tagger data gives the same ids as one without.
The port's shipped tiers are its own copies under
``xva_trainer_tpu_torch/assets``; two tests hold the copies to the JAX
package's files and the files the port opens to the port's directory.
"""
import builtins
import codecs
import gzip
import hashlib
import json
import os
import re
import stat

import numpy as np
import pytest

import xva_trainer_tpu
import xva_trainer_tpu_torch
from xva_trainer_tpu.data import language_manager as jlm
from xva_trainer_tpu.data.text import g2p_backends as jgb
from xva_trainer_tpu.data.text import preprocessing as jpp
from xva_trainer_tpu.train.xvapitch_trainer import pre_cache_g2p as jax_pre_cache_g2p
from xva_trainer_tpu_torch.data import language_manager as plm
from xva_trainer_tpu_torch.data.text import g2p_backends as pgb
from xva_trainer_tpu_torch.data.text import preprocessing as ppp
from xva_trainer_tpu_torch.train.xvapitch_trainer import pre_cache_g2p

JAX_ASSETS = os.path.join(os.path.dirname(xva_trainer_tpu.__file__), "assets")
PORT_ASSETS = os.path.join(os.path.dirname(xva_trainer_tpu_torch.__file__), "assets")
PUNCT = [",", ".", "!", "?", ";", ":", " -", "..."]
NUMBERS = ["3", "12", "21", "105", "1999", "3.14", "2,500", "7th", "$4.50", "£20"]
BRACES = ["{HH AH0 L OW1}", "{K AE1 T}", "{D AO1 G Z}"]
_WORD = re.compile(r"^[^\W\d_]+$")


def pinned(mod, lang, base_dir=None, backend=None, tagger=None, **kw):
    """A fresh processor of ``mod`` with its live backend and POS tagger
    pinned (Wolof keeps its rule G2P, which is not a live backend)."""
    tp = mod.XvaTextPreprocessor(lang, base_dir, **kw)
    if not mod.LANGS[lang].get("wolof"):
        tp.g2p_backend = backend
    tp._pos_tag = tagger
    return tp


def pair(lang, base_dir=None, **kw):
    return pinned(ppp, lang, base_dir, **kw), pinned(jpp, lang, base_dir, **kw)


def outcome(tp, text):
    """``text_to_sequence``'s result, or the error it raises."""
    try:
        return tp.text_to_sequence(text)
    except Exception as e:  # noqa: BLE001 — both packages must fail alike
        return type(e).__name__, str(e)


def tier_words(tp):
    """The words of a processor's tiers (its lexicons and the shipped
    capture) that are letters only, sorted."""
    words = set(tp.g2p_cache_shipped)
    for d in tp.dicts:
        words.update(d)
    return sorted(w for w in words if _WORD.match(w))


def sentences(words, seed, n=6):
    """Seeded sentences from ``words``: mixed case, punctuation, numbers,
    one brace group and a '#' comment in some."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(3, 9))
        toks = [str(w) for w in rng.choice(words, size=k)] if words else ["xyzzy"] * k
        toks = [t.capitalize() if rng.random() < 0.3 else t for t in toks]
        for _ in range(2):
            toks[int(rng.integers(0, len(toks)))] += str(rng.choice(PUNCT))
        if i % 2 == 0:
            toks.insert(int(rng.integers(0, len(toks) + 1)), str(rng.choice(NUMBERS)))
        if i % 3 == 0:
            toks.insert(int(rng.integers(0, len(toks) + 1)), str(rng.choice(BRACES)))
        if i == n - 1:
            toks += ["#", "cut", "here"]
        out.append(" ".join(toks) + str(rng.choice([".", "!", "?", ""])))
    return out


# ---------------- the tables ----------------


def test_tables_match_jax():
    assert ppp.LANGS == jpp.LANGS and len(ppp.LANGS) == 31
    for name in ("PUNCTUATION", "MANUAL_PHONE_REPLACEMENTS", "CMU_ARPABET_REMAP",
                 "EN_ABBREVIATIONS", "FR_ABBREVIATIONS", "PINYIN_TO_ARPABET", "_CJK_PUNCT",
                 "_PINYIN_INITIALS"):
        assert getattr(ppp, name) == getattr(jpp, name), name
    assert pgb.ESPEAK_VOICES == jgb.ESPEAK_VOICES
    assert pgb.EPITRAN_CODES == jgb.EPITRAN_CODES


# ---------------- every language, no base directory ----------------


@pytest.mark.parametrize("lang", sorted(jpp.LANGS))
def test_language_matches_jax(lang):
    """Seeded sentences from the language's shipped tiers (a language with
    none: words that every tier misses, dropped alike) give JAX's ids and
    cleaned string."""
    ours, ref = pair(lang)
    words = tier_words(ref)
    assert tier_words(ours) == words
    seed = sorted(jpp.LANGS).index(lang)
    texts = sentences(words, seed)
    results = [(outcome(ours, t), outcome(ref, t)) for t in texts]
    for t, (a, b) in zip(texts, results):
        assert a == b, (lang, t)
    if words:  # a language with tiers yields tokens
        assert all(isinstance(a[0], list) and a[0] for a, _ in results[:-1]), (lang, results)


# ---------------- a user's base directory ----------------


def _user_base(tmp_path):
    base = tmp_path / "text"
    (base / "dicts").mkdir(parents=True)
    (base / "g2p_cache" / "espeak").mkdir(parents=True)
    # an Italian lexicon that overrides the shipped one, and user caches
    (base / "dicts" / "italian.txt").write_text(
        "casa K AE1 Z AE0\ncane K AE1 N EH0\nrosso R OW1 S S OW0\n", encoding="utf-8")
    (base / "g2p_cache" / "espeak" / "espeak_cache_it.txt").write_text(
        "gatto|ɡ ˈa t t o\nluna|l ˈu n a\n", encoding="utf8")
    (base / "g2p_cache" / "espeak" / "espeak_cache_fr.txt").write_text(
        "bonjour|b ɔ̃ ʒ ˈu ʁ\nchat|ʃ ˈa\nzorblaxe|z ɔ ʁ b l ˈa k s\n", encoding="utf8")
    (base / "heteronyms.json").write_text(json.dumps(
        {"read": {"DEFAULT": "R IY1 D", "VERB": "R EH1 D"},
         "lead": {"DEFAULT": "L EH1 D", "VERB": "L IY1 D"}}), encoding="utf8")
    return str(base)


@pytest.mark.parametrize("lang,texts", [
    ("it", ["Casa e cane, rosso!", "Il gatto sulla luna.", "gatto {K AE1 T} casa"]),
    ("fr", ["Bonjour le chat, zorblaxe!", "Le chat {K AE1 T} mange."]),
    ("en", ["I read the book; you lead.", "They will read it, we lead them.",
            "Dr. Smith read 21 books in 1999."]),
])
def test_base_dir_matches_jax(tmp_path, lang, texts):
    """A base directory whose lexicon overrides the shipped one and that holds
    a user cache (and, for English, a heteronym dictionary) gives JAX's
    results, and both processors read the same tiers."""
    base = _user_base(tmp_path)
    ours, ref = pair(lang, base)
    assert ours.dicts == ref.dicts and ours.g2p_cache == ref.g2p_cache
    assert ours.heteronyms == ref.heteronyms
    for t in texts:
        assert outcome(ours, t) == outcome(ref, t), t
    if lang == "it":
        assert ours.dicts[0] == {"casa": "K AE1 Z AE0", "cane": "K AE1 N EH0",
                                 "rosso": "R OW1 S S OW0"}


# ---------------- English ----------------

EN_TEXTS = [
    "On the 3rd of May, 1999, we paid $4.50 for coffee and £20 for tea.",
    "Mr. and Mrs. Smith met Dr. Jones at St. Paul's; Capt. Kirk, Esq., too.",
    "The value is 3.14, not 2,500 or 1,000,000 -- nor the 21st or 102nd.",
    "Say {HH AH0 L OW1} to the {W ER1 L D}, then stop.",
    "A {K AE1 T}, a dog. Then #the rest is a comment",
    "I will record the record, and they object to the object.",
    "Please read the lead article; the lead pipe will lead nowhere.",
    "We must live with the live wire; my present to you is to present it.",
    "Crème brûlée at the café, naïve façade, jalapeño.",
    "Lydia, it's 1905, 2007, 1900 and 10:30 now!",
    "We will contest the ruling, and they quickly abuse the content.",
    "Close the door; the close call will conduct power to my conduct.",
    "I did object, but the object of the contest will close soon.",
]


@pytest.mark.parametrize("i", range(len(EN_TEXTS)))
def test_english_matches_jax(i):
    """Numbers, abbreviations, braces, '#', transliteration and the heteronym
    heuristic."""
    ours, ref = pair("en")
    assert outcome(ours, EN_TEXTS[i]) == outcome(ref, EN_TEXTS[i])


def test_english_tagger_branch_matches_jax():
    """The nltk branch of ``replace_heteronyms``, with one stub tagger given
    to both packages: every other word a verb."""
    def stub(words):
        return [(w, "VB" if j % 2 else "NN") for j, w in enumerate(words)]

    ours, ref = pair("en", tagger=stub)
    for t in EN_TEXTS[5:8]:
        assert outcome(ours, t) == outcome(ref, t), t
    # the stub decides: the same text reads otherwise under the heuristic
    heuristic, _ = pair("en")
    assert any(outcome(ours, t) != outcome(heuristic, t) for t in EN_TEXTS[5:8])


def test_en_numbers_match_jax():
    from xva_trainer_tpu.data.text.en_numbers_v3 import normalize_numbers as jax_nn
    from xva_trainer_tpu_torch.data.text.en_numbers_v3 import normalize_numbers

    rng = np.random.default_rng(0)
    texts = [f"{n}" for n in rng.integers(0, 10 ** 7, 40)] + [
        f"{n}th" for n in rng.integers(1, 200, 20)] + [
        f"${a}.{b:02d}" for a, b in zip(rng.integers(0, 5000, 10), rng.integers(0, 100, 10))] + [
        f"£{n}" for n in rng.integers(1, 999, 5)] + [
        f"{a}.{b}" for a, b in zip(rng.integers(0, 100, 10), rng.integers(0, 1000, 10))] + [
        "1,234,567", "1001", "2999", "1900", "1905", "2007", "0", "$1", "$0.01", "1st 2nd 3rd"]
    for t in texts:
        assert normalize_numbers(t) == jax_nn(t), t


# ---------------- Wolof, Romanian, Chinese ----------------


def test_wolof_rule_g2p_matches_jax(tmp_path):
    """The rule G2P word for word, and the processor, whose misses it fills
    and writes back to the user's cache, byte for byte."""
    words = ["xamul", "yoon", "ndank", "nanga", "def", "jàmm", "rekk", "ñaari", "ŋaam",
             "bëgg", "ceebu", "jën", "mbokk", "waaw", "yaay", "ndox", "tukki", "kaddu"]
    for w in words + [w.upper() for w in words]:
        assert ppp.wolof_g2p(w) == jpp.wolof_g2p(w), w
    # the last four miss the shipped capture: the rule G2P fills them
    text = "Xamul yoon, ndank ndank! Nanga def? Jàmm rekk. Xamulaay ndankeen, ceebuyaay ñaaroon."
    caches = []
    for name, mod in (("port", ppp), ("jax", jpp)):
        base = tmp_path / name
        (base / "g2p_cache").mkdir(parents=True)
        tp = pinned(mod, "wo", str(base))
        caches.append((outcome(tp, text), (base / "g2p_cache" / "g2p_cache_wo.txt").read_bytes()))
    assert caches[0] == caches[1] and caches[0][1]


@pytest.mark.parametrize("seed", range(3))
def test_ro_numbers_match_jax(seed):
    rng = np.random.default_rng(seed)
    ns = list(rng.integers(0, 100, 20)) + list(rng.integers(100, 10 ** 4, 20)) + list(
        rng.integers(10 ** 4, 10 ** 9, 10)) + [0, 1, 2, 10, 11, 19, 20, 21, 100, 101, 200,
                                              1000, 2000, 1_000_000, 2_000_001]
    for n in ns:
        assert ppp._ro_number_words(int(n)) == jpp._ro_number_words(int(n)), n
    text = " ".join(f"am {n} mere," for n in ns[:10])
    assert ppp.ro_normalize_numbers(text) == jpp.ro_normalize_numbers(text)


ZH_CACHE = "你好|ni3 hao3\n世界|shi4 jie4\n世|shi4\n中国|zhong1 guo2\n去|qu4\n写|xie3\n车|che1\n饿|e4\n"


@pytest.mark.parametrize("text", ["你好，世界。", "你好世", "中国你好世界！", "你好X世界？去写车",
                                  "饿", "{N I3} 你好"])
def test_chinese_matches_jax(tmp_path, text):
    """A temporary ``g2pc_cache_zh.txt``: whole-phrase hits, the longest-match
    fallback, unknown characters, pinyin initials mapped to ARPAbet, CJK
    punctuation."""
    (tmp_path / "g2p_cache").mkdir()
    (tmp_path / "g2p_cache" / "g2pc_cache_zh.txt").write_text(ZH_CACHE, encoding="utf8")
    ours, ref = pair("zh", str(tmp_path))
    assert outcome(ours, text) == outcome(ref, text)
    for s in ("zhang1", "e4", "ni3 hao3", "qu4 xie3"):
        assert ppp.split_pinyin(s) == jpp.split_pinyin(s)
        assert ppp.pinyin_symbols(s) == jpp.pinyin_symbols(s)


@pytest.mark.parametrize("text", ["Crème brûlée", "naïve façade", "Ærø", "Straße", "ĳ ﬁ"])
def test_ascii_translit_matches_jax(text):
    assert ppp._ascii_translit(text) == jpp._ascii_translit(text)


# ---------------- live G2P through one fake espeak ----------------

FAKE_IPA = {"fr-fr": " b_ɔ̃_ʒ_ˈu_ʁ", "it": " p_a_ɾ_ˈɔ_l_a", "ro": " k_ˈa_s_ə",
            "en-us": " t͡ʃ_ˈɜː_t͡ʃ"}


@pytest.fixture
def fake_espeak(tmp_path, monkeypatch):
    """A stand-in espeak-ng: canned IPA a voice in the real output's shape
    (a leading space, combining ties, '_' separators), rc 1 for an unknown
    voice."""
    lines = ["#!/bin/sh", 'voice=""',
             'while [ $# -gt 1 ]; do case "$1" in -v) voice="$2"; shift 2;;'
             ' *) shift;; esac; done']
    for voice, ipa in FAKE_IPA.items():
        lines.append(f'[ "$voice" = "{voice}" ] && echo "{ipa}" && exit 0')
    lines.append("exit 1")
    p = tmp_path / "espeak-ng"
    p.write_text("\n".join(lines) + "\n")
    p.chmod(p.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("XVA_ESPEAK_BIN", str(p))
    return str(p)


def _tree_digest(root):
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            p = os.path.join(d, f)
            st = os.stat(p)
            h.update(f"{os.path.relpath(p, root)}:{st.st_size}:{st.st_mtime_ns}".encode())
    return h.hexdigest()


def _empty_base(path):
    (path / "g2p_cache" / "espeak").mkdir(parents=True)
    return str(path)


def test_live_backends_match_jax(fake_espeak):
    assert pgb.find_espeak() == jgb.find_espeak() == fake_espeak
    for lang in ("fr", "it", "ro", "en", "xx"):
        voice = pgb.ESPEAK_VOICES.get(lang, lang)
        assert (pgb.espeak_word_to_ipa("mot", voice, fake_espeak)
                == jgb.espeak_word_to_ipa("mot", voice, fake_espeak))
    for lang in sorted(jpp.LANGS):
        a, b = pgb.make_live_backend(lang), jgb.make_live_backend(lang)
        assert (a is None) == (b is None), lang
        if a is not None:
            assert a("zorblaxe") == b("zorblaxe"), lang


@pytest.mark.parametrize("lang,text", [
    ("fr", "Bonjour zorblaxe, le quintrevo!"),
    ("it", "La casa zorblaxe e il quintrevo."),
    ("ro", "Casa zorblaxe, quintrevo!"),
    ("en", "The zorblaxe quintrevo, church."),
])
def test_live_g2p_writes_the_same_cache(tmp_path, fake_espeak, lang, text):
    """The auto-wired backend fills the misses: the same ids, the same bytes
    in the user's cache under the base directory, and nothing written into
    either package's ``assets/``."""
    before = (_tree_digest(PORT_ASSETS), _tree_digest(JAX_ASSETS))
    got = []
    for name, mod in (("port", ppp), ("jax", jpp)):
        base = _empty_base(tmp_path / name)
        tp = mod.XvaTextPreprocessor(lang, base)
        tp._pos_tag = None
        assert tp.g2p_backend is not None
        res = outcome(tp, text)
        path = os.path.join(base, "g2p_cache", jpp.LANGS[lang]["cache"])
        got.append((res, open(path, "rb").read(), tp.g2p_cache_path == path))
    assert got[0] == got[1]
    assert b"zorblaxe|" in got[0][1] and got[0][2]
    assert (_tree_digest(PORT_ASSETS), _tree_digest(JAX_ASSETS)) == before


def _dataset(path, lines):
    os.makedirs(os.path.join(path, "wavs"))
    for i in range(len(lines)):
        open(os.path.join(path, "wavs", f"c{i}.wav"), "wb").close()
    with open(os.path.join(path, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("".join(f"c{i}.wav|{t}\n" for i, t in enumerate(lines)))
    return path


def test_pre_cache_g2p_matches_jax(tmp_path, fake_espeak, monkeypatch):
    """The same count and the same cache file, from ``text_base_dir`` and
    from ``XVA_TEXT_DIR``; 0 with neither a directory."""
    lines = ["Bonjour zorblaxe.", "Le quintrevo, le chat!", "Un frimbulo {K AE1 T}."]
    got = []
    for name, fn in (("port", pre_cache_g2p), ("jax", jax_pre_cache_g2p)):
        ds = _dataset(str(tmp_path / name / "fr_voice"), lines)
        base = _empty_base(tmp_path / name / "text")
        monkeypatch.delenv("XVA_TEXT_DIR", raising=False)
        n0 = fn(ds, "fr")
        n1 = fn([ds, ds], "fr", text_base_dir=base)
        cache = os.path.join(base, "g2p_cache", "espeak", "espeak_cache_fr.txt")
        first = open(cache, "rb").read()
        base2 = _empty_base(tmp_path / name / "text2")
        monkeypatch.setenv("XVA_TEXT_DIR", base2)
        n2 = fn(ds, "fr")
        second = open(os.path.join(base2, "g2p_cache", "espeak", "espeak_cache_fr.txt"),
                      "rb").read()
        monkeypatch.setenv("XVA_TEXT_DIR", str(tmp_path / "absent"))
        got.append((n0, n1, n2, fn(ds, "fr"), first, second))
    assert got[0] == got[1]
    assert got[0][:4] == (0, 6, 3, 0) and b"zorblaxe|" in got[0][4]


# ---------------- LanguageManager ----------------


def test_language_manager_matches_jax(tmp_path):
    ours, ref = plm.LanguageManager(), jlm.LanguageManager()
    assert ours.language_id_mapping == ref.language_id_mapping
    assert ours.num_languages == ref.num_languages == 31
    assert ours.language_names == ref.language_names
    for code in ["en", "fr", "IT", "ro", "zh", "xx", "", None]:
        assert ours.lang_id(code) == ref.lang_id(code), code
    dirs = ["/d/fr_voice", "/d/it_prior/", "ro_prior", "/d/voice", "/d/xx_bad", "/d/de_a_b",
            "/d/it_other", "en"]
    for d in dirs:
        assert (plm.LanguageManager.parse_language_from_dir(d)
                == jlm.LanguageManager.parse_language_from_dir(d)), d
    assert ours.group_datasets(dirs) == ref.group_datasets(dirs)
    langs = ["fr"] * 5 + ["it"] * 2 + ["ro"] * 3 + ["en"]
    a, b = ours.sampling_weights(langs), ref.sampling_weights(langs)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    ours.save_ids_to_file(str(tmp_path / "port.json"))
    ref.save_ids_to_file(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    (tmp_path / "ids.json").write_text(json.dumps({"en": 0, "fr": 3, "it": 1}), encoding="utf8")
    back, ref_back = (m.LanguageManager(str(tmp_path / "ids.json")) for m in (plm, jlm))
    assert back.language_id_mapping == ref_back.language_id_mapping == {"en": 0, "fr": 3, "it": 1}
    for code in ("it", "ro", None):
        assert back.lang_id(code) == ref_back.lang_id(code), code


# ---------------- the port's own assets ----------------


def _asset_files(root):
    out = [os.path.join("dicts", f) for f in sorted(os.listdir(os.path.join(root, "dicts")))]
    out += [os.path.join("g2p_cache", f)
            for f in sorted(os.listdir(os.path.join(root, "g2p_cache")))]
    return out + ["heteronyms.json"]


def test_assets_are_copies_of_jax():
    """Every file under the port's ``assets/{dicts,g2p_cache}`` and its
    ``heteronyms.json`` has the SHA-256 of the JAX package's, and the lists
    of files are equal."""
    ours, ref = _asset_files(PORT_ASSETS), _asset_files(JAX_ASSETS)
    assert ours == ref and len(ours) == 23 + 17 + 1

    def sha(root, rel):
        with open(os.path.join(root, rel), "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    for rel in ref:
        assert sha(PORT_ASSETS, rel) == sha(JAX_ASSETS, rel), rel


def _under(path, root):
    parts, root_parts = os.path.realpath(path).split(os.sep), os.path.realpath(root).split(os.sep)
    return parts[:len(root_parts)] == root_parts


@pytest.mark.parametrize("lang,want", [
    ("en", ["dicts/cmudict.txt.gz", "dicts/xvadict-elder_scrolls.json.gz",
            "g2p_cache/espeak_cache_en.txt.gz", "heteronyms.json"]),
    ("fr", ["g2p_cache/espeak_cache_fr.txt.gz"]),
    ("ro", ["dicts/romanian.txt.gz", "g2p_cache/espeak_cache_ro.txt.gz"]),
])
def test_port_opens_its_own_assets(monkeypatch, lang, want):
    """The files the port's preprocessor opens, its process-wide caches
    empty: the shipped tiers under the port's ``assets/``, and none under the
    JAX package's directory (compared by path components:
    ``xva_trainer_tpu_torch`` shares its prefix)."""
    monkeypatch.setattr(ppp.XvaTextPreprocessor, "_DICT_CACHE", {})
    monkeypatch.setattr(ppp.XvaTextPreprocessor, "_SHIPPED_G2P", {})
    opened = []

    def recorder(real):
        def wrapped(file, *a, **kw):
            if isinstance(file, (str, bytes, os.PathLike)):
                opened.append(os.fsdecode(file))
            return real(file, *a, **kw)
        return wrapped

    for mod, name in ((builtins, "open"), (gzip, "open"), (codecs, "open")):
        monkeypatch.setattr(mod, name, recorder(getattr(mod, name)))
    tp = pinned(ppp, lang)
    outcome(tp, "A test, one two three.")
    monkeypatch.undo()
    jax_pkg = os.path.dirname(xva_trainer_tpu.__file__)
    assert opened and not [p for p in opened if _under(p, jax_pkg)], opened
    shipped = sorted(os.path.relpath(os.path.realpath(p), os.path.realpath(PORT_ASSETS))
                     for p in opened if _under(p, PORT_ASSETS))
    assert sorted(set(shipped)) == sorted(want), shipped
