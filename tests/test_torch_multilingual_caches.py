"""Port parity of the v3 path with priors in other languages, on the CPU:
a French fine-tune dataset and Italian and Romanian priors datasets, each
cached under ``XVA_TEXT_DIR`` with its own language's tokenizer (the
language of a priors directory from its name, as the JAX server's v3 flow
finds it), by the port and by the JAX package: equal ``tokens`` and
``lang_id`` item by item; then a ``weighted_by_language`` priors batcher
over the two priors caches gives the JAX batcher's epochs, array for array.
"""
import os
import re

import numpy as np
import pytest
import torch
from test_torch_xva_dataset import _voiced

from xva_trainer_tpu import native
from xva_trainer_tpu.data import xva_dataset as jxd
from xva_trainer_tpu.data.dataset import Bucket as JaxBucket
from xva_trainer_tpu.data.language_manager import LanguageManager as JaxLanguageManager
from xva_trainer_tpu.data.text import v3_text_to_ids as jax_text_to_ids
from xva_trainer_tpu_torch.data import xva_dataset as pxd
from xva_trainer_tpu_torch.data.audio_io import save_wav
from xva_trainer_tpu_torch.data.dataset import Bucket
from xva_trainer_tpu_torch.data.language_manager import LanguageManager
from xva_trainer_tpu_torch.data.text import v3_text_to_ids

# words each language's shipped tiers hold (French: the espeak capture;
# Italian and Romanian: the lexicon and the capture), digits the French and
# Italian captures hold, and a brace group each
TEXTS = {
    "fr": ["Bonjour, le chat mange 12 pommes.", "La maison est grande {K AE1 T}!",
           "Nous allons au marché; il fait beau.", "Le petit garçon lit un livre 7 fois?"],
    "it": ["La casa rossa è bella, 100 gatti.", "Il cane corre nel parco {D AO1 G}!",
           "Oggi piove; domani sole.", "Mangio la pasta 3 volte?"],
    "ro": ["Casa mea este frumoasă, doi câini.", "Pisica doarme pe masă {K AE1 T}!",
           "Astăzi plouă; mâine soare.", "Copilul citește o carte?"],
}
BUCKETS = [Bucket(64, 64), Bucket(96, 128)]


@pytest.fixture(autouse=True)
def scipy_only(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    torch.set_num_threads(1)
    text_dir = tmp_path / "xva_text"  # a stock install: an empty directory
    text_dir.mkdir()
    monkeypatch.setenv("XVA_TEXT_DIR", str(text_dir))


def _write(path, lang, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(path, "wavs"))
    lines = []
    for i, text in enumerate(TEXTS[lang]):
        save_wav(os.path.join(path, "wavs", f"{lang}{i}.wav"),
                 _voiced(rng, float(rng.uniform(0.6, 1.4))))
        lines.append(f"{lang}{i}.wav|{text}")
    with open(os.path.join(path, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _datasets(root):
    """fr_voice beside a priors root holding it_prior and ro_prior."""
    fr = _write(os.path.join(root, "fr_voice"), "fr", 0)
    priors = os.path.join(root, "priors")
    dirs = [_write(os.path.join(priors, f"{lang}_prior"), lang, s)
            for s, lang in enumerate(("it", "ro"), 1)]
    return fr, priors, dirs


def _tokens_and_langs(cache):
    out = {}
    for it in cache.items:
        d = cache.load_item(it)
        out[it.item_id] = (d["tokens"], d["lang_id"])
    return out


def test_caches_match_jax(tmp_path):
    """Each dataset tokenized in its language by each package: equal tokens
    (int32) and lang_id, every sentence tokenized with no word dropped."""
    got = {}
    for name in ("port", "jax"):
        fr, priors, _ = _datasets(str(tmp_path / name))
        dirs, langs = (pxd if name == "port" else jxd).read_priors_datasets(
            ["it", "ro"], [priors], extract_embs=False)
        assert langs == ["it", "ro"]
        manager = LanguageManager if name == "port" else JaxLanguageManager
        caches = []
        for d, lang in [(fr, "fr")] + [(d, manager.parse_language_from_dir(d)) for d in dirs]:
            if name == "port":
                c = pxd.XvaFeatureCache(d, v3_text_to_ids(lang), lang=lang, device="cpu")
            else:
                c = jxd.XvaFeatureCache(d, jax_text_to_ids(lang), lang=lang, use_pallas=False)
            c.build()
            caches.append((lang, _tokens_and_langs(c)))
        got[name] = caches
    for (lang, ours), (ref_lang, ref) in zip(got["port"], got["jax"]):
        assert lang == ref_lang and sorted(ours) == sorted(ref) and len(ours) == 4
        for k in ref:
            (ta, la), (tb, lb) = ours[k], ref[k]
            assert ta.dtype == tb.dtype == np.int32 and np.array_equal(ta, tb), k
            assert la.dtype == lb.dtype and np.array_equal(la, lb), k
            assert int(la.reshape(-1)[0]) == pxd.lang_to_id(lang), k
    # no word dropped: every word outside the braces tokenizes alone
    for lang, texts in TEXTS.items():
        to_ids = v3_text_to_ids(lang)
        for t in texts:
            for w in re.sub(r"{[^}]*}", " ", t).split():
                if w.strip(",.;!?"):
                    assert to_ids(w.strip(",.;!?")), (lang, w)


def test_weighted_priors_batcher_matches_jax(tmp_path):
    """The priors batcher of the v3 flow (``weighted_by_language``) over the
    Italian and Romanian caches, read by both packages from one directory:
    JAX's epochs, shuffled, two in a row."""
    _, priors, dirs = _datasets(str(tmp_path))
    pc, jc = [], []
    for d in dirs:
        lang = LanguageManager.parse_language_from_dir(d)
        c = pxd.XvaFeatureCache(d, v3_text_to_ids(lang), lang=lang, device="cpu")
        c.build()
        pc.append(c)
        jlang = JaxLanguageManager.parse_language_from_dir(d)
        jc.append(jxd.XvaFeatureCache(d, jax_text_to_ids(jlang), lang=jlang))
    dvec = np.random.default_rng(5).standard_normal(512).astype(np.float32)
    pb = pxd.XvaBatcher(pc, batch_size=2, d_vector=dvec, buckets=BUCKETS, seed=4)
    jb = jxd.XvaBatcher(jc, batch_size=2, d_vector=dvec, seed=4,
                        buckets=[JaxBucket(b.text_len, b.mel_len) for b in BUCKETS])
    for b in (pb, jb):
        b.weighted_by_language = True
    langs = set()
    for _ in range(2):
        ours, ref = list(pb.epoch()), list(jb.epoch())
        assert len(ours) == len(ref) > 0
        for a, b in zip(ours, ref):
            assert a["ids"] == b["ids"] and sorted(a) == sorted(b)
            for k in b:
                if k != "ids":
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            langs.update(int(x) for x in a["lang"])
    assert langs == {pxd.lang_to_id("it"), pxd.lang_to_id("ro")}
