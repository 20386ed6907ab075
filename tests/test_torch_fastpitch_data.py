"""Port parity of the v2 data path: ``FeatureCache`` and ``BucketBatcher``
against the JAX package's.

- The port's build of a seeded dataset against JAX's ("fft" variant, the
  JAX package's CPU path): the same items, files and keys, tokens and
  ``wav_len`` equal, mel within 1e-3 mean abs, energy within 1e-3 of its max
  abs, pitch voiced on the same frames for more than 95% of them and within
  2% in Hz on 95% of the frames both call voiced (the v3 cache tests' bars); the unreadable
  wav healed and the clip under 4 frames skipped by both; a fresh port cache
  pins "pallas", and an "fft" pin is followed.
- A cache JAX built, read by the port: every item's arrays equal.
- ``BucketBatcher`` epochs on that cache equal to JAX's on the same seed,
  array for array (the fp16 feed, the host prior, durations and the uniform
  substitute), with and without the ARPAbet mix.
- ``zero_batch`` against ``collate(b, [])``; ``pitch_stats`` and
  ``max_file_len_sec``.

Both packages decode with scipy (the JAX package's native decoder is off).
"""
import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from xva_trainer_tpu import native
from xva_trainer_tpu.data import dataset as jds
from xva_trainer_tpu.data.text import TextProcessor as JaxTextProcessor
from xva_trainer_tpu_torch.data import dataset as pds
from xva_trainer_tpu_torch.data.audio_io import save_wav
from xva_trainer_tpu_torch.data.text.processor import TextProcessor

SR = 22050
ITEMS = [("u0", 0.9, "hello there"), ("u1", 1.4, "test line number one"),
         ("u2", 2.2, "a quick brown fox jumps over"), ("u3", 0.6, "short one"),
         ("u4", 1.8, "the rain in spain"), ("u5", 1.1, "number five here"),
         ("u6", 0.7, "seven"), ("u7", 2.0, "it was the best of times")]
BUCKETS = [(24, 64), (32, 128), (48, 192)]
CMUDICT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "xva_trainer_tpu_torch", "assets", "dicts", "cmudict.txt.gz")


@pytest.fixture(autouse=True)
def scipy_only(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    torch.set_num_threads(1)


def _voiced(rng, seconds):
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f0 = rng.uniform(100, 220) * (1 + 0.1 * np.sin(2 * np.pi * 1.3 * t))
    ph = 2 * np.pi * np.cumsum(f0) / SR
    y = sum(np.sin(k * ph) / k for k in range(1, 8))
    gate = (np.sin(2 * np.pi * 1.7 * t) > -0.6).astype(np.float64)
    return np.clip(0.3 * y * gate + 0.01 * rng.standard_normal(n), -1, 1).astype(np.float32)


@pytest.fixture(scope="module")
def template(tmp_path_factory):
    """A dataset: the items, a clip under 4 frames and an unreadable wav."""
    path = str(tmp_path_factory.mktemp("tpl") / "v2_voice")
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(path, "wavs"))
    lines = []
    for name, sec, text in ITEMS:
        save_wav(os.path.join(path, "wavs", name + ".wav"), _voiced(rng, sec))
        lines.append(f"{name}.wav|{text}")
    save_wav(os.path.join(path, "wavs", "tiny.wav"), _voiced(rng, 0.03))
    with open(os.path.join(path, "wavs", "bad.wav"), "wb") as f:
        f.write(b"RIFF\x00\x00not a wav")
    lines += ["tiny.wav|too short", "bad.wav|unreadable"]
    with open(os.path.join(path, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return path


@pytest.fixture(scope="module")
def jax_cache_dir(template, tmp_path_factory):
    """The template's copy with a cache JAX built ("fft")."""
    dst = str(tmp_path_factory.mktemp("jaxbuilt") / "v2_voice")
    shutil.copytree(template, dst)
    jds.FeatureCache(dst, JaxTextProcessor().encode, use_pallas=False).build()
    return dst


def _items(cache):
    got = {it.item_id: cache.load_item(it) for it in cache.items}
    return {k: v for k, v in got.items() if v is not None}


def _pin(cache):
    with open(os.path.join(cache.cache_dir, ".mel_variant")) as f:
        return f.read().strip()


def test_cache_build_matches_jax(template, jax_cache_dir, tmp_path):
    dst = str(tmp_path / "v2_voice")
    shutil.copytree(template, dst)
    ours = pds.FeatureCache(dst, TextProcessor().encode, device="cpu")
    ours.build()
    ref = jds.FeatureCache(jax_cache_dir, JaxTextProcessor().encode, use_pallas=False)
    assert _pin(ours) == "pallas" and _pin(ref) == "fft"
    assert [it.item_id for it in ours.items] == [it.item_id for it in ref.items]
    assert "bad" not in [it.item_id for it in ours.items]
    a_items, b_items = _items(ours), _items(ref)
    assert sorted(a_items) == sorted(b_items) == sorted(n for n, _, _ in ITEMS)
    assert (sorted(f for f in os.listdir(ours.cache_dir) if not f.startswith("."))
            == sorted(f for f in os.listdir(ref.cache_dir) if not f.startswith(".")))
    for k, b in b_items.items():
        a = a_items[k]
        assert set(a) == set(b) == {"mel", "pitch", "energy", "tokens", "wav_len"}
        for key in b:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, (k, key)
        assert np.abs(a["mel"] - b["mel"]).mean() < 1e-3, k
        assert np.abs(a["energy"] - b["energy"]).max() < 1e-3 * np.abs(b["energy"]).max(), k
        va, vb = a["pitch"] != 0, b["pitch"] != 0
        assert (va == vb).mean() > 0.95, k
        both = va & vb
        assert both.sum() > 10, k
        assert np.percentile(np.abs(a["pitch"][both] - b["pitch"][both]) / b["pitch"][both],
                             95) < 0.02, k
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["wav_len"], b["wav_len"])


def test_jax_cache_read_and_extended_by_the_port(jax_cache_dir, tmp_path):
    """The port reads every item of JAX's cache as JAX does, and a build
    over it follows its "fft" pin (nothing left to build)."""
    dst = str(tmp_path / "v2_voice")
    shutil.copytree(jax_cache_dir, dst)
    ref = jds.FeatureCache(dst, JaxTextProcessor().encode, use_pallas=False)
    ours = pds.FeatureCache(dst, TextProcessor().encode, device="cpu")
    a, b = _items(ours), _items(ref)
    assert sorted(a) == sorted(b)
    for k in b:
        for key in b[k]:
            np.testing.assert_array_equal(a[k][key], b[k][key])
    ours.build()
    assert _pin(ours) == "fft" and not ours.use_pallas


def test_pitch_stats_and_max_file_len(jax_cache_dir):
    """On JAX's cache in place (its corrupt list names the healed wav by
    its path there)."""
    stats = os.path.join(jax_cache_dir, ".tpu_cache", "pitch_stats.json")
    if os.path.exists(stats):
        os.remove(stats)
    ours = pds.FeatureCache(jax_cache_dir, TextProcessor().encode, device="cpu")
    got = ours.pitch_stats()
    os.remove(stats)
    ref = jds.FeatureCache(jax_cache_dir, JaxTextProcessor().encode, use_pallas=False)
    assert got == ref.pitch_stats() and got["mean"] > 0
    assert ours.max_file_len_sec() == ref.max_file_len_sec()


def _batchers(cache_dir, arpabet_dir=None, **kw):
    ours = pds.BucketBatcher(pds.FeatureCache(cache_dir, TextProcessor().encode, device="cpu"),
                             buckets=[pds.Bucket(*b) for b in BUCKETS], **kw)
    ref = jds.BucketBatcher(jds.FeatureCache(cache_dir, JaxTextProcessor().encode,
                                             use_pallas=False),
                            buckets=[jds.Bucket(*b) for b in BUCKETS], **kw)
    if arpabet_dir:
        cmu = os.path.join(arpabet_dir, "cmudict.txt")
        ours.arpabet_encoder = TextProcessor(p_arpabet=0.3, cmudict_path=cmu)
        ref.arpabet_encoder = JaxTextProcessor(p_arpabet=0.3, cmudict_path=cmu)
    return ours, ref


def _assert_epochs_equal(ours, ref, n_epochs=3):
    assert ours.skipped == ref.skipped and len(ours) == len(ref)
    for e in range(n_epochs):
        shuffle = e < n_epochs - 1
        a_all, b_all = list(ours.epoch(shuffle)), list(ref.epoch(shuffle))
        assert len(a_all) == len(b_all) == len(ref)
        for a, b in zip(a_all, b_all):
            assert set(a) == set(b)
            assert a["ids"] == b["ids"]
            for k in b:
                if k != "ids":
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("arpabet", [False, True], ids=["plain", "arpabet"])
def test_batcher_epochs_equal_jax(jax_cache_dir, tmp_path, arpabet):
    """Plans, ids and every array, three epochs (two shuffled), the host
    prior on, the fp16 feed; with the ARPAbet mix at p = 0.3 (which changes
    tokens) each package's encoder draws from its own seeded generator."""
    if arpabet:
        # cmudict-0.7b's layout, two spaces after the word, which the v2
        # reader splits on (the shipped file has one)
        with gzip.open(CMUDICT, "rt", encoding="latin-1") as f, \
                open(tmp_path / "cmudict.txt", "w", encoding="latin-1") as g:
            for line in f:
                word, _, phones = line.strip().partition(" ")
                g.write(f"{word.upper()}  {phones}\n")
    ours, ref = _batchers(jax_cache_dir, str(tmp_path) if arpabet else None, batch_size=3,
                          seed=5)
    if arpabet:
        assert len(ours.arpabet_encoder.cmudict.entries) > 100_000
        plain, _ = _batchers(jax_cache_dir, batch_size=3, seed=5)
        assert any(not np.array_equal(a["tokens"], b["tokens"])
                   for a, b in zip(ours.epoch(False), plain.epoch(False)))
        ours, ref = _batchers(jax_cache_dir, str(tmp_path), batch_size=3, seed=5)
    _assert_epochs_equal(ours, ref)


@pytest.mark.parametrize("with_prior,device_prior", [(False, False), (True, False),
                                                     (False, True)])
def test_batcher_durations_equal_jax(jax_cache_dir, tmp_path, with_prior, device_prior):
    """``use_durs`` with some items' durations missing: the uniform
    substitute when no prior is made anywhere, else no ``"durs"`` in a batch
    with a missing item; float32 features (``half_feed`` off)."""
    dst = str(tmp_path / "v2_voice")
    shutil.copytree(jax_cache_dir, dst)
    cache = pds.FeatureCache(dst, TextProcessor().encode, device="cpu")
    rng = np.random.default_rng(2)
    for it in cache.items[:5]:
        d = cache.load_item(it)
        if d is not None:
            cache.save_durations(it.item_id, rng.integers(0, 9, len(d["tokens"])).astype(
                np.float32))
    ours, ref = _batchers(dst, batch_size=2, seed=1, with_prior=with_prior,
                          device_prior=device_prior, half_feed=False)
    ours.use_durs = ref.use_durs = True
    _assert_epochs_equal(ours, ref, n_epochs=2)


def test_zero_batch_matches_collate(jax_cache_dir):
    ours, _ = _batchers(jax_cache_dir, batch_size=3, seed=0)
    for b in ours.buckets:
        for with_prior in (True, False):
            ours.with_prior = with_prior
            got = ours.collate(b, [])
            zb = pds.zero_batch(b, 3, with_prior=with_prior)
            ref = jds.zero_batch(jds.Bucket(b.text_len, b.mel_len), 3, with_prior=with_prior)
            assert set(got) == set(zb) == set(ref)
            for k in zb:
                if k != "ids":
                    assert zb[k].shape == got[k].shape == ref[k].shape, k
                    assert zb[k].dtype == got[k].dtype == ref[k].dtype, k
                    np.testing.assert_array_equal(zb[k], got[k])
