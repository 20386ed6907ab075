"""Port parity of the v3 data path: ``XvaFeatureCache`` against the JAX
cache (both variants; the JAX Pallas kernel in interpret mode, as its own
tests run it), caches read and extended across the packages with the pin
followed, the raising build, ``XvaBatcher`` epochs equal array for array,
``loss_sorted_resample``, ``preprocess_audio``, and the train step's
pass-through of a host spectrogram.

Bars: linear spectrogram within 1e-3 mean abs; energy within 1e-3 of its
max abs; pitch voiced on the same frames for more than 95% of them and 95%
of the frames both call voiced within 2% in Hz (the JAX package's own bar,
tests/test_features_batched.py); tokens, wav and lang_id equal; batches
equal; the host-spectrogram step's losses within 1e-4 relative (the step
tests' bar). Both packages decode with scipy (the JAX package's native
decoder is off here; the port has none).
"""
import os
import random
import shutil

import numpy as np
import pytest
import torch
from torch_v3_common import (HOP, draws_of, jax_forward, port_models, rel_err, seeded_params,
                             torch_batch)

from xva_trainer_tpu import native
from xva_trainer_tpu.data import xva_dataset as jxd
from xva_trainer_tpu.data.dataset import Bucket as JaxBucket
from xva_trainer_tpu.data.text.xva_processor import XvaTextProcessor
from xva_trainer_tpu.train.xvapitch_trainer import preprocess_audio as jax_preprocess_audio
from xva_trainer_tpu_torch.data import xva_dataset as pxd
from xva_trainer_tpu_torch.data.audio_io import save_wav
from xva_trainer_tpu_torch.data.dataset import Bucket
from xva_trainer_tpu_torch.data.text import v3_text_to_ids
from xva_trainer_tpu_torch.models.xvapitch import losses
from xva_trainer_tpu_torch.train.xvapitch_trainer import materialize_spec, preprocess_audio

SR = 22050
JAX_TP = XvaTextProcessor().text_to_sequence
PORT_TP = v3_text_to_ids("en")
# name, seconds, text; plus a clip under 40 frames and an unreadable wav
ITEMS = [("u0", 0.9, "hello there"), ("u1", 1.4, "test line number one"),
         ("u2", 2.2, "a quick brown fox jumps"), ("u3", 0.6, "short one"),
         ("u4", 1.8, "the rain in spain"), ("u5", 1.1, "number five here")]
BUCKETS = [Bucket(24, 64), Bucket(32, 128), Bucket(48, 192)]
LOSS_KEYS = ("loss", "loss_mel", "loss_gen", "loss_feat", "loss_kl", "loss_duration",
             "loss_pitch")


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


def _write_dataset(path, items=ITEMS, seed=0, extras=True):
    """wavs/ and metadata.csv; with ``extras`` a clip under 40 frames, an
    unreadable wav, a postprocessed wav (preferred) and an unreadable
    postprocessed wav (its original is used), and per-item speaker
    embeddings for some items."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(path, "wavs"))
    lines = []
    for name, sec, text in items:
        save_wav(os.path.join(path, "wavs", name + ".wav"), _voiced(rng, sec))
        lines.append(f"{name}.wav|{text}")
    if extras:
        save_wav(os.path.join(path, "wavs", "tiny.wav"), _voiced(rng, 0.3))
        with open(os.path.join(path, "wavs", "bad.wav"), "wb") as f:
            f.write(b"RIFF\x00\x00not a wav")
        lines += ["tiny.wav|too short", "bad.wav|unreadable"]
        post = os.path.join(path, "wavs_postprocessed")
        os.makedirs(post)
        save_wav(os.path.join(post, "u1.wav"), 0.5 * _voiced(rng, 1.4))
        with open(os.path.join(post, "u4.wav"), "wb") as f:
            f.write(b"RIFF\x10\x00\x00\x00WAVEtruncated")
        os.makedirs(os.path.join(path, "se_embs"))
        for name in ("u0", "u2", "u5"):
            np.save(os.path.join(path, "se_embs", name + ".npy"),
                    rng.standard_normal(512).astype(np.float32))
    with open(os.path.join(path, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return path


@pytest.fixture(scope="module")
def template(tmp_path_factory):
    return _write_dataset(str(tmp_path_factory.mktemp("tpl") / "en_voice"))


def _copy(template, tmp_path, name="en_voice"):
    dst = str(tmp_path / name)
    shutil.copytree(template, dst)
    return dst


def _items(cache):
    """The cached items by id (a clip too short to cache stays in ``items``)."""
    got = {it.item_id: cache.load_item(it) for it in cache.items}
    return {k: v for k, v in got.items() if v is not None}


def assert_items_close(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k in ref:
        a, b = ours[k], ref[k]
        assert set(a) == set(b) == {"linear", "pitch", "energy", "tokens", "wav", "lang_id"}
        for key in b:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, (k, key)
        assert np.abs(a["linear"] - b["linear"]).mean() < 1e-3, k
        assert np.abs(a["energy"] - b["energy"]).max() < 1e-3 * np.abs(b["energy"]).max(), k
        va, vb = a["pitch"] != 0, b["pitch"] != 0
        assert (va == vb).mean() > 0.95, k
        both = va & vb
        hz_a = a["pitch"][both] * pxd.XVASPEECH_PITCH_STD + pxd.XVASPEECH_PITCH_MEAN
        hz_b = b["pitch"][both] * pxd.XVASPEECH_PITCH_STD + pxd.XVASPEECH_PITCH_MEAN
        assert both.sum() > 10 and np.percentile(np.abs(hz_a - hz_b) / hz_b, 95) < 0.02, k
        for key in ("tokens", "wav", "lang_id"):
            np.testing.assert_array_equal(a[key], b[key])


def _corrupt(cache):
    path = os.path.join(cache.cache_dir, "corrupt_wavs.txt")
    with open(path, encoding="utf8") as f:
        return sorted(os.path.relpath(line.strip(), cache.dataset_path) for line in f)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "fft"])
def test_cache_build_matches_jax(template, tmp_path, use_pallas):
    ref = jxd.XvaFeatureCache(_copy(template, tmp_path / "jax"), JAX_TP, use_pallas=use_pallas)
    ref.build()
    ours = pxd.XvaFeatureCache(_copy(template, tmp_path / "port"), PORT_TP,
                               use_pallas=use_pallas, device="cpu")
    ours.build()
    assert [it.item_id for it in ours.items] == [it.item_id for it in ref.items]
    assert "bad" not in [it.item_id for it in ours.items]
    assert _corrupt(ours) == _corrupt(ref) == ["wavs/bad.wav"]
    got = _items(ours)
    assert sorted(got) == ["u0", "u1", "u2", "u3", "u4", "u5"]  # tiny.wav skipped
    assert_items_close(got, _items(ref))
    variant = "pallas" if use_pallas else "fft"
    for c in (ours, ref):
        with open(os.path.join(c.cache_dir, ".mel_variant"), encoding="utf8") as f:
            assert f.read() == variant
    assert ours._packed and set(ours.build_seconds) == {"decode", "featurize", "write", "pack"}


def test_cache_matches_jax_serial_build(template, tmp_path):
    """The JAX package's serial build (the per-item STFT and numpy YIN)
    agrees with the port's batched one within the same bars."""
    ref = jxd.XvaFeatureCache(_copy(template, tmp_path / "jax"), JAX_TP, use_pallas=False)
    ref.build(batched=False)
    ours = pxd.XvaFeatureCache(_copy(template, tmp_path / "port"), PORT_TP, use_pallas=False,
                               device="cpu")
    ours.build()
    assert_items_close(_items(ours), _items(ref))


def _metadata_prefix(ds, n):
    """Keep the first ``n`` lines of metadata.csv; return the rest."""
    path = os.path.join(ds, "metadata.csv")
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines[:n]) + "\n")
    return lines


def _restore(ds, lines):
    with open(os.path.join(ds, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("first", ["jax", "port"])
def test_cache_extended_by_the_other_package(template, tmp_path, first):
    """A cache started by one package is extended by the other: the pin is
    followed whatever the second one prefers, the items already cached are
    not rewritten, and both read every item alike."""
    ds = _copy(template, tmp_path)
    lines = _metadata_prefix(ds, 3)
    pin = "fft" if first == "jax" else "pallas"
    if first == "jax":
        jxd.XvaFeatureCache(ds, JAX_TP, use_pallas=False).build()
    else:
        pxd.XvaFeatureCache(ds, PORT_TP, device="cpu").build()
    cache_dir = os.path.join(ds, ".tpu_cache_v3")
    mtimes = {f: os.path.getmtime(os.path.join(cache_dir, f))
              for f in os.listdir(cache_dir) if f.endswith(".npz")}
    assert sorted(mtimes) == ["u0.npz", "u1.npz", "u2.npz"]
    _restore(ds, lines)
    if first == "jax":
        second = pxd.XvaFeatureCache(ds, PORT_TP, device="cpu")  # prefers "pallas"
        second.build()
        assert second.use_pallas is False
    else:
        second = jxd.XvaFeatureCache(ds, JAX_TP, use_pallas=False)  # prefers "fft"
        second.build()
        assert second.use_pallas is True
    with open(os.path.join(cache_dir, ".mel_variant"), encoding="utf8") as f:
        assert f.read() == pin
    for f, m in mtimes.items():
        assert os.path.getmtime(os.path.join(cache_dir, f)) == m
    ours = _items(pxd.XvaFeatureCache(ds, PORT_TP, device="cpu"))
    ref = _items(jxd.XvaFeatureCache(ds, JAX_TP, use_pallas=False))
    assert sorted(ours) == sorted(ref) == ["u0", "u1", "u2", "u3", "u4", "u5"]
    for k in ref:
        for key in ref[k]:
            np.testing.assert_array_equal(ours[k][key], ref[k][key])
    # the items the second package added are the second package's variant of
    # the pinned function: compare them with a fresh build by the first one
    fresh = _copy(template, tmp_path / "fresh")
    if first == "jax":
        jxd.XvaFeatureCache(fresh, JAX_TP, use_pallas=False).build()
    else:
        pxd.XvaFeatureCache(fresh, PORT_TP, device="cpu").build()
    assert_items_close(ours, _items(pxd.XvaFeatureCache(fresh, PORT_TP, device="cpu")))


def test_failed_build_raises(template, tmp_path, monkeypatch):
    """The batched build is the only path: a failure in it raises, and
    nothing is written."""
    def boom(*a, **k):
        raise RuntimeError("featurize failed")

    monkeypatch.setattr(pxd, "featurize_batch", boom)
    cache = pxd.XvaFeatureCache(_copy(template, tmp_path), PORT_TP, device="cpu")
    with pytest.raises(RuntimeError, match="featurize failed"):
        cache.build()
    assert not [f for f in os.listdir(cache.cache_dir) if f.endswith(".npz")]


def test_build_refuses_missing_cuda(template, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the host has CUDA; this guards CUDA-less hosts")
    cache = pxd.XvaFeatureCache(_copy(template, tmp_path), PORT_TP)  # the card by default
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cache.build()


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Two caches built by the port (English and German), for the batchers."""
    root = tmp_path_factory.mktemp("built")
    en = _write_dataset(str(root / "en_voice"))
    de = _write_dataset(str(root / "de_voice"), ITEMS[:4], seed=1, extras=False)
    pxd.XvaFeatureCache(en, PORT_TP, device="cpu").build()
    pxd.XvaFeatureCache(de, PORT_TP, lang="de", device="cpu").build()
    return [(en, "en"), (de, "de")]


def _batchers(built, n_caches, **kw):
    dvec = np.random.default_rng(5).standard_normal(512).astype(np.float32)
    jc = [jxd.XvaFeatureCache(d, JAX_TP, lang=lang, use_pallas=True) for d, lang in built]
    pc = [pxd.XvaFeatureCache(d, PORT_TP, lang=lang, device="cpu") for d, lang in built]
    jb = jxd.XvaBatcher(jc[:n_caches], d_vector=dvec,
                        buckets=[JaxBucket(b.text_len, b.mel_len) for b in BUCKETS], **kw)
    pb = pxd.XvaBatcher(pc[:n_caches], d_vector=dvec, buckets=BUCKETS, **kw)
    return jb, pb


def assert_batches_equal(ours, ref):
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        assert a["ids"] == b["ids"]
        for k in b:
            if k != "ids":
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("device_spec", [False, True])
@pytest.mark.parametrize("mode", ["plain", "shuffled", "weighted", "resampled"])
def test_batcher_epochs_equal_jax(built, device_spec, mode):
    jb, pb = _batchers(built, 2 if mode == "weighted" else 1, batch_size=2, seed=3)
    for b in (jb, pb):
        b.device_spec = device_spec
        b.weighted_by_language = mode == "weighted"
    if mode == "resampled":
        rng = np.random.default_rng(2)
        losses_by_item = {pb.item_key(c, it): float(rng.random()) for c, it in pb._index}
        jb.resample_by_loss(losses_by_item)
        pb.resample_by_loss(losses_by_item)
    shuffle = mode != "plain"
    for _ in range(2):  # the generator's state carries over between epochs
        ours, ref = list(pb.epoch(shuffle=shuffle)), list(jb.epoch(shuffle=shuffle))
        assert_batches_equal(ours, ref)
    assert ("linear" in ours[0]) != device_spec
    assert ours[0]["wav"].dtype == (np.int16 if device_spec else np.float32)


@pytest.mark.parametrize("batch_size,divisor", [(2, 1), (3, 1), (5, 2), (64, 8), (1, 4)])
def test_batcher_sizes_equal_jax(built, batch_size, divisor):
    jb, pb = _batchers(built, 2, batch_size=batch_size)
    jb.batch_divisor = pb.batch_divisor = divisor
    for b, jbk in zip(pb.buckets, jb.buckets):
        assert pb.batch_size_for(b) == jb.batch_size_for(jbk)
    assert pb.mean_batch_size() == jb.mean_batch_size()
    assert len(pb) == len(jb)
    for b in pxd.DEFAULT_V3_BUCKETS:  # the v3 buckets at the trainer's batch
        ours = pxd.XvaBatcher([], batch_size=batch_size, d_vector=np.zeros(512))
        ref = jxd.XvaBatcher([], batch_size=batch_size, d_vector=np.zeros(512))
        ours.batch_divisor = ref.batch_divisor = divisor
        assert ours.batch_size_for(b) == ref.batch_size_for(JaxBucket(b.text_len, b.mel_len))


@pytest.mark.parametrize("n,seed", [(1, 0), (7, 1), (40, 2), (300, 3)])
def test_loss_sorted_resample_equal_jax(n, seed):
    rng = np.random.default_rng(seed)
    losses_by_item = {f"ds::item{i}": float(v) for i, v in enumerate(rng.random(n))}
    assert pxd.loss_sorted_resample(losses_by_item) == jxd.loss_sorted_resample(losses_by_item)
    assert (pxd.loss_sorted_resample(losses_by_item, random.Random(seed))
            == jxd.loss_sorted_resample(losses_by_item, random.Random(seed)))


def test_preprocess_audio_matches_jax(template, tmp_path):
    ours, ref = _copy(template, tmp_path / "port"), _copy(template, tmp_path / "jax")
    for d in (ours, ref):
        shutil.rmtree(os.path.join(d, "wavs_postprocessed"))
        os.remove(os.path.join(d, "wavs", "bad.wav"))
    assert preprocess_audio(ours) == jax_preprocess_audio(ref) == 7
    from scipy.io import wavfile
    for f in sorted(os.listdir(os.path.join(ref, "wavs_postprocessed"))):
        sa, a = wavfile.read(os.path.join(ours, "wavs_postprocessed", f))
        sb, b = wavfile.read(os.path.join(ref, "wavs_postprocessed", f))
        assert sa == sb and a.shape == b.shape
        assert np.abs(a / 32768.0 - b / 32768.0).max() <= 1e-5, f


def test_host_spectrogram_passes_through(tmp_path):
    """A batch without ``device_spec`` (the JAX batcher's default) ships the
    cached linear spectrogram; the step trains on it, as the JAX step does,
    and not on one computed again from the audio."""
    ds = _write_dataset(str(tmp_path / "en_pt"), [("p0", 0.5, "hello there"),
                                                  ("p1", 0.74, "short one")], extras=False)
    cache = jxd.XvaFeatureCache(ds, JAX_TP, use_pallas=False)
    cache.build()
    dvec = (np.random.default_rng(1).standard_normal(512) * 0.1).astype(np.float32)
    batcher = jxd.XvaBatcher([cache], batch_size=2, d_vector=dvec, buckets=[JaxBucket(24, 64)])
    b = next(batcher.epoch(shuffle=False))
    b.pop("ids")
    assert "linear" in b and b["wav"].dtype == np.float32
    assert b["slens"].tolist() == [43, 63]

    tb = torch_batch(b)
    linear, wav = materialize_spec(tb, HOP)
    assert torch.equal(linear, tb["linear"].transpose(1, 2))
    assert torch.equal(wav, tb["wav"].transpose(1, 2))

    g_params, d_params = seeded_params(0)
    out, meta, sdp_noise = jax_forward(g_params, d_params, b)
    draws = draws_of(out, b, sdp_noise)
    model, disc = port_models(g_params, d_params)
    with torch.no_grad():
        o = model.train_step(tb["tokens"], tb["tlens"], linear, tb["slens"], tb["pitch"],
                             tb["energy"], wav, tb["dvec"], tb["lang"], **draws)
        s_fake, f_fake, s_real, f_real = disc(o["model_outputs"], o["waveform_seg"])
        _, ours = losses.generator_loss(o, s_fake, f_fake, f_real, language_ids=tb["lang"],
                                        spec_lengths=tb["slens"])
    for k in LOSS_KEYS:
        assert rel_err(ours[k], meta[k]) < 1e-4, k
