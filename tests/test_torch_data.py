"""Port parity of the data modules under the v3 cache: audio I/O, the
metadata and corrupt-item helpers, atomic npz writes, the spectrogram-variant
pin, packs read both ways, and the Prefetcher (the cases of
tests/test_prefetch.py).

Both packages decode with scipy: the JAX package's ``native/`` C++ decoder,
resampler and loudness paths are switched off for these tests (the port has
none), so the comparisons are of the same decoder.
"""
import json
import os
import time

import numpy as np
import pytest
from scipy.io import wavfile

from xva_trainer_tpu import native
from xva_trainer_tpu.data import audio_io as jax_audio
from xva_trainer_tpu.data import dataset as jax_dataset
from xva_trainer_tpu.data import packed as jax_packed
from xva_trainer_tpu_torch.data import audio_io, dataset, packed
from xva_trainer_tpu_torch.data.prefetch import Prefetcher


@pytest.fixture(autouse=True)
def scipy_only(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)


def _tone(n, f0=180.0, sr=22050, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return (0.4 * np.sin(2 * np.pi * f0 * t) + 0.02 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("kind", ["int16", "int32", "uint8", "float32", "stereo"])
@pytest.mark.parametrize("target_sr", [None, 22050, 16000])
def test_load_wav_matches_jax(tmp_path, kind, target_sr):
    y = _tone(9000)
    data = {"int16": (y * 32767).astype(np.int16), "int32": (y * 2 ** 31).astype(np.int32),
            "uint8": (y * 127 + 128).astype(np.uint8), "float32": y * 1.5,  # clipped on read
            "stereo": np.stack([(y * 32767).astype(np.int16),
                                (0.5 * y * 32767).astype(np.int16)], 1)}[kind]
    path = str(tmp_path / "a.wav")
    wavfile.write(path, 24000, data)
    ours, sr = audio_io.load_wav(path, target_sr=target_sr)
    ref, ref_sr = jax_audio.load_wav(path, target_sr=target_sr)
    assert sr == ref_sr and ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    assert audio_io.wav_duration(path) == jax_audio.wav_duration(path)


def test_save_resample_trim_match_jax(tmp_path):
    y = np.concatenate([np.zeros(5000, np.float32), _tone(20000), 1e-4 * _tone(7000)])
    audio_io.save_wav(str(tmp_path / "ours" / "a.wav"), y * 3)
    jax_audio.save_wav(str(tmp_path / "ref" / "a.wav"), y * 3)
    assert (tmp_path / "ours" / "a.wav").read_bytes() == (tmp_path / "ref" / "a.wav").read_bytes()
    for sr_in, sr_out in ((22050, 16000), (48000, 22050), (16000, 16000)):
        np.testing.assert_array_equal(audio_io.resample(y, sr_in, sr_out),
                                      jax_audio.resample(y, sr_in, sr_out))
    np.testing.assert_array_equal(audio_io.trim_silence_db(y), jax_audio.trim_silence_db(y))
    assert len(audio_io.trim_silence_db(y)) < len(y)


def _dataset(tmp_path):
    ds = tmp_path / "ds"
    (ds / "wavs").mkdir(parents=True)
    for name in ("a", "b", "c.x"):
        audio_io.save_wav(str(ds / "wavs" / f"{name}.wav"), _tone(4000))
    (ds / "metadata.csv").write_text(
        "a.wav|first line|extra\n\nmissing.wav|no wav\nb|second line\nc.x.wav|third\n"
        "a.wav\n", encoding="utf-8")
    return str(ds)


def test_read_metadata_matches_jax(tmp_path):
    ds = _dataset(tmp_path)
    ours, ref = dataset.read_metadata(ds), jax_dataset.read_metadata(ds)
    assert [vars(u) for u in ours] == [vars(u) for u in ref]
    assert [u.item_id for u in ours] == ["a", "b", "c.x", "a"]


class _Cache:
    def __init__(self, ds, module):
        self.cache_dir = os.path.join(ds, "cache")
        os.makedirs(self.cache_dir, exist_ok=True)
        self.items = module.read_metadata(ds)
        module.drop_known_corrupt(self)


@pytest.mark.parametrize("healer,reader", [(dataset, jax_dataset), (jax_dataset, dataset)])
def test_corrupt_healing_persists_across_packages(tmp_path, healer, reader):
    """Healing drops the item and records its wav once; a cache made later,
    by either package, leaves it out."""
    ds = _dataset(tmp_path)
    cache = _Cache(ds, healer)
    bad = cache.items[1]
    healer.heal_corrupt_item(cache, bad)
    healer.heal_corrupt_item(cache, bad)  # recorded once
    assert bad.item_id not in [u.item_id for u in cache.items]
    path = healer.corrupt_wavs_path(cache.cache_dir)
    assert open(path, encoding="utf8").read() == bad.wav_path + "\n"
    assert reader.load_corrupt_list(cache.cache_dir) == {bad.wav_path}
    later = _Cache(ds, reader)
    assert [u.item_id for u in later.items] == ["a", "c.x", "a"]
    # a postprocessed path is recorded as given
    healer.heal_corrupt_item(cache, cache.items[0], bad_path="/elsewhere/a.wav")
    assert reader.load_corrupt_list(cache.cache_dir) == {bad.wav_path, "/elsewhere/a.wav"}


def test_atomic_savez_matches_jax(tmp_path):
    arrays = {"linear": np.arange(12, dtype=np.float32).reshape(3, 4),
              "tokens": np.arange(5, dtype=np.int32), "lang_id": np.int32(5)}
    dataset.atomic_savez(str(tmp_path / "ours.npz"), **arrays)
    jax_dataset.atomic_savez(str(tmp_path / "ref.npz"), **arrays)
    assert sorted(os.listdir(tmp_path)) == ["ours.npz", "ref.npz"]  # no temporary left
    with np.load(tmp_path / "ours.npz") as a, np.load(tmp_path / "ref.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_atomic_savez_leaves_no_npz_on_failure(tmp_path, monkeypatch):
    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", fail)
    with pytest.raises(OSError):
        dataset.atomic_savez(str(tmp_path / "x.npz"), a=np.zeros(3))
    assert not any(f.endswith(".npz") for f in os.listdir(tmp_path))


@pytest.mark.parametrize("first,second", [(dataset, jax_dataset), (jax_dataset, dataset)])
def test_sticky_mel_variant_across_packages(tmp_path, first, second):
    d = str(tmp_path)
    assert first.sticky_mel_variant(d, "fft") == "fft"
    assert second.sticky_mel_variant(d, "pallas") == "fft"  # the pin wins
    assert open(os.path.join(d, ".mel_variant"), encoding="utf8").read() == "fft"
    with open(os.path.join(d, ".mel_variant"), "w", encoding="utf8") as f:
        f.write("garbage")
    assert second.sticky_mel_variant(d, "pallas") == "pallas"  # an unknown pin is replaced
    assert first.sticky_mel_variant(d, "fft") == "pallas"


def _npz_dir(path, n=4, seed=0):
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        frames = int(rng.integers(40, 90))
        np.savez(os.path.join(path, f"item{i}.npz"),
                 linear=rng.random((513, frames)).astype(np.float32),
                 pitch=rng.standard_normal(frames).astype(np.float32),
                 tokens=rng.integers(0, 500, 7 + i).astype(np.int32),
                 wav=rng.standard_normal(frames * 256 + 3).astype(np.float32),
                 lang_id=np.int32(5))
    with open(os.path.join(path, "leftover.npz.tmp"), "wb") as f:
        f.write(b"partial")


@pytest.mark.parametrize("writer,reader", [(packed, jax_packed), (jax_packed, packed)])
def test_pack_read_by_the_other_package(tmp_path, writer, reader):
    d = str(tmp_path / "c")
    _npz_dir(d)
    idx = writer.pack_cache(d)
    r = reader.PackedReader(d)
    assert r and idx.endswith(reader.PACK_IDX)
    for i in range(4):
        got = r.load(f"item{i}")
        assert got["linear"].ctypes.data % 64 == 0  # 64-byte aligned views
        with np.load(os.path.join(d, f"item{i}.npz")) as z:
            assert set(got) == set(z.files)
            for k in z.files:
                assert got[k].dtype == z[k].dtype
                np.testing.assert_array_equal(got[k], z[k])
    # up to date for the other package too: no rewrite
    m0 = os.path.getmtime(idx)
    time.sleep(0.05)
    reader.pack_cache(d)
    assert os.path.getmtime(idx) == m0


def test_pack_bytes_equal_jax(tmp_path):
    for name, mod in (("ours", packed), ("ref", jax_packed)):
        _npz_dir(str(tmp_path / name))
        mod.pack_cache(str(tmp_path / name))
    assert ((tmp_path / "ours" / "packed.bin").read_bytes()
            == (tmp_path / "ref" / "packed.bin").read_bytes())
    ours = json.loads((tmp_path / "ours" / "packed_index.json").read_text())
    ref = json.loads((tmp_path / "ref" / "packed_index.json").read_text())
    assert ours["items"] == ref["items"] and ours["bin_size"] == ref["bin_size"]
    assert [s[0] for s in ours["stamp"]] == [s[0] for s in ref["stamp"]]


@pytest.mark.parametrize("writer,reader", [(packed, jax_packed), (jax_packed, packed)])
def test_stale_pack_refused_and_rebuilt(tmp_path, writer, reader):
    d = str(tmp_path / "c")
    _npz_dir(d, n=3)
    writer.pack_cache(d)
    bin_path = os.path.join(d, "packed.bin")
    with open(bin_path, "r+b") as f:
        f.truncate(os.path.getsize(bin_path) // 2)
    assert not reader.PackedReader(d)
    reader.pack_cache(d)
    assert writer.PackedReader(d).load("item0") is not None
    os.remove(bin_path)
    reader.pack_cache(d)
    assert writer.PackedReader(d)


def test_prefetcher_order_and_values():
    src = list(range(20))
    pf = Prefetcher(iter(src), transform=lambda x: x * 2, depth=2)
    assert list(pf) == [x * 2 for x in src]


def test_prefetcher_propagates_exceptions():
    def gen():
        yield 1
        raise ValueError("boom")

    it = iter(Prefetcher(gen()))
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        next(it)


def test_prefetcher_transform_exception_at_its_position():
    def transform(x):
        if x == 3:
            raise KeyError("bad batch")
        return x

    it = iter(Prefetcher(iter(range(6)), transform=transform))
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(KeyError, match="bad batch"):
        next(it)


def test_prefetcher_close_stops_worker():
    produced = []

    def gen():
        for i in range(10 ** 6):
            produced.append(i)
            yield i

    pf = Prefetcher(gen(), depth=2)
    it = iter(pf)
    for _ in range(3):
        next(it)
    pf.close()
    assert not pf._thread.is_alive()
    n = len(produced)
    time.sleep(0.1)
    assert len(produced) == n  # no production after close


def test_prefetcher_overlaps_producer_and_consumer():
    """The wall time of interleaved sleeps is under their serial sum."""

    def slow_gen():
        for i in range(6):
            time.sleep(0.05)  # "collate"
            yield i

    t0 = time.perf_counter()
    for _ in Prefetcher(slow_gen(), depth=3):
        time.sleep(0.05)  # "device step"
    assert time.perf_counter() - t0 < 0.55  # serial would be >= 0.6
