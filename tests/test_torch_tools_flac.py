"""The port's FLAC decoder (``xva_trainer_tpu_torch/csrc/flac_decode.cpp``
through ``xva_trainer_tpu_torch/native``) against the JAX package's
``native.decode_flac``, bit for bit, on every stream kind of
``tests/test_flac.py``: verbatim, constant and fixed subframes, stereo
modes, an odd tail, 8 to 24 bits, garbage, a truncated stream and a corrupt
total. The decoder builds here with the host compiler; its build and load
are checked too."""
import os

import numpy as np
import pytest

from flac_encoder import encode_flac
from xva_trainer_tpu import native as jax_native
from xva_trainer_tpu.tools import audio_tools as jat
from xva_trainer_tpu_torch import native
from xva_trainer_tpu_torch.tools import audio_tools as pat


def _pcm(n=9000, stereo=False, seed=0, bps=16):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050
    y = 0.5 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(n)
    x = np.clip(y * (2 ** (bps - 1) - 1), -(2 ** (bps - 1)),
                2 ** (bps - 1) - 1).astype(np.int64)
    if stereo:
        x = np.stack([x, (x * 0.7).astype(np.int64)], axis=1)
    return x


def _corrupt_total(raw: bytes) -> bytes:
    raw = bytearray(raw)
    raw[8 + 13] |= 0x0F  # STREAMINFO's 36-bit total → 2^36 - 1
    raw[8 + 14: 8 + 18] = b"\xFF\xFF\xFF\xFF"
    return bytes(raw)


STREAMS = {
    "verbatim_mono": lambda: encode_flac(_pcm()),
    "constant": lambda: encode_flac(np.full(5000, -1234, np.int64), subframe="constant"),
    "fixed1": lambda: encode_flac(_pcm(n=8192), subframe="fixed1"),
    "stereo_independent": lambda: encode_flac(_pcm(stereo=True)),
    "stereo_mid_side": lambda: encode_flac(_pcm(stereo=True, seed=3), stereo_mode="mid_side"),
    "stereo_fixed_mid_side": lambda: encode_flac(_pcm(stereo=True, seed=4), subframe="fixed1",
                                                 stereo_mode="mid_side"),
    "odd_tail": lambda: encode_flac(_pcm(n=4096 + 777)),
    "small_blocks_44k": lambda: encode_flac(_pcm(n=7000, seed=5), sr=44100, block_size=576),
    "bps8": lambda: encode_flac(_pcm(bps=8, seed=6), bps=8),
    "bps24": lambda: encode_flac(_pcm(bps=24, seed=7), bps=24),
    "garbage": lambda: b"fLaC" + np.random.default_rng(8).bytes(64),
    "not_flac": lambda: b"RIFF" + bytes(60),
    "truncated": lambda: encode_flac(_pcm(n=9000))[:-3000],
    "corrupt_total": lambda: _corrupt_total(encode_flac(_pcm(n=4096))),
}


@pytest.mark.parametrize("kind", list(STREAMS))
def test_decode_flac_matches_jax(kind, tmp_path):
    p = str(tmp_path / f"{kind}.flac")
    with open(p, "wb") as f:
        f.write(STREAMS[kind]())
    ours, ref = native.decode_flac(p), jax_native.decode_flac(p)
    assert (ours is None) == (ref is None)
    if kind in ("garbage", "not_flac", "truncated"):
        assert ours is None
        return
    if kind != "corrupt_total":
        assert ours is not None
    if ours is not None:
        assert ours[1] == ref[1] and ours[0].dtype == np.float32
        np.testing.assert_array_equal(ours[0], ref[0])


@pytest.mark.parametrize("target_sr", [22050, 16000, None])
def test_decode_any_flac_matches_jax(tmp_path, target_sr):
    p = str(tmp_path / "x.flac")
    with open(p, "wb") as f:
        f.write(encode_flac(_pcm(n=30000, stereo=True, seed=9), sr=44100))
    y, sr = pat.decode_any(p, target_sr)
    jy, jsr = jat.decode_any(p, target_sr)
    assert sr == jsr == (target_sr or 44100)
    np.testing.assert_array_equal(y, jy)


def test_rejected_stream_goes_to_ffmpeg(tmp_path, monkeypatch):
    p = str(tmp_path / "bad.flac")
    with open(p, "wb") as f:
        f.write(STREAMS["garbage"]())
    monkeypatch.setattr(pat, "_ffmpeg", lambda: None)
    with pytest.raises(RuntimeError, match="without ffmpeg"):
        pat.decode_any(p)


def test_build_is_keyed_by_the_source(tmp_path, monkeypatch):
    """The library's name carries the source's hash; an edited source is
    built anew into its own file, and a build without a compiler raises."""
    assert native.available()
    native.get_lib()
    assert native.library_path().exists()
    assert native.library_path().name.startswith("libflac_decode-")
    src = tmp_path / "flac_decode.cpp"
    src.write_text(native.SOURCE.read_text() + "\n// edited\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    edited = native.library_path()
    assert edited.parent == tmp_path / "build" and not edited.exists()
    native.build()
    assert edited.exists() and native.build() == ""
    monkeypatch.setattr(native, "SOURCE", tmp_path / "other.cpp")
    (tmp_path / "other.cpp").write_text("int f() { return 1; }\n")
    monkeypatch.setattr(native, "_compiler", lambda: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build()
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", tmp_path / "broken.cpp")
    monkeypatch.setattr(native, "_compiler", lambda: "g++")
    with pytest.raises(RuntimeError, match="build of the FLAC decoder failed"):
        native.build()
    assert sorted(os.listdir(tmp_path / "build")) == [edited.name]
