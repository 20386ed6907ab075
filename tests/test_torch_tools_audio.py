"""The port's eight audio tools and WER evaluation
(``xva_trainer_tpu_torch/tools/audio_tools.py``, ``text_tools.py``) held to
the JAX package's on the same seeded inputs: wavs at 22.05 and 44.1 kHz,
mono and stereo, FLAC, PCM ``.wem`` files (``chip_smoke.pcm_wem``), a long
recording with its ``.srt``, and a metadata pair.

Each tool runs through ``runTask`` once in each package, on its own copy of
the inputs. The events, the output file names, every wav's rate and int16
samples, and every other file's bytes must be equal. The JAX package reads
wavs with scipy and measures loudness in numpy here, as the port does (its
``native`` decode_wav and integrated_loudness patched to ``None``); its FLAC
decode stays its C++ decoder, the JAX package's only FLAC path, which the
port's copy must match bit for bit. Then ``find_silences``,
``parse_srt``/``format_srt``, ``decode_wem_pcm`` and ``normalize_sync``.
"""
import asyncio
import json
import os
import shutil
import struct

import numpy as np
import pytest
from scipy.io import wavfile

from chip_smoke import WEM_VARIANTS, pcm_wem
from flac_encoder import encode_flac
from xva_trainer_tpu import native as jax_native
from xva_trainer_tpu.tools import audio_tools as jat
from xva_trainer_tpu.tools import text_tools as jtt
from xva_trainer_tpu_torch.tools import audio_tools as pat
from xva_trainer_tpu_torch.tools import text_tools as ptt

SR = 22050


@pytest.fixture(autouse=True)
def jax_scipy_paths(monkeypatch):
    monkeypatch.setattr(jax_native, "decode_wav", lambda path: None)
    monkeypatch.setattr(jax_native, "integrated_loudness", lambda y, fs: None)


class FakeWS:
    def __init__(self):
        self.sent = []

    async def send(self, msg):
        self.sent.append(json.loads(msg))


def speechy(rng, seconds, sr=SR, gaps=((0.35, 0.5),)):
    """A harmonic voice with a syllable envelope, quiet noise, and silent
    gaps at the given (start fraction, seconds)."""
    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(100, 260)
    y = sum((0.6 ** k) * np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6)) for k in range(1, 7))
    y *= 0.25 * (0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2, 5) * t))
    for frac, dur in gaps:
        a = int(frac * len(t))
        y[a: a + int(dur * sr)] = 0.0
    y[: int(0.3 * sr)] = 0.0  # head padding
    y[-int(0.25 * sr):] = 0.0  # tail padding
    return (y + 1e-4 * rng.standard_normal(len(t))).astype(np.float32)


def to_int(y, bits=16):
    return np.clip(np.round(y * (2 ** (bits - 1) - 1)), -(2 ** (bits - 1)),
                   2 ** (bits - 1) - 1).astype(np.int64)


def make_inputs(root):
    """The seeded inputs under ``root``: ``clips/`` (wavs at 22.05 and
    44.1 kHz, mono and stereo, and FLACs), ``noise.wav``, ``long.wav`` with
    ``long.srt``, ``wems/`` and a metadata pair."""
    rng = np.random.default_rng(2024)
    clips = root / "clips"
    clips.mkdir(parents=True)
    for i in range(3):
        wavfile.write(str(clips / f"a{i}.wav"), SR, to_int(speechy(rng, 2 + i)).astype(np.int16))
    for i in range(2):
        left, right = speechy(rng, 2.5, 44100), speechy(rng, 2.5, 44100)
        wavfile.write(str(clips / f"b{i}.wav"), 44100,
                      to_int(np.stack([left, 0.8 * right], 1)).astype(np.int16))
    (clips / "c0.flac").write_bytes(encode_flac(to_int(speechy(rng, 3.0))))
    st = to_int(np.stack([speechy(rng, 2.2, 44100), speechy(rng, 2.2, 44100)], 1))
    (clips / "c1.flac").write_bytes(encode_flac(st, sr=44100, stereo_mode="mid_side"))
    (clips / "notes.txt").write_text("not audio")
    noise = 0.01 * rng.standard_normal(SR).astype(np.float32)
    wavfile.write(str(root / "noise.wav"), SR, to_int(noise).astype(np.int16))
    # a long recording: six turns, each an .srt entry; one too short to keep
    turns, pieces, t = [], [], 0.0
    for i, d in enumerate((2.0, 1.5, 0.1, 2.5, 1.0, 2.0)):
        y = speechy(rng, d, gaps=())
        pieces += [y, np.zeros(int(0.4 * SR), np.float32)]
        turns.append({"start": t, "end": t + d, "text": f"line {i} of the recording"})
        t += d + 0.4
    wavfile.write(str(root / "long.wav"), SR, to_int(np.concatenate(pieces)).astype(np.int16))
    (root / "long.srt").write_text(jat.format_srt(turns), encoding="utf-8")
    wems = root / "wems"
    wems.mkdir()
    for i, v in enumerate(WEM_VARIANTS):
        (wems / f"w{i}_{v}.wem").write_bytes(pcm_wem(speechy(rng, 1.0, 48000), 48000, v))
    words = "the quick brown fox jumps over a lazy dog while seven voices sing".split()
    user, asr = [], []
    for i in range(12):
        ref = list(rng.choice(words, size=int(rng.integers(3, 9))))
        hyp = list(ref)
        for _ in range(int(rng.integers(0, 3))):
            j = int(rng.integers(len(hyp)))
            hyp[j] = str(rng.choice(words)) if rng.random() < 0.7 else ""
        user.append(f"clip{i}.wav|{' '.join(ref)}")
        if i != 5:  # one line the ASR pass missed
            asr.append(f"clip{i}|{' '.join(w for w in hyp if w)}|extra column")
    (root / "user.csv").write_text("\n".join(user) + "\nno separator here\n", encoding="utf-8")
    (root / "asr.csv").write_text("\n".join(asr), encoding="utf-8")


def requests(root):
    out = str(root / "out")
    return {
        "formatting": {"inPath": str(root / "clips"), "outputDirectory": out},
        "normalize": {"inputDirectory": str(root / "clips"), "outputDirectory": out},
        "silence_cut": {"inPath": str(root / "clips"), "outputDirectory": out,
                        "toolSettings": {"maxSilenceMS": 200, "silenceThresholdDB": -45}},
        "silence_split": {"inPath": str(root / "clips"), "outputDirectory": out,
                          "toolSettings": {"minSilenceDurationMS": 300}},
        "cut_padding": {"inPath": str(root / "clips"), "outputDirectory": out},
        "noise_removal": {"inPath": str(root / "clips"), "noiseProfile": str(root / "noise.wav"),
                          "outputDirectory": out, "toolSettings": {"strength": 0.5}},
        "srt_split": {"inPath": str(root / "long.wav"), "srtPath": str(root / "long.srt"),
                      "outputDirectory": out},
        "wem2ogg": {"inPath": str(root / "wems"), "outputDirectory": out},
        "wer_evaluation": {"userMetadata": str(root / "user.csv"),
                           "asrMetadata": str(root / "asr.csv"),
                           "outputFile": str(root / "out" / "wer_report.txt")},
    }


TOOLS = {
    "formatting": (jat.AudioFormatTool, pat.AudioFormatTool),
    "normalize": (jat.AudioNormalizeTool, pat.AudioNormalizeTool),
    "silence_cut": (jat.SilenceCutTool, pat.SilenceCutTool),
    "silence_split": (jat.SilenceSplitTool, pat.SilenceSplitTool),
    "cut_padding": (jat.CutPaddingTool, pat.CutPaddingTool),
    "noise_removal": (jat.NoiseRemovalTool, pat.NoiseRemovalTool),
    "srt_split": (jat.SrtSplitTool, pat.SrtSplitTool),
    "wem2ogg": (jat.Wem2OggTool, pat.Wem2OggTool),
    "wer_evaluation": (jtt.WerEvaluationTool, ptt.WerEvaluationTool),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("inputs")
    make_inputs(root)
    return root


def outputs(out_dir):
    """{relative path: (rate, int16 samples) for a wav, bytes otherwise}."""
    files = {}
    for d, _, names in os.walk(out_dir):
        for n in names:
            p = os.path.join(d, n)
            if n.endswith(".wav"):
                files[os.path.relpath(p, out_dir)] = wavfile.read(p)
            else:
                with open(p, "rb") as f:
                    files[os.path.relpath(p, out_dir)] = f.read()
    return files


@pytest.mark.parametrize("key", list(TOOLS))
def test_tool_matches_jax(key, inputs, tmp_path):
    got = {}
    for side, cls in zip(("jax", "torch"), TOOLS[key]):
        root = tmp_path / side
        shutil.copytree(inputs, root)
        (root / "out").mkdir()
        tool = cls() if side == "jax" else cls(device="cpu")
        ws = FakeWS()
        asyncio.run(tool.runTask(requests(root)[key], ws))
        events = [{**e, "data": e["data"].replace(str(root), "<root>")} for e in ws.sent]
        got[side] = (events, outputs(root / "out"))
    (jev, jout), (tev, tout) = got["jax"], got["torch"]
    assert tev == jev and tev[-1]["key"] == "tasks_next", tev
    assert sorted(tout) == sorted(jout)
    wavs = [k for k in tout if k.endswith(".wav")]
    assert wavs or key == "wer_evaluation", sorted(tout)
    for name in tout:
        if name.endswith(".wav"):
            assert tout[name][0] == jout[name][0], name
            assert tout[name][1].dtype == np.int16
            np.testing.assert_array_equal(tout[name][1], jout[name][1], err_msg=name)
        else:
            assert tout[name] == jout[name], name
    if key == "formatting":  # every clip converted, FLAC and 44.1 kHz stereo included
        assert sorted(wavs) == ["a0.wav", "a1.wav", "a2.wav", "b0.wav", "b1.wav", "c0.wav",
                                "c1.wav"]
        assert {tout[w][0] for w in wavs} == {SR} and all(tout[w][1].ndim == 1 for w in wavs)
    if key == "wem2ogg":
        assert len(wavs) == len(WEM_VARIANTS)


def test_normalize_sync_matches_jax(inputs, tmp_path):
    for name in ("a1.wav", "b0.wav", "c1.flac"):
        src = str(inputs / "clips" / name)
        j = jat.AudioNormalizeTool().normalize_sync(src, str(tmp_path / ("j_" + name)))
        p = pat.AudioNormalizeTool(device="cpu").normalize_sync(src, str(tmp_path / ("p_" + name)))
        np.testing.assert_array_equal(wavfile.read(p)[1], wavfile.read(j)[1])


@pytest.mark.parametrize("thr,min_s", [(-40.0, 0.3), (-45.0, 0.2), (-30.0, 0.5)])
def test_find_silences_matches_jax(inputs, thr, min_s):
    for name in ("a0.wav", "a2.wav", "b1.wav", "c0.flac"):
        y, sr = pat.decode_any(str(inputs / "clips" / name))
        assert pat.find_silences(y, sr, thr, min_s) == jat.find_silences(y, sr, thr, min_s)
    assert pat.find_silences(np.zeros(SR, np.float32), SR) == [(0, SR)]


def test_srt_parse_and_format_match_jax():
    text = ("1\n00:00:01,000 --> 00:00:02,500\nHello there.\n\n"
            "2\r\n00:00:03.250 --> 00:00:04.999\r\ntwo\r\nlines\r\n\n\n"
            "garbage block\n\n3\n00:01:00,5 --> 01:00:00,0\nlast\n\n4\nno times\n")
    assert pat.parse_srt(text) == jat.parse_srt(text)
    entries = pat.parse_srt(text) + [{"start": 0.9995, "end": 3599.9999, "text": "edge"},
                                     {"start": 59.99951, "end": 61.0004, "text": "round"}]
    assert pat.format_srt(entries) == jat.format_srt(entries)
    assert pat.parse_srt(pat.format_srt(entries)) == jat.parse_srt(jat.format_srt(entries))


def test_decode_wem_pcm_matches_jax(inputs, tmp_path):
    for p in sorted((inputs / "wems").iterdir()):
        a, b = pat.decode_wem_pcm(str(p)), jat.decode_wem_pcm(str(p))
        assert a[1] == b[1] == 48000 and a[0].dtype == np.float32
        np.testing.assert_array_equal(a[0], b[0])
    # a Vorbis tag, a broken header and a non-RIFF file give None in both
    vorbis = bytearray(pcm_wem(np.zeros(100, np.float32), 48000, "pcm16"))
    vorbis[20:22] = struct.pack("<H", 0xFFFF)
    for i, blob in enumerate((bytes(vorbis), b"RIFF\x04\x00\x00\x00WAVX", b"OggS" + bytes(40))):
        (tmp_path / f"x{i}.wem").write_bytes(blob)
        assert pat.decode_wem_pcm(str(tmp_path / f"x{i}.wem")) is None
        assert jat.decode_wem_pcm(str(tmp_path / f"x{i}.wem")) is None


def test_wer_matches_jax():
    pairs = [("a b c", "a b c"), ("A b C", "a B c"), ("a b c d", "a x c"), ("", ""), ("", "x"),
             ("one two", ""), ("the cat sat", "cat sat the"), ("x y z w", "x  y   w z q")]
    for r, h in pairs:
        assert ptt.wer(r, h) == jtt.wer(r, h)
