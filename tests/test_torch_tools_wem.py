"""The port's Wwise-Vorbis rebuild (``xva_trainer_tpu_torch/tools/
wwise_vorbis.py``), its libvorbis bindings (``native/vorbis.py``) and the
``wem2ogg`` tool on Vorbis ``.wem`` files, held to the JAX package's.

The fixtures are real Vorbis streams (libvorbisenc packets) stripped into
the triad, inline and external-codebook containers by ``tests/
wem_fixture.py``; the port's rebuilt Ogg must be byte for byte the JAX
package's. The shipped codebook library is a copy, and every one of its
598 books re-inflates to JAX's bytes. The cases that need libvorbis skip
with a reason where the system libraries are missing, as
``tests/test_wem2ogg.py`` does.
"""
import asyncio
import hashlib
import json

import numpy as np
import pytest

from xva_trainer_tpu.native import vorbis as jvorbis
from xva_trainer_tpu.tools import audio_tools as jat
from xva_trainer_tpu.tools import wwise_vorbis as jww
from xva_trainer_tpu_torch.native import vorbis as pvorbis
from xva_trainer_tpu_torch.tools import audio_tools as pat
from xva_trainer_tpu_torch.tools import wwise_vorbis as pww


@pytest.fixture(scope="module")
def vorbis_packets():
    """2 s of an amplitude-modulated sine, encoded to raw Vorbis packets."""
    if not (jvorbis.available() and pvorbis.available()):
        pytest.skip("system libvorbis not present")
    sr = 22050
    t = np.arange(sr * 2) / sr
    pcm = (0.3 * np.sin(2 * np.pi * 440 * t)
           * (0.6 + 0.4 * np.sin(2 * np.pi * 2 * t))).astype(np.float32)
    out = pvorbis.encode_ogg_packets(pcm, sr)
    assert out is not None
    headers, audio = out
    return pcm, sr, headers, audio


def _wems(headers, audio, sr, tmp_path):
    """Each container variant, from JAX's fixture and from the port-bound
    one: {variant: (wem bytes, codebook path or None)}."""
    import torch_wem_fixture
    import wem_fixture

    out = {}
    for variant in ("triad", "inline", "external"):
        kw_j, kw_p = {}, {}
        if variant == "external":
            kw_j["packed_books"], kw_p["packed_books"] = [], []
        wem = wem_fixture.build_wem(headers, audio, 1, sr, variant, **kw_j)
        assert torch_wem_fixture.build_wem(headers, audio, 1, sr, variant, **kw_p) == wem
        pcb = None
        if variant == "external":
            assert kw_p["packed_books"] == kw_j["packed_books"]
            pcb = str(tmp_path / "game.pcb")
            pww.write_packed_library(kw_p["packed_books"], pcb)
            jww.write_packed_library(kw_j["packed_books"], str(tmp_path / "game_jax.pcb"))
            assert (tmp_path / "game_jax.pcb").read_bytes() == (tmp_path / "game.pcb").read_bytes()
        out[variant] = (wem, pcb)
    return out


def test_codebook_library_is_a_copy_and_rebuilds_as_jax():
    with open(pww.DEFAULT_CODEBOOKS, "rb") as a, open(jww.DEFAULT_CODEBOOKS, "rb") as b:
        assert hashlib.sha256(a.read()).digest() == hashlib.sha256(b.read()).digest()
    assert "xva_trainer_tpu_torch" in pww.DEFAULT_CODEBOOKS
    lib, jlib = pww.CodebookLibrary(), jww.CodebookLibrary()
    assert lib.count == jlib.count == 598
    for i in range(lib.count):
        assert lib.get(i) == jlib.get(i)
        bw, jbw = pww.BitWriter(), jww.BitWriter()
        lib.rebuild(i, bw)
        jlib.rebuild(i, jbw)
        assert bw.to_bytes() == jbw.to_bytes(), i
        br = pww.BitReader(bw.to_bytes())
        pww.copy_vorbis_codebook(br, pww.BitWriter())
        assert br.remaining() < 8, f"codebook {i} misparsed"


def test_library_round_trip(tmp_path):
    lib = pww.CodebookLibrary()
    books = [lib.get(i) for i in range(0, lib.count, 7)]
    path = str(tmp_path / "sub.pcb")
    pww.write_packed_library(books, path)
    jww.write_packed_library(books, str(tmp_path / "sub_jax.pcb"))
    assert (tmp_path / "sub.pcb").read_bytes() == (tmp_path / "sub_jax.pcb").read_bytes()
    back = pww.CodebookLibrary(path)
    assert back.count == len(books) and [back.get(i) for i in range(back.count)] == books


@pytest.mark.parametrize("variant", ["triad", "inline", "external"])
def test_wem_to_ogg_bytes_equal_jax(variant, vorbis_packets, tmp_path):
    pcm, sr, headers, audio = vorbis_packets
    wem, pcb = _wems(headers, audio, sr, tmp_path)[variant]
    ogg = pww.wem_to_ogg(wem, codebook_path=pcb)
    assert ogg == jww.wem_to_ogg(wem, codebook_path=pcb)
    p = str(tmp_path / f"{variant}.ogg")
    with open(p, "wb") as f:
        f.write(ogg)
    y, rate = pvorbis.decode_ogg(p)
    jy, jrate = jvorbis.decode_ogg(p)
    assert rate == jrate == sr
    np.testing.assert_array_equal(y, jy)
    n = min(len(y), len(pcm))
    assert np.corrcoef(y[:n], pcm[:n])[0, 1] > 0.99


def test_corrupt_stream_raises(vorbis_packets, tmp_path):
    pcm, sr, headers, audio = vorbis_packets
    wem, pcb = _wems(headers, audio, sr, tmp_path)["external"]
    cut = wem[: len(wem) // 2]
    with pytest.raises(pww.WemParseError):
        pww.wem_to_ogg(cut, codebook_path=pcb)
    with pytest.raises(jww.WemParseError):
        jww.wem_to_ogg(cut, codebook_path=pcb)
    with pytest.raises(pww.WemParseError):
        pww.wem_to_ogg(b"RIFF" + bytes(40))
    bad = str(tmp_path / "bad.ogg")
    with open(bad, "wb") as f:
        f.write(b"OggS" + bytes(100))
    with pytest.raises(ValueError):
        pvorbis.decode_ogg(bad)


def test_wem2ogg_tool_and_decode_any_match_jax(vorbis_packets, tmp_path):
    """The tool, with ``toWav``, on a folder of external-codebook .wem with
    its custom library, then on a folder of inline .wem with a corrupt one:
    the same .ogg and .wav files, and the same ``tasks_error`` naming the
    corrupt file once the others are written; then ``decode_any`` on a
    Vorbis .wem."""
    pcm, sr, headers, audio = vorbis_packets
    wems = _wems(headers, audio, sr, tmp_path)
    files = {}
    for side, cls in (("jax", jat.Wem2OggTool), ("torch", pat.Wem2OggTool)):
        ext, inline, out = (tmp_path / side / d for d in ("ext", "inline", "out"))
        ext.mkdir(parents=True)
        inline.mkdir()
        (ext / "ext.wem").write_bytes(wems["external"][0])
        for name in ("one", "two"):
            (inline / f"{name}.wem").write_bytes(wems["inline"][0])
        (inline / "bad.wem").write_bytes(wems["inline"][0][:300])
        sent = []

        class WS:
            async def send(self, msg):
                sent.append(json.loads(msg))

        tool = cls() if side == "jax" else cls(device="cpu")
        for req in ({"inPath": str(ext), "codebooksPath": wems["external"][1]},
                    {"inPath": str(inline)}):
            asyncio.run(tool.runTask({**req, "outputDirectory": str(out), "toWav": True}, WS()))
        files[side] = ({p.name: p.read_bytes() for p in sorted(out.iterdir())},
                       [e["key"] for e in sent], sent[-1]["data"].splitlines()[-1])
    assert files["torch"] == files["jax"]
    names, keys, last = files["torch"]
    assert {"ext.ogg", "ext.wav", "one.ogg", "one.wav", "two.ogg", "two.wav"} <= set(names)
    assert keys == ["tasks_next", "tasks_error"] and "bad.wem" in last, (keys, last)
    p = str(tmp_path / "x.wem")
    with open(p, "wb") as f:
        f.write(wems["inline"][0])
    for target in (sr, 16000):
        y, rate = pat.decode_any(p, target)
        jy, jrate = jat.decode_any(p, target)
        assert rate == jrate == target
        np.testing.assert_array_equal(y, jy)
