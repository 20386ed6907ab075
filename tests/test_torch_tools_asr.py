"""The port's three model tools (``xva_trainer_tpu_torch/tools/text_tools.py``:
``transcribe``, ``make_srt``, ``ass``) and ``/checkTextQuality`` held to the
JAX package's through ``runTask`` (and the servers' HTTP handlers), each
package on its own copy of the same seeded inputs and weights: a narrow
whisper ``.pt`` (``tests/torch_asr_common.py``) with a tiktoken table
beside it, a narrow HuggingFace wav2vec2 directory, JAX's seeded speaker
encoder carried across (as in ``test_torch_tools_diarize.py``), and the
shipped enhancer. Both packages decode wavs with scipy.

- ``transcribe`` (whisper, ``whisper_lang`` "detect"; then a resume that
  fills an empty row in place) and ``transcribe`` (wav2vec2): the events
  and ``metadata.csv`` bytes equal;
- ``make_srt``: the ``.srt`` bytes equal;
- ``ass``: the int16 samples within one step;
- with no ASR model, the ``tasks_error`` (the port's names its own CLI);
  an orbax directory for ``ass``: a ``tasks_error``;
- ``/checkTextQuality`` then ``/textQualityStatus``: the status and
  ``wer_report.txt`` bytes equal.
"""
import asyncio
import json
import os
import shutil

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from formant_speech import build_conversation
from torch_asr_common import (WHISPER_NARROW, voiced, w2v_params, whisper_params,
                              write_hf_wav2vec2, write_openai_pt, write_tiktoken)
from torch_tools_common import seeded_variables
from xva_trainer_tpu import native
from xva_trainer_tpu.app import server as jax_server
from xva_trainer_tpu.models.speaker_encoder import SpeakerEncoder as JaxSpeakerEncoder
from xva_trainer_tpu.tools import text_tools as jtt
from xva_trainer_tpu_torch.app import server as torch_server
from xva_trainer_tpu_torch.app.manager import ModelsManager
from xva_trainer_tpu_torch.data.audio_io import resample, save_wav
from xva_trainer_tpu_torch.interop.convert import speaker_encoder_state_dict
from xva_trainer_tpu_torch.models.speaker_encoder import SpeakerEncoder
from xva_trainer_tpu_torch.tools import text_tools as ptt

SR = 22050
# English-only, 1 000 tokens: the tools' 224-token greedy decodes stay quick
WHISPER_SMALL_VOCAB = dict(WHISPER_NARROW, n_vocab=1000)


@pytest.fixture(autouse=True)
def scipy_only(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    monkeypatch.delenv("XVA_WHISPER_CKPT", raising=False)
    monkeypatch.delenv("XVA_ASS_CKPT", raising=False)
    for cls in (jtt.TranscribeTool, ptt.TranscribeTool):
        monkeypatch.setattr(cls, "_asr_backend", None)
    for cls in (jtt.SourceSeparationTool, ptt.SourceSeparationTool):
        monkeypatch.setattr(cls, "_model_backend", None)
    torch.set_num_threads(2)


class FakeWS:
    def __init__(self):
        self.sent = []

    async def send(self, msg):
        self.sent.append(json.loads(msg))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """{name: path}: whisper .pts (the multilingual one with a tiktoken
    table beside it) and a wav2vec2 directory."""
    root = tmp_path_factory.mktemp("weights")
    out = {}
    for name, kw, seed in (("whisper", WHISPER_NARROW, 0),
                           ("whisper_en", WHISPER_SMALL_VOCAB, 1)):
        d = root / name
        d.mkdir()
        params, _ = whisper_params(kw, seed=seed)
        out[name] = write_openai_pt(d / "whisper.pt", params, kw)
        write_tiktoken(d / ("multilingual.tiktoken" if kw["n_vocab"] > 2000 else "gpt2.tiktoken"),
                       n=50257 if kw["n_vocab"] > 2000 else 893, seed=seed)
    out["wav2vec2"] = write_hf_wav2vec2(str(root / "w2v"), w2v_params(seed=3)[0])
    return out


def clips(d, n=3, seed=0):
    """``n`` voiced clips at 22.05 kHz of 1.5 s upwards, one of them stereo
    at 44.1 kHz."""
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        y = resample(voiced(1.5 + i, sr=16000, seed=seed + i), 16000, SR)
        if i == 1:
            st = np.stack([resample(y, SR, 44100)] * 2, 1)
            wavfile.write(os.path.join(d, f"c{i}.wav"), 44100,
                          (np.clip(st, -1, 1) * 32767).astype(np.int16))
        else:
            save_wav(os.path.join(d, f"c{i}.wav"), y)
    return d


def run_both(tmp_path, tools, data_of, inputs):
    """Each package's tool on its own copy of ``inputs``: (events, files)."""
    out = {}
    for side, tool in zip(("jax", "torch"), tools):
        root = tmp_path / side
        shutil.copytree(inputs, root)
        ws = FakeWS()
        asyncio.run(tool.runTask(data_of(root), ws))
        events = [{**e, "data": e["data"].replace(str(root), "<root>")} for e in ws.sent]
        files = {}
        for d, _, names in os.walk(root):
            for n in names:
                p = os.path.join(d, n)
                with open(p, "rb") as f:
                    files[os.path.relpath(p, root)] = f.read()
        out[side] = (events, files)
    return out


def test_transcribe_whisper_matches_jax(weights, tmp_path):
    inputs = tmp_path / "in"
    clips(str(inputs / "wavs"), n=2)
    data = lambda root: {"inPath": str(root / "wavs"), "outputDirectory": str(root / "asr"),
                         "toolSettings": {"modelPath": weights["whisper"],
                                          "whisper_lang": "detect"}}
    tools = (jtt.TranscribeTool(), ptt.TranscribeTool(device="cpu"))
    got = run_both(tmp_path / "fresh", tools, data, inputs)
    assert got["torch"] == got["jax"]
    events, files = got["torch"]
    assert events == [{"key": "tasks_next", "data": ""}]
    rows = files["asr/metadata.csv"].decode("utf-8").split("\n")
    assert [r.split("|")[0] for r in rows] == ["c0.wav", "c1.wav"]
    assert all(r.split("|")[1] for r in rows) and files["asr/.progress.txt"] == b"2/2"
    # a resume: c0 done, an empty row for c1 filled in place, a row of no file kept
    (inputs / "asr").mkdir()
    (inputs / "asr" / "metadata.csv").write_text("c0.wav|kept as it is\nc1|\ngone.wav|no file")
    got = run_both(tmp_path / "resume", tools, data, inputs)
    assert got["torch"] == got["jax"]
    rows = got["torch"][1]["asr/metadata.csv"].decode("utf-8").split("\n")
    assert [r.split("|")[0] for r in rows] == ["c0.wav", "c1", "gone.wav"]
    assert rows[0] == "c0.wav|kept as it is" and rows[1] != "c1|"


def test_transcribe_wav2vec2_matches_jax(weights, tmp_path):
    inputs = tmp_path / "in"
    clips(str(inputs / "wavs"), n=3, seed=7)
    data = lambda root: {"inPath": str(root / "wavs"), "outputDirectory": str(root / "asr"),
                         "toolSettings": {"modelPath": weights["wav2vec2"]}}
    got = run_both(tmp_path, (jtt.TranscribeTool(), ptt.TranscribeTool(device="cpu")), data,
                   inputs)
    assert got["torch"] == got["jax"]
    assert len(got["torch"][1]["asr/metadata.csv"].split(b"\n")) == 3
    # the loaded model is cached by its device too: none outlives a device change
    assert (weights["wav2vec2"], "en", "cpu") in ptt.TranscribeTool._asr_cache


def test_no_asr_model(tmp_path):
    events = {}
    for side, tool in (("jax", jtt.TranscribeTool()), ("torch", ptt.TranscribeTool(device="cpu"))):
        ws = FakeWS()
        asyncio.run(tool.runTask({"inPath": str(tmp_path), "outputDirectory": str(tmp_path)}, ws))
        events[side] = ws.sent
    assert [e["key"] for e in events["torch"]] == ["tasks_error"]
    assert events["torch"][0]["data"] == events["jax"][0]["data"].replace(
        "xva_trainer_tpu.cli", "xva_trainer_tpu_torch.cli")
    assert not os.path.exists(tmp_path / "metadata.csv")
    # cuda unless told cpu, and this host has no card
    for cls in (ptt.TranscribeTool, ptt.MakeSrtTool, ptt.SourceSeparationTool):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls()


def test_make_srt_matches_jax(weights, tmp_path):
    v = seeded_variables()
    mgr = ModelsManager(device="cpu")
    mgr.models_bank["speaker_encoder"] = SpeakerEncoder(
        state_dict=speaker_encoder_state_dict(v), device="cpu")

    class JaxManager:
        shared_cache = {"speaker_encoder": JaxSpeakerEncoder(params=v)}

    inputs = tmp_path / "in"
    (inputs / "talk").mkdir(parents=True)
    y, _ = build_conversation([(0, 2.5), (1, 2.0), (0, 2.0), (1, 2.5)], with_breaths=True,
                              seed=1)
    save_wav(str(inputs / "talk" / "talk.wav"), y)
    data = lambda root: {"inPath": str(root / "talk"), "outputDirectory": str(root / "srt"),
                         "toolSettings": {"modelPath": weights["whisper_en"]}}
    got = run_both(tmp_path, (jtt.MakeSrtTool(models_manager=JaxManager()),
                              ptt.MakeSrtTool(device="cpu", models_manager=mgr)), data, inputs)
    assert got["torch"] == got["jax"]
    srt = got["torch"][1]["srt/talk.srt"].decode("utf-8")
    assert srt.count(" --> ") >= 3 and "[speaker_" not in srt


def test_ass_matches_jax(tmp_path):
    from xva_trainer_tpu_torch.models.enhance.synth import make_pair

    inputs = tmp_path / "in"
    (inputs / "noisy").mkdir(parents=True)
    rng = np.random.default_rng(11)
    for i, s in enumerate((5.0, 2.0)):
        save_wav(str(inputs / "noisy" / f"n{i}.wav"), make_pair(s, 5.0, rng)[0])
    wavfile.write(str(inputs / "noisy" / "n2.wav"), 44100,
                  (make_pair(1.5, 5.0, rng)[0] * 32767).astype(np.int16))
    data = lambda root: {"inPath": str(root / "noisy"), "outputDirectory": str(root / "clean")}
    got = run_both(tmp_path, (jtt.SourceSeparationTool(), ptt.SourceSeparationTool(device="cpu")),
                   data, inputs)
    (jev, jfiles), (tev, tfiles) = got["jax"], got["torch"]
    assert tev == jev == [{"key": "tasks_next", "data": ""}]
    assert sorted(tfiles) == sorted(jfiles)
    outs = [k for k in tfiles if k.startswith("clean/") and k.endswith(".wav")]
    assert len(outs) == 3
    for k in outs:
        sr_t, t = wavfile.read(str(tmp_path / "torch" / k))
        sr_j, j = wavfile.read(str(tmp_path / "jax" / k))
        assert sr_t == sr_j and t.dtype == np.int16 and t.shape == j.shape
        assert np.abs(t.astype(np.int32) - j.astype(np.int32)).max() <= 1, k
    # an orbax directory (the JAX package's format) is refused by name
    ws = FakeWS()
    asyncio.run(ptt.SourceSeparationTool(device="cpu").runTask(
        {**data(tmp_path / "torch"), "toolSettings": {"modelPath": str(tmp_path)}}, ws))
    assert [e["key"] for e in ws.sent] == ["tasks_error"] and "orbax" in ws.sent[0]["data"]


def test_check_text_quality_matches_jax(weights, tmp_path, monkeypatch):
    status, report = {}, {}
    for side, mod in (("jax", jax_server), ("torch", torch_server)):
        root = tmp_path / side
        ds = root / "voice"
        clips(str(ds / "wavs"), n=3, seed=20)
        (ds / "metadata.csv").write_text("c0.wav|the first line\nc1.wav|a second one\n"
                                         "c2.wav|and the third")
        monkeypatch.chdir(root)
        srv = mod.AppServer()
        if side == "torch":
            asyncio.run(srv.handle_http("/setDevice", {"device": "cpu"}))

        async def go():
            body = {"path": str(ds), "toolSettings": {"modelPath": weights["whisper_en"]}}
            assert (await srv.handle_http("/checkTextQuality", body))["started"]
            await asyncio.wait_for(asyncio.shield(srv._tq_task), 300)
            return await srv.handle_http("/textQualityStatus", {"path": str(ds)})

        status[side] = asyncio.new_event_loop().run_until_complete(go())
        report[side] = (ds / "wer_report.txt").read_bytes()
    assert status["torch"] == status["jax"]
    assert status["torch"]["n_scored"] == 3 and "error" not in status["torch"]
    assert report["torch"] == report["jax"] and report["torch"].count(b"\n") == 3
