"""The port's diarization (``xva_trainer_tpu_torch/tools/diarize.py``,
``speaker_tools.diarize`` and ``DiarizationTool``) and DER metric
(``tools/der.py``) held to the JAX package's, with the JAX encoder's seeded
parameters carried across, on formant pseudo-speech mixtures of 2 and 3
speakers (``tests/formant_speech.py``, the DER harness's generator).

``window_embeddings``: the same windows and speech mask, the host blocks
bit for bit, the fused matrix within 1e-5 (its deep block z-scores
dimensions whose spread across windows is small, which magnifies the
encoders' 1e-7 differences to about 1e-6). ``diarize_turns``, the
clustering and the tool's files: equal. DER: equal.
"""
import asyncio
import json
import os

import numpy as np
import pytest
import torch

from formant_speech import build_conversation
from torch_tools_common import seeded_variables
from xva_trainer_tpu import native
from xva_trainer_tpu.models.speaker_encoder import SpeakerEncoder as JaxSpeakerEncoder
from xva_trainer_tpu.tools import der as jder
from xva_trainer_tpu.tools import diarize as jdz
from xva_trainer_tpu.tools import speaker_tools as jst
from xva_trainer_tpu_torch.app.manager import ModelsManager
from xva_trainer_tpu_torch.data.audio_io import resample, save_wav
from xva_trainer_tpu_torch.interop.convert import speaker_encoder_state_dict
from xva_trainer_tpu_torch.models.speaker_encoder import SpeakerEncoder
from xva_trainer_tpu_torch.tools import der as pder
from xva_trainer_tpu_torch.tools import diarize as pdz
from xva_trainer_tpu_torch.tools import speaker_tools as pst

MIXTURES = {
    "2spk": dict(spec=[(0, 2.5), (1, 2.0), (0, 2.0), (1, 2.5)], seed=1),
    "3spk": dict(spec=[(0, 2.5), (1, 2.0), (2, 2.5), (0, 2.0), (2, 2.0)], seed=3),
}


@pytest.fixture(autouse=True)
def scipy_only(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def encoders():
    v = seeded_variables()
    return JaxSpeakerEncoder(params=v), SpeakerEncoder(state_dict=speaker_encoder_state_dict(v),
                                                       device="cpu")


@pytest.fixture(scope="module")
def mixtures():
    out = {}
    for name, m in MIXTURES.items():
        y, ref = build_conversation(m["spec"], with_breaths=True, seed=m["seed"])
        out[name] = (y, ref, resample(y, 22050, 16000).astype(np.float32))
    return out


@pytest.mark.parametrize("name", list(MIXTURES))
def test_window_embeddings_match_jax(name, encoders, mixtures):
    jenc, penc = encoders
    y16 = mixtures[name][2]
    jspans, jemb, jspeech = jdz.window_embeddings(y16, jenc)
    spans, emb, speech = pdz.window_embeddings(y16, penc)
    assert spans == jspans and len(spans) > 20
    np.testing.assert_array_equal(speech, jspeech)
    assert emb.shape == jemb.shape and emb.dtype == np.float32
    assert np.abs(emb - jemb).max() < 1e-5
    # the host blocks (MFCC, f0) alone are the same arithmetic: identical
    jh, ph = jdz.window_embeddings(y16, None)[1], pdz.window_embeddings(y16, None)[1]
    np.testing.assert_array_equal(ph, jh)


@pytest.mark.parametrize("name", list(MIXTURES))
def test_diarize_turns_match_jax(name, encoders, mixtures):
    jenc, penc = encoders
    y, ref, y16 = mixtures[name]
    turns = pst.diarize(y, 22050, penc)
    assert turns == jst.diarize(y, 22050, jenc)
    assert len({t["speaker"] for t in turns}) == len({t["speaker"] for t in ref})
    assert pder.der(ref, turns) == jder.der(ref, turns)
    # a forced speaker count, and the clustering alone on the same matrix
    assert pdz.diarize_turns(y16, penc, num_speakers=2) == jdz.diarize_turns(y16, jenc,
                                                                           num_speakers=2)
    emb = jdz.window_embeddings(y16, jenc)[1]
    for k in (None, 2, 4):
        np.testing.assert_array_equal(pdz.cluster_windows(emb, k), jdz.cluster_windows(emb, k))
    assert pdz.eigengap_num_speakers(emb) == jdz.eigengap_num_speakers(emb)


def test_diarization_tool_matches_jax(encoders, mixtures, tmp_path):
    jenc, penc = encoders
    mgr = ModelsManager(device="cpu")
    mgr.models_bank["speaker_encoder"] = penc

    class JaxManager:
        shared_cache = {"speaker_encoder": jenc}

    out = {}
    for side, tool in (("jax", jst.DiarizationTool(models_manager=JaxManager())),
                       ("torch", pst.DiarizationTool(device="cpu", models_manager=mgr))):
        src = tmp_path / side / "in"
        src.mkdir(parents=True)
        save_wav(str(src / "talk.wav"), mixtures["3spk"][0])
        sent = []

        class WS:
            async def send(self, msg):
                sent.append(json.loads(msg))

        asyncio.run(tool.runTask({"inPath": str(src), "toolSettings":
                                  {"outputAudacityLabels": True}}, WS()))
        assert [e["key"] for e in sent] == ["tasks_next"]
        root = tmp_path / side / "in_diarized"
        out[side] = {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
                     for d, _, fs in os.walk(root) for f in fs}
    assert out["torch"] == out["jax"]
    assert {k.split("/")[0] for k in out["torch"] if "/" in k} == {
        "speaker_0", "speaker_1", "speaker_2"}
    assert out["torch"]["talk_labels.txt"].count(b"\n") >= 5


def test_der_matches_jax():
    ref = [{"start": 0.0, "end": 2.0, "speaker": 0}, {"start": 3.0, "end": 5.0, "speaker": 1},
           {"start": 4.5, "end": 6.0, "speaker": 2}]
    hyps = [ref, [], [{"start": 0.1, "end": 5.2, "speaker": 9}],
            [{"start": 0.0, "end": 2.0, "speaker": 7}, {"start": 3.0, "end": 6.0, "speaker": 4},
             {"start": 5.0, "end": 7.5, "speaker": 1}]]
    for hyp in hyps:
        for kw in ({}, {"collar": 0.0}, {"frame": 0.02, "collar": 0.1}):
            assert pder.der(ref, hyp, **kw) == jder.der(ref, hyp, **kw)
    assert pder.der([], hyps[2]) == jder.der([], hyps[2])
