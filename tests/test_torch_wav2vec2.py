"""The port's wav2vec2 CTC (``xva_trainer_tpu_torch/models/wav2vec2``,
``interop/wav2vec2_map.py``) held to the JAX package's, with seeded JAX
parameters carried across by ``interop/convert.py::wav2vec2_state_dict``
(the positional conv's folded kernel split into ``weight_g``/``weight_v``)
at a narrow width: the logits within 1e-4 max abs for an even and an odd
positional kernel; ``load_wav2vec2`` from a HuggingFace directory in both
weight-norm namings, against JAX's loader; ``ctc_greedy_decode`` and
``transcribe`` giving the same text.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_asr_common import W2V_NARROW, W2V_VOCAB, voiced, w2v_params, write_hf_wav2vec2
from xva_trainer_tpu.interop import wav2vec2_map as jmap
from xva_trainer_tpu.models import wav2vec2 as jw
from xva_trainer_tpu_torch.interop import wav2vec2_map as pmap
from xva_trainer_tpu_torch.interop.convert import wav2vec2_state_dict
from xva_trainer_tpu_torch.models import wav2vec2 as pw

TOL = 1e-4


@pytest.fixture(autouse=True)
def threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("pos_kernel", [16, 15])
def test_logits_match_jax(pos_kernel):
    kw = dict(W2V_NARROW, pos_conv_kernel=pos_kernel)
    params, cfg = w2v_params(kw, seed=pos_kernel)
    wav = np.stack([voiced(1.0, seed=1), voiced(1.0, seed=2)])
    want = np.asarray(jw.Wav2Vec2Model(cfg).apply(params, jnp.asarray(wav)))
    model = pw.Wav2Vec2Model(pw.Wav2Vec2Config(**kw))
    model.load_state_dict(wav2vec2_state_dict(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, 799, 12)
    assert np.abs(got - want).max() < TOL


@pytest.mark.parametrize("naming", ["legacy", "parametrizations"])
def test_load_wav2vec2_matches_jax(tmp_path, naming):
    params, cfg = w2v_params()
    d = write_hf_wav2vec2(str(tmp_path / "hf"), params, naming=naming)
    sd, pcfg, vocab = pmap.load_wav2vec2(d)
    jparams, jcfg, jvocab = jmap.load_wav2vec2(d)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg) and vocab == jvocab == W2V_VOCAB
    assert sorted(sd) == sorted(wav2vec2_state_dict(params))
    assert all(v.dtype == torch.float32 for v in sd.values())
    model = pw.Wav2Vec2Model(pcfg)
    model.load_state_dict(sd, strict=True)
    wav = voiced(1.5, seed=3)[None]
    want = np.asarray(jw.Wav2Vec2Model(jcfg).apply(jparams, jnp.asarray(wav)))
    with torch.no_grad():
        got = model(torch.from_numpy(wav)).numpy()
    assert np.abs(got - want).max() < TOL
    # a missing key is named
    broken = torch.load(d + "/pytorch_model.bin", weights_only=True)
    del broken["lm_head.bias"]
    torch.save(broken, d + "/pytorch_model.bin")
    with pytest.raises(KeyError, match="lm_head.bias"):
        pmap.load_wav2vec2(d)


def test_ctc_greedy_decode_matches_jax():
    id_to_char = {v: k for k, v in W2V_VOCAB.items()}
    rng = np.random.default_rng(4)
    for _ in range(20):
        logits = rng.standard_normal((60, 12)).astype(np.float32)
        logits[rng.random(60) < 0.4, 0] += 3.0  # blanks
        assert pw.ctc_greedy_decode(logits, id_to_char) == jw.ctc_greedy_decode(logits,
                                                                              id_to_char)
    ids = [0, 6, 6, 0, 5, 5, 4, 4, 3, 7, 2, 0, 7, 1, 9, 4]  # repeats, '|', <unk>, <s>, </s>
    onehot = np.eye(12, dtype=np.float32)[ids]
    assert pw.ctc_greedy_decode(onehot, id_to_char) == jw.ctc_greedy_decode(onehot, id_to_char) \
        == "TE AAN"


def test_transcribe_matches_jax(tmp_path):
    params, cfg = w2v_params(seed=5)
    d = write_hf_wav2vec2(str(tmp_path / "hf"), params)
    jasr = jw.Wav2Vec2CTC.from_hf_dir(d)
    asr = pw.Wav2Vec2CTC.from_hf_dir(d, device="cpu")
    texts = []
    for seed in range(4):
        wav = voiced(1.0 + 0.5 * seed, seed=seed + 30)
        want = np.asarray(jasr._logits(jasr.params, jnp.asarray(
            (wav - wav.mean()) / np.sqrt(wav.var() + 1e-7))[None]))[0]
        assert np.abs(asr.logits(wav) - want).max() < TOL
        texts.append(asr.transcribe(wav))
        assert texts[-1] == jasr.transcribe(wav)
    assert any(texts)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pw.Wav2Vec2CTC.from_hf_dir(d)
