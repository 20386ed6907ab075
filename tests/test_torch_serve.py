"""Port parity of the serving path around the model: the v3 text front end,
language ids and EBU R128 loudness against the JAX package, ``export_wav``
end to end on the CPU from a ``.pt`` that the JAX package's xVASynth export
writes (loaded ``strict=True``), and ``voice_convert``. Entry points run on
the card by default and refuse a host without one."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile
from test_xvapitch import TINY as JAX_TINY

from xva_trainer_tpu.data.text import v3_text_to_ids as jax_text_to_ids
from xva_trainer_tpu.data.text.ipa import ipa_to_xvaarpabet as jax_ipa_to_xvaarpabet
from xva_trainer_tpu.data.text.xva_processor import XvaTextProcessor as JaxXvaTextProcessor
from xva_trainer_tpu.data.text.xva_processor import register_ipa_g2p as jax_register_ipa_g2p
from xva_trainer_tpu.data.xva_dataset import LANG_CODES as JAX_LANG_CODES
from xva_trainer_tpu.data.xva_dataset import lang_to_id as jax_lang_to_id
from xva_trainer_tpu.models.xvapitch import XVAPitch as JaxXVAPitch
from xva_trainer_tpu.ops import loudness as jax_loudness
from xva_trainer_tpu.train.checkpoints import export_xvapitch_v3
from xva_trainer_tpu_torch import serve
from xva_trainer_tpu_torch.data.text import v3_text_to_ids
from xva_trainer_tpu_torch.data.text.ipa import ipa_to_xvaarpabet
from xva_trainer_tpu_torch.data.text.xva_processor import XvaTextProcessor, register_ipa_g2p
from xva_trainer_tpu_torch.data.xva_dataset import LANG_CODES, lang_to_id
from xva_trainer_tpu_torch.interop.convert import ups_to_reference
from xva_trainer_tpu_torch.models.conv import weight_norm
from xva_trainer_tpu_torch.models.xvapitch import XVAPitch, XVAPitchConfig
from xva_trainer_tpu_torch.ops import loudness

TEXTS = [
    "This is what my voice sounds like.",
    "Dr. Smith paid $4.50 on the 3rd of May, 1999!",
    "Through the rough dough — she thought; quickly.",
    "Élan vital, naïve café: 1,234,567 items?",
    "The quick brown fox jumps over the lazy dog, twice.",
    "",
]
# the TINY model with the full 524-token vocabulary, so that real text fits
JCFG = dataclasses.replace(JAX_TINY, mltts_rc=False, n_vocab=524)
TCFG = XVAPitchConfig(**dataclasses.asdict(JCFG))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("text", TEXTS)
def test_text_ids_match_jax(text, monkeypatch):
    monkeypatch.delenv("XVA_TEXT_DIR", raising=False)
    ours, ref = v3_text_to_ids("en")(text), jax_text_to_ids("en")(text)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


@pytest.mark.parametrize("ipa", ["t ˈɛ s t", "θ ˈɪ ŋ k ɪ ŋ", "h ˈʌ l oʊ", "bɔ̃ʒuʁ",
                                 "ʃpʁaːxə", "ɡuːtən", "haˈloː vɛlt"])
def test_ipa_to_xvaarpabet_matches_jax(ipa):
    assert ipa_to_xvaarpabet(ipa) == jax_ipa_to_xvaarpabet(ipa)


def test_processor_with_ipa_g2p_matches_jax():
    """The per-language G2P hook (an IPA G2P routed through ipa.py) gives
    the JAX package's ids."""
    lex = {"hallo": "haˈloː", "welt": "vɛlt", "und": "ʊnt"}
    register_ipa_g2p("de", lambda w: lex.get(w, w))
    jax_register_ipa_g2p("de", lambda w: lex.get(w, w))
    text = "Hallo Welt, und hallo!"
    ours = XvaTextProcessor("de").text_to_sequence(text)
    assert np.array_equal(ours, JaxXvaTextProcessor("de").text_to_sequence(text))
    assert len(ours) > 8


ML_TEXTS = {
    "en": "Dr. Smith read 21 books in 1999, {HH AH0 L OW1}!",
    "fr": "Bonjour le monde, 12 chats et {K AE1 T} chiens.",
    "it": "La casa rossa è bella; 100 gatti {K AE1 T}!",
    "ro": "Casa mea este frumoasă, doi câini {K AE1 T}.",
    "de": "Guten Tag, {G UW1 T AH0 N} Welt!",
    "sv": "Hej världen, en katt och 5 hundar.",
    "wo": "Xamul yoon, ndank ndank!",
    "zh": "你好，世界。",
}


@pytest.mark.parametrize("lang", sorted(ML_TEXTS))
def test_multilingual_text_ids_match_jax(lang, tmp_path, monkeypatch):
    """With ``XVA_TEXT_DIR`` naming a directory, ``v3_text_to_ids`` is the
    multilingual preprocessor in both packages: the same ids, a list in
    both. The variable is read at each call: unset, both give the rule G2P's
    int32 array again."""
    monkeypatch.setenv("XVA_TEXT_DIR", str(tmp_path))
    text = ML_TEXTS[lang]
    ours, ref = v3_text_to_ids(lang)(text), jax_text_to_ids(lang)(text)
    assert type(ours) is type(ref) is list and ours == ref and ours
    monkeypatch.delenv("XVA_TEXT_DIR")
    ours, ref = v3_text_to_ids(lang)(text), jax_text_to_ids(lang)(text)
    assert isinstance(ours, np.ndarray) and ours.dtype == ref.dtype
    assert np.array_equal(ours, ref)


def test_language_ids_match_jax():
    assert LANG_CODES == JAX_LANG_CODES
    for lang in LANG_CODES + ["EN", "xx", None]:
        assert lang_to_id(lang) == jax_lang_to_id(lang)


def _tone(seconds, amp, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 22050)) / 22050
    return (amp * np.sin(2 * np.pi * 220 * t) * (1 + rng.standard_normal(t.size) * 0.1)
            ).astype(np.float32)


@pytest.mark.parametrize("seconds,amp", [(2.0, 0.3), (0.3, 0.01), (3.0, 0.9)])
def test_loudness_matches_jax(seconds, amp, monkeypatch):
    # the port copies the scipy lfilter path; hold it to that path of the JAX
    # package, not to the JAX package's own C++ biquads
    import xva_trainer_tpu.native as native

    monkeypatch.setattr(native, "integrated_loudness", lambda y, fs: None)
    y = _tone(seconds, amp)
    assert abs(loudness.integrated_loudness(y, 22050)
               - jax_loudness.integrated_loudness(y, 22050)) < 1e-6
    assert abs(loudness.true_peak_db(y, 22050) - jax_loudness.true_peak_db(y, 22050)) < 1e-9
    ours, ref = loudness.normalize_ebu_r128(y, 22050), jax_loudness.normalize_ebu_r128(y, 22050)
    assert np.allclose(ours, ref, rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def voice(tmp_path_factory):
    """A TINY voice exported by the JAX package in xVASynth's format (a flat
    fp16 state dict and its metadata JSON with the speaker embedding)."""
    Tt, Ts = 8, 16
    params = jax.jit(JaxXVAPitch(JCFG).init)(
        {k: jax.random.PRNGKey(i) for i, k in enumerate(["params", "noise", "segments"])},
        jnp.ones((1, Tt), jnp.int32), jnp.full((1,), Tt), jnp.zeros((1, Ts, 513)),
        jnp.full((1,), Ts), jnp.zeros((1, 1, Ts)), jnp.zeros((1, Ts)),
        jnp.zeros((1, Ts * 256, 1)), jnp.zeros((1, 512)), jnp.zeros((1,), jnp.int32))
    emb = np.random.default_rng(1).standard_normal(512).astype(np.float32)
    path = str(tmp_path_factory.mktemp("voice") / "tiny_voice.pt")
    export_xvapitch_v3(jax.device_get(params), path, "tiny_voice", base_emb=emb,
                       model_cfg=JCFG)
    return path, emb


def test_export_wav_cpu(voice, tmp_path):
    path, emb = voice
    out = str(tmp_path / "out.wav")
    body = {"xvap_ckpt": path, "out_path": out, "text": "The quick brown fox.", "lang": "en"}
    assert serve.export_wav(body, cfg=TCFG, device="cpu") == {"ok": True, "path": out}
    sr, pcm = wavfile.read(out)
    model = serve.load_xvapitch(path, TCFG, device="cpu")
    # no "emb" in the body: the embedding comes from the voice's metadata JSON
    with open(os.path.splitext(path)[0] + ".json") as f:
        assert np.allclose(json.load(f)["games"][0]["base_speaker_emb"], emb)
    wav = serve.synthesize_v3(model, body["text"], emb, "en")
    assert sr == 22050 and pcm.dtype == np.int16
    assert len(pcm) == len(wav) and len(wav) % TCFG.hop_length == 0
    assert 1 <= len(wav) // TCFG.hop_length <= serve.MAX_FRAMES
    ref = loudness.normalize_ebu_r128(wav, 22050)
    assert np.abs(pcm / 32767.0 - np.clip(ref, -1, 1)).max() < 1.0 / 32767 + 1e-6
    assert np.array_equal(serve.synthesize_v3(model, body["text"], emb, "en"), wav)


def _ups_weights(sd, dim):
    """The effective weights of the decoder's upsampling convs, whose weight
    norm runs over ``dim``."""
    return [torch._weight_norm(sd[f"waveform_decoder.ups.{i}.weight_v"].float(),
                               sd[f"waveform_decoder.ups.{i}.weight_g"].float(), dim)
            for i in range(len(TCFG.upsample_rates))]


def test_loaded_weights_are_the_export(voice):
    """The model holds the exported weights: every entry as written, except
    the decoder's upsampling (weight_g, weight_v) pairs, which move from the
    reference's per-input-channel weight norm to the port's per-output-channel
    one with the same effective weights; ``ups_to_reference`` gives the
    reference's layout back."""
    path, _ = voice
    sd = torch.load(path, weights_only=True)
    model = serve.load_xvapitch(path, TCFG, device="cpu")
    own = model.state_dict()
    assert set(own) == set(sd)
    ups = {k for k in sd if k.startswith("waveform_decoder.ups.") and ".weight_" in k}
    assert len(ups) == 2 * len(TCFG.upsample_rates)
    assert all(torch.equal(own[k], v.float()) for k, v in sd.items() if k not in ups)
    back = ups_to_reference(own)
    for k in ups:
        assert back[k].shape == sd[k].shape
        if k.endswith("weight_g"):
            assert own[k].shape[0] == 1 and sd[k].shape[1] == 1
    for ref, ours, rt in zip(_ups_weights(sd, 0), _ups_weights(own, 1), _ups_weights(back, 0)):
        scale = ref.abs().max()
        assert (ours - ref).abs().max() < 1e-6 * scale and (rt - ref).abs().max() < 1e-6 * scale


def test_reference_checkpoint_synthesises_as_before(voice):
    """The reference-layout ``.pt`` loads strictly and synthesises the
    waveform of a model that keeps the reference's per-input-channel weight
    norm on its upsampling convs."""
    path, emb = voice
    sd = {k: v.float() for k, v in torch.load(path, weights_only=True).items()}
    before = XVAPitch(TCFG)
    for up in before.waveform_decoder.ups:
        torch.nn.utils.remove_weight_norm(up)
        weight_norm(up, dim=0)
    before.load_state_dict(sd, strict=True)
    text = "The quick brown fox."
    ref = serve.synthesize_v3(before.eval(), text, emb, "en")
    ours = serve.synthesize_v3(serve.load_xvapitch(path, TCFG, device="cpu"), text, emb, "en")
    assert ours.shape == ref.shape and len(ref) > 0
    assert np.abs(ours - ref).max() < 1e-5 * max(np.abs(ref).max(), 1e-3)


def test_voice_convert_cpu(voice):
    path, emb = voice
    model = serve.load_xvapitch(path, TCFG, device="cpu")
    y = _tone(0.5, 0.3)[:32 * 256]
    tgt = np.random.default_rng(2).standard_normal(512).astype(np.float32)
    out = serve.voice_convert(model, y, emb, tgt)
    assert out.shape == (33 * 256,) and np.isfinite(out).all()
    assert np.array_equal(serve.voice_convert(model, y, emb, tgt), out)


def test_entry_points_refuse_missing_cuda(voice, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the host has CUDA; this guards CUDA-less hosts")
    path, _ = voice
    out = str(tmp_path / "never.wav")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.export_wav({"xvap_ckpt": path, "out_path": out}, cfg=TCFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.load_xvapitch(path, TCFG)
    assert not os.path.exists(out)
