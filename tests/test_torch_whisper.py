"""The port's whisper (``xva_trainer_tpu_torch/models/whisper``,
``interop/whisper_map.py``, ``interop/safetensors_io.py``) held to the JAX
package's, with seeded JAX parameters carried across by
``interop/convert.py::whisper_state_dict``, at a narrow width (64, 2 + 2
layers) with the full 51 865-token multilingual vocabulary, so that the
prefix and the language detection run.

- ``log_mel_spectrogram``: bit-identical.
- The encoder's output and the decoder's logits: within 1e-4 max abs.
- ``SpecialTokens``: equal for 51 864, 51 865, 51 866 and a tiny vocabulary.
- Greedy decoding: the port's tokens equal JAX's at every step whose
  top-2 margin (in JAX's logits over ``[: eot + 1]``) exceeds 10 x the
  logits tolerance; at a step under that margin a different token is
  allowed, and from there on the teacher-forced logits of JAX's sequence
  are what is held (within 1e-4, every step). ``max_tokens`` is under 224
  but in one case.
- ``detect_language``: equal, the language logits within 1e-4.
- ``BpeDecoder`` on tiktoken and ``vocab.json`` fixtures; ``load_whisper``
  with and without ``dims``; ``import-whisper`` from an OpenAI ``.pt`` and
  from HuggingFace directories (``model.safetensors`` written by the
  ``safetensors`` package, and ``pytorch_model.bin``), each package's
  ``whisper.pt`` loading in the other to the same parameters; the port's
  safetensors reader against the package for F32, F16, BF16 and I64.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_asr_common import (WHISPER_NARROW, voiced, whisper_params, write_openai_pt,
                              write_tiktoken)
from xva_trainer_tpu.interop import whisper_map as jmap
from xva_trainer_tpu.models import whisper as jw
from xva_trainer_tpu_torch.interop import safetensors_io
from xva_trainer_tpu_torch.interop import whisper_map as pmap
from xva_trainer_tpu_torch.interop.convert import whisper_state_dict
from xva_trainer_tpu_torch.models import whisper as pw

TOL = 1e-4  # logits and encoder output, max abs


@pytest.fixture(autouse=True)
def threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    """(JAX params, JAX config, the port's CPU ``WhisperASR`` at 224 tokens)."""
    params, cfg = whisper_params()
    asr = pw.WhisperASR(whisper_state_dict(params), pw.WhisperConfig(**WHISPER_NARROW),
                        device="cpu")
    return params, cfg, asr


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("seconds,n_mels", [(3.0, 80), (31.5, 80), (7.0, 128)])
def test_log_mel_bit_identical(seconds, n_mels):
    y = voiced(seconds, seed=int(seconds))
    want = jw.log_mel_spectrogram(y, n_mels)
    got = pw.log_mel_spectrogram(y, n_mels)
    assert got.shape == want.shape == (n_mels, 3000) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_encoder_and_logits_match_jax(models):
    params, cfg, asr = models
    mel = pw.log_mel_spectrogram(voiced(4.0, seed=1))[None]
    jm = jw.Whisper(cfg)
    enc_j = np.asarray(jm.apply(params, jnp.asarray(mel), method=jw.Whisper.encode))
    with torch.no_grad():
        enc_p = asr.model.encode(torch.from_numpy(mel)).numpy()
    assert enc_p.shape == enc_j.shape == (1, 1500, 64)
    assert np.abs(enc_p - enc_j).max() < TOL
    tokens = np.random.default_rng(2).integers(0, cfg.n_vocab, (2, 24)).astype(np.int32)
    feats = np.repeat(enc_j, 2, axis=0)
    lj = np.asarray(jm.apply(params, jnp.asarray(tokens), jnp.asarray(feats),
                             method=jw.Whisper.decode_logits))
    with torch.no_grad():
        lp = asr.model.decode_logits(torch.from_numpy(tokens).long(),
                                     torch.from_numpy(feats)).numpy()
    assert lp.shape == lj.shape == (2, 24, 51865)
    assert np.abs(lp - lj).max() < TOL


@pytest.mark.parametrize("n_vocab", [51864, 51865, 51866, 1000])
def test_special_tokens_match_jax(n_vocab):
    want, got = jw.SpecialTokens(n_vocab), pw.SpecialTokens(n_vocab)
    assert vars(got) == vars(want)
    assert got.lang_id("de") == want.lang_id("de")


@pytest.mark.parametrize("max_tokens,lang,seconds", [(40, "en", 3.0), (64, "de", 5.0),
                                                      (224, None, 8.0)])
def test_greedy_tokens_match_jax(models, max_tokens, lang, seconds):
    params, cfg, asr = models
    audio = voiced(seconds, seed=int(seconds) + 10)
    jasr = jw.WhisperASR(params, cfg, max_tokens=max_tokens)
    asr.max_tokens = max_tokens
    try:
        got = asr.transcribe_tokens(audio, lang=lang)
    finally:
        asr.max_tokens = 224
    want = jasr.transcribe_tokens(audio, lang=lang)
    st = jasr.st
    detected = lang or jasr.detect_language(audio)
    prefix = [st.sot, st.lang_id(detected), st.transcribe, st.no_timestamps]
    assert 0 < len(want) <= max_tokens - len(prefix)
    # teacher-forced logits of JAX's sequence, both packages, on JAX's features
    buf = np.zeros((1, max_tokens), np.int32)
    buf[0, : len(prefix) + len(want)] = prefix + want
    feats = jasr._encode(params, jnp.asarray(jw.log_mel_spectrogram(audio)[None]))
    lj = np.asarray(jw.Whisper(cfg).apply(params, jnp.asarray(buf), feats,
                                          method=jw.Whisper.decode_logits))[0, :, : st.eot + 1]
    with torch.no_grad():
        lp = asr.model.decode_logits(torch.from_numpy(buf).long(),
                                     torch.from_numpy(np.array(feats))).numpy()[0]
    lp = lp[:, : st.eot + 1]
    steps = slice(len(prefix) - 1, len(prefix) - 1 + len(want))
    assert np.abs(lp[steps] - lj[steps]).max() < TOL
    for i, tok in enumerate(want):
        row = np.sort(lj[len(prefix) - 1 + i])
        if i >= len(got) or got[i] != tok:
            assert row[-1] - row[-2] <= 10 * TOL, (i, got[i:i + 3], want[i:i + 3])
            break
    else:
        assert got == want


def test_detect_language_matches_jax(models):
    params, cfg, asr = models
    jasr = jw.WhisperASR(params, cfg, max_tokens=32)
    asr.max_tokens = 32
    try:
        for seed in range(3):
            audio = voiced(2.0 + seed, seed=seed + 20)
            feats = jasr._encode(params, jnp.asarray(jw.log_mel_spectrogram(audio)[None]))
            want = np.asarray(jasr._lang_logits(params, feats))
            got = asr._lang_logits(torch.from_numpy(np.array(feats))).numpy()
            assert got.shape == want.shape == (99,)
            assert np.abs(got - want).max() < TOL
            assert asr.detect_language(audio) == jasr.detect_language(audio)
    finally:
        asr.max_tokens = 224
    english = pw.WhisperASR(asr.model.state_dict(), asr.cfg, device="cpu")
    english.cfg = dataclasses.replace(asr.cfg, n_vocab=51864)
    assert english.detect_language(voiced(1.0)) == "en"


def test_bpe_decoder_matches_jax(tmp_path):
    write_tiktoken(tmp_path / "multilingual.tiktoken", n=600)
    vocab = {"Ġhello": 0, "world": 1, "Ċ": 2, "Ã©": 3, "<|endoftext|>": 4, "Ġcaf": 5}
    vdir = tmp_path / "hf"
    vdir.mkdir()
    (vdir / "vocab.json").write_text(json.dumps(vocab), encoding="utf8")
    ids = [[300, 301, 3, 0xC3, 400, 599, 10, 599], [0xE8, 0xAA, 301, 256, 70000], []]
    for d in (tmp_path, vdir):
        want, got = jw.BpeDecoder.find(str(d)), pw.BpeDecoder.find(str(d))
        assert got.id_to_bytes == want.id_to_bytes
        for seq in ids + [[5, 3, 0, 1, 2, 4, 9]]:
            assert got.decode(seq) == want.decode(seq)
    assert pw.BpeDecoder.find(str(vdir)).decode([5, 3, 0, 1]) == " café helloworld"
    assert pw.BpeDecoder.find(str(tmp_path / "none"), "") is None
    # tiktoken before vocab.json, and an assets/ directory found when named
    (tmp_path / "vocab.json").write_text(json.dumps(vocab), encoding="utf8")
    assert len(pw.BpeDecoder.find(str(tmp_path)).id_to_bytes) == 600


def same_state(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == torch.float32 and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("dims", [True, False])
def test_load_whisper_matches_jax(models, tmp_path, dims):
    params = models[0]
    path = write_openai_pt(tmp_path / "base.pt", params, dims=dims)
    sd, cfg = pmap.load_whisper(path)
    jparams, jcfg = jmap.load_whisper(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    if not dims:  # heads inferred from the width, 64 per head
        assert (cfg.n_audio_head, cfg.n_text_head) == (1, 1) and cfg.n_mels == 80
    same_state(sd, whisper_state_dict(np_tree(jparams)))
    same_state(sd, whisper_state_dict(params))
    pw.Whisper(cfg).load_state_dict(sd, strict=True)
    broken = torch.load(path, weights_only=True)
    del broken["model_state_dict"]["decoder.ln.bias"]
    torch.save(broken, tmp_path / "broken.pt")
    with pytest.raises(KeyError, match="1 torch keys missing"):
        pmap.load_whisper(str(tmp_path / "broken.pt"))


def openai_to_hf(sd):
    """OpenAI's names → HuggingFace ``WhisperForConditionalGeneration``'s,
    with the tied ``proj_out.weight`` and the encoder's sinusoids."""
    pairs = [("encoder.blocks.", "encoder.layers."), ("decoder.blocks.", "decoder.layers."),
             ("cross_attn_ln", "encoder_attn_layer_norm"), ("attn_ln", "self_attn_layer_norm"),
             ("cross_attn.query", "encoder_attn.q_proj"), ("cross_attn.key", "encoder_attn.k_proj"),
             ("cross_attn.value", "encoder_attn.v_proj"), ("cross_attn.out", "encoder_attn.out_proj"),
             ("attn.query", "self_attn.q_proj"), ("attn.key", "self_attn.k_proj"),
             ("attn.value", "self_attn.v_proj"), ("attn.out", "self_attn.out_proj"),
             ("mlp_ln", "final_layer_norm"), ("mlp.0", "fc1"), ("mlp.2", "fc2"),
             ("encoder.ln_post", "encoder.layer_norm"), ("decoder.ln.", "decoder.layer_norm."),
             ("decoder.token_embedding.weight", "decoder.embed_tokens.weight"),
             ("decoder.positional_embedding", "decoder.embed_positions.weight"),
             ("encoder.positional_embedding", "encoder.embed_positions.weight")]
    out = {}
    for k, v in sd.items():
        for a, b in pairs:
            k = k.replace(a, b)
        out["model." + k] = v
    out["proj_out.weight"] = sd["decoder.token_embedding.weight"]
    return out


def write_hf_whisper(d, params, fmt):
    from xva_trainer_tpu_torch.models.whisper.model import _sinusoids

    os.makedirs(d)
    c = WHISPER_NARROW
    sd = {k: v.numpy() for k, v in whisper_state_dict(params).items()}
    sd["encoder.positional_embedding"] = _sinusoids(c["n_audio_ctx"], c["n_audio_state"])
    hf = openai_to_hf(sd)
    assert "model.encoder.layers.1.self_attn.k_proj.weight" in hf
    cfg = {"model_type": "whisper", "vocab_size": c["n_vocab"], "num_mel_bins": 80,
           "max_source_positions": c["n_audio_ctx"], "max_target_positions": c["n_text_ctx"],
           "d_model": c["n_audio_state"], "encoder_attention_heads": c["n_audio_head"],
           "decoder_attention_heads": c["n_text_head"], "encoder_layers": c["n_audio_layer"],
           "decoder_layers": c["n_text_layer"]}
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    if fmt == "safetensors":
        from safetensors.numpy import save_file

        save_file({k: np.ascontiguousarray(v) for k, v in hf.items()},
                  os.path.join(d, "model.safetensors"))
    else:
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in hf.items()},
                   os.path.join(d, "pytorch_model.bin"))
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump({"a": 0, "Ġb": 1}, f)


@pytest.mark.parametrize("source", ["openai_pt", "hf_safetensors", "hf_bin"])
def test_import_whisper_matches_jax(models, tmp_path, source, capsys):
    from xva_trainer_tpu_torch import cli

    params = models[0]
    if source == "openai_pt":
        (tmp_path / "src").mkdir()
        src = write_openai_pt(tmp_path / "src" / "base.pt", params)
        write_tiktoken(tmp_path / "src" / "multilingual.tiktoken", n=300)
        assets = ["multilingual.tiktoken"]
    else:
        src = str(tmp_path / "src")
        write_hf_whisper(src, params, source[3:])
        assets = ["vocab.json"]
    cli.main(["import-whisper", src, "--out", str(tmp_path / "torch")])
    assert f"wrote {tmp_path / 'torch' / 'whisper.pt'}" in capsys.readouterr().out
    jmap.import_whisper_checkpoint(src, str(tmp_path / "jax"))
    for side in ("torch", "jax"):
        assert sorted(os.listdir(tmp_path / side)) == sorted(assets + ["whisper.pt"])
    want = whisper_state_dict(params)
    # each package's whisper.pt in the other, and in itself
    for side in ("torch", "jax"):
        path = str(tmp_path / side / "whisper.pt")
        sd, cfg = pmap.load_whisper(path)
        jparams, jcfg = jmap.load_whisper(path)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg) == WHISPER_NARROW | {
            "n_mels": 80}
        same_state(sd, want)
        same_state(whisper_state_dict(np_tree(jparams)), want)


def test_import_whisper_refuses(tmp_path):
    (tmp_path / "w2v").mkdir()
    (tmp_path / "w2v" / "config.json").write_text(json.dumps({"model_type": "wav2vec2"}))
    with pytest.raises(ValueError, match="is not whisper"):
        pmap.import_whisper_checkpoint(str(tmp_path / "w2v"), str(tmp_path / "o"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no config.json"):
        pmap.import_whisper_checkpoint(str(tmp_path / "empty"), str(tmp_path / "o"))
    torch.save({"model_state_dict": {"encoder.conv1.weight": torch.zeros(8, 80, 3)}},
               tmp_path / "bad.pt")
    with pytest.raises((KeyError, ValueError)):
        pmap.import_whisper_checkpoint(str(tmp_path / "bad.pt"), str(tmp_path / "o"))
    assert not (tmp_path / "o" / "whisper.pt").exists()


def test_safetensors_reader_matches_package(tmp_path):
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file as torch_load
    from safetensors.torch import save_file

    rng = np.random.default_rng(9)
    tensors = {
        "f32": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
        "f16": torch.from_numpy(rng.standard_normal((7,)).astype(np.float16)),
        "bf16": torch.from_numpy(rng.standard_normal((4, 2)).astype(np.float32)).bfloat16(),
        "i64": torch.from_numpy(rng.integers(-2 ** 40, 2 ** 40, (2, 3))),
        "scalar": torch.tensor(1.5),
        "empty": torch.zeros((0, 4)),
    }
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = safetensors_io.load_file(path)
    assert sorted(got) == sorted(tensors)
    ref = torch_load(path)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        assert torch.equal(got[k], ref[k]) and torch.equal(got[k], t), k
    del tensors["bf16"]  # numpy has no bfloat16
    save_file(tensors, path)
    ref = np_load(path)
    got = safetensors_io.load_file(path)
    for k in tensors:
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
        assert got[k].numpy().dtype == ref[k].dtype


def test_needs_a_card_unless_told_cpu(models):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pw.WhisperASR(models[2].model.state_dict(), models[2].cfg)
