"""Shared by the port's whisper, wav2vec2 and ASR-tool tests: seeded JAX
parameters at narrow widths, the files a user brings (an OpenAI whisper
``.pt``, a HuggingFace wav2vec2 directory, tokenizer assets), written from
them, and a speech-like test signal."""
import base64
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from xva_trainer_tpu.models.wav2vec2 import Wav2Vec2Config as JaxW2VConfig
from xva_trainer_tpu.models.wav2vec2 import Wav2Vec2Model as JaxW2V
from xva_trainer_tpu.models.whisper import Whisper as JaxWhisper
from xva_trainer_tpu.models.whisper import WhisperConfig as JaxWhisperConfig
from xva_trainer_tpu_torch.interop.convert import wav2vec2_state_dict, whisper_state_dict

# narrow, with the full multilingual vocabulary (the prefix and language
# detection run) and the real audio context (the mel is always 30 s)
WHISPER_NARROW = dict(n_vocab=51865, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
                      n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=2,
                      n_text_layer=2)
W2V_NARROW = dict(vocab_size=12, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                  conv_dim=(32, 32, 32), conv_stride=(5, 2, 2), conv_kernel=(10, 3, 3),
                  pos_conv_kernel=16, pos_conv_groups=4)
W2V_VOCAB = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4, "E": 5, "T": 6, "A": 7,
             "O": 8, "N": 9, "I": 10, "'": 11}


def seeded(shapes, seed):
    """Numpy leaves for ``shapes``: kernels N(0, 1/fan_in), LayerNorm and
    GroupNorm scales 1 + N(0, 0.1), the rest (biases, embeddings) N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(
                np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def whisper_params(cfg_kw=WHISPER_NARROW, seed=0):
    cfg = JaxWhisperConfig(**cfg_kw)
    shapes = jax.eval_shape(JaxWhisper(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, cfg.n_mels, 3000)), jnp.zeros((1, 4), jnp.int32))
    return seeded(shapes, seed), cfg


def write_openai_pt(path, params, cfg_kw=WHISPER_NARROW, dims=True):
    """An OpenAI-layout ``{size}.pt``: ``dims`` and ``model_state_dict``
    (with the encoder's sinusoid buffer, as OpenAI saves it)."""
    from xva_trainer_tpu_torch.models.whisper.model import _sinusoids

    sd = dict(whisper_state_dict(params))
    sd["encoder.positional_embedding"] = torch.from_numpy(
        _sinusoids(cfg_kw["n_audio_ctx"], cfg_kw["n_audio_state"]))
    obj = {"model_state_dict": sd}
    if dims:
        obj["dims"] = dict(cfg_kw)
    torch.save(obj, str(path))
    return str(path)


def write_tiktoken(path, n=50257, seed=0):
    """A ``multilingual.tiktoken``-style table: the 256 single bytes, then
    seeded multi-byte tokens (words with a leading space, some split UTF-8)."""
    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz") + ["é", "ü", "ß", "ж", "語"]
    lines = []
    for i in range(n):
        if i < 256:
            tok = bytes([i])
        else:
            word = "".join(rng.choice(letters, size=int(rng.integers(1, 6))))
            tok = (" " if rng.random() < 0.6 else "").encode() + word.encode()
            if rng.random() < 0.05:
                tok = tok[:-1] if len(tok) > 1 else tok
        lines.append(base64.b64encode(tok).decode() + f" {i}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


def w2v_params(cfg_kw=W2V_NARROW, seed=0):
    cfg = JaxW2VConfig(**cfg_kw)
    shapes = jax.eval_shape(JaxW2V(cfg).init, jax.random.PRNGKey(0), jnp.zeros((1, 4000)))
    return seeded(shapes, seed), cfg


def write_hf_wav2vec2(d, params, cfg_kw=W2V_NARROW, naming="legacy", vocab=W2V_VOCAB):
    """A HuggingFace ``Wav2Vec2ForCTC`` directory: ``config.json``,
    ``pytorch_model.bin`` (the positional conv's weight norm as
    ``weight_g``/``weight_v`` or as ``parametrizations``, and an unused
    ``masked_spec_embed``), ``vocab.json``."""
    os.makedirs(d, exist_ok=True)
    c = dict(cfg_kw)
    hf = {"model_type": "wav2vec2", "vocab_size": c["vocab_size"],
          "hidden_size": c["hidden_size"], "num_hidden_layers": c["num_layers"],
          "num_attention_heads": c["num_heads"], "intermediate_size": c["intermediate_size"],
          "conv_dim": list(c["conv_dim"]), "conv_stride": list(c["conv_stride"]),
          "conv_kernel": list(c["conv_kernel"]), "num_conv_pos_embeddings": c["pos_conv_kernel"],
          "num_conv_pos_embedding_groups": c["pos_conv_groups"]}
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf, f)
    sd = dict(wav2vec2_state_dict(params))
    base = "wav2vec2.encoder.pos_conv_embed.conv"
    if naming == "parametrizations":
        sd[base + ".parametrizations.weight.original0"] = sd.pop(base + ".weight_g")
        sd[base + ".parametrizations.weight.original1"] = sd.pop(base + ".weight_v")
    sd["wav2vec2.masked_spec_embed"] = torch.zeros(c["hidden_size"])
    torch.save(sd, os.path.join(d, "pytorch_model.bin"))
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    return d


def voiced(seconds, sr=16000, seed=0):
    """A harmonic voice with a syllable envelope and a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(100, 240)
    y = sum((0.6 ** k) * np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6)) for k in range(1, 8))
    y *= 0.2 * (0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2, 5) * t))
    return (y + 1e-3 * rng.standard_normal(len(t))).astype(np.float32)
