"""Whisper checkpoints for the port: OpenAI ``{size}.pt`` and HuggingFace
naming, and the rule table that carries the JAX package's flax Whisper
across.

The port's copy of ``xva_trainer_tpu/interop/whisper_map.py``. The port's
``models/whisper`` keeps OpenAI's key names, so a checkpoint's state dict
loads into it directly; the rules (``whisper_rules``) serve
``interop/convert.py::whisper_state_dict``. Files are read with
``torch.load(weights_only=True)`` and written with ``torch.save``; a
HuggingFace ``model.safetensors`` is read by ``interop/safetensors_io.py``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Dict, List, Tuple

import torch

from .mapping import Rule

P = Tuple[str, ...]


def _ln(tkey: str, fpath: P) -> List[Rule]:
    return [
        Rule(tkey + ".weight", fpath + ("scale",), "id"),
        Rule(tkey + ".bias", fpath + ("bias",), "id"),
    ]


def _linear(tkey: str, fpath: P, bias: bool = True) -> List[Rule]:
    rules = [Rule(tkey + ".weight", fpath + ("kernel",), "linear")]
    if bias:
        rules.append(Rule(tkey + ".bias", fpath + ("bias",), "id"))
    return rules


def _block_rules(tp: str, fp: P, cross: bool) -> List[Rule]:
    rules = _ln(f"{tp}.attn_ln", fp + ("attn_ln",))
    rules += _linear(f"{tp}.attn.query", fp + ("attn", "query"))
    rules += _linear(f"{tp}.attn.key", fp + ("attn", "key"), bias=False)
    rules += _linear(f"{tp}.attn.value", fp + ("attn", "value"))
    rules += _linear(f"{tp}.attn.out", fp + ("attn", "out"))
    if cross:
        rules += _ln(f"{tp}.cross_attn_ln", fp + ("cross_attn_ln",))
        rules += _linear(f"{tp}.cross_attn.query", fp + ("cross_attn", "query"))
        rules += _linear(f"{tp}.cross_attn.key", fp + ("cross_attn", "key"), bias=False)
        rules += _linear(f"{tp}.cross_attn.value", fp + ("cross_attn", "value"))
        rules += _linear(f"{tp}.cross_attn.out", fp + ("cross_attn", "out"))
    rules += _ln(f"{tp}.mlp_ln", fp + ("mlp_ln",))
    rules += _linear(f"{tp}.mlp.0", fp + ("mlp_0",))
    rules += _linear(f"{tp}.mlp.2", fp + ("mlp_2",))
    return rules


def whisper_rules(n_audio_layer: int, n_text_layer: int) -> List[Rule]:
    rules: List[Rule] = [
        Rule("encoder.conv1.weight", ("encoder", "conv1", "kernel"), "conv1d"),
        Rule("encoder.conv1.bias", ("encoder", "conv1", "bias"), "id"),
        Rule("encoder.conv2.weight", ("encoder", "conv2", "kernel"), "conv1d"),
        Rule("encoder.conv2.bias", ("encoder", "conv2", "bias"), "id"),
    ]
    for i in range(n_audio_layer):
        rules += _block_rules(f"encoder.blocks.{i}", ("encoder", f"block_{i}"), cross=False)
    rules += _ln("encoder.ln_post", ("encoder", "ln_post"))
    rules += [
        Rule("decoder.token_embedding.weight", ("decoder", "token_embedding"), "id"),
        Rule("decoder.positional_embedding", ("decoder", "positional_embedding"), "id"),
    ]
    for i in range(n_text_layer):
        rules += _block_rules(f"decoder.blocks.{i}", ("decoder", f"block_{i}"), cross=True)
    rules += _ln("decoder.ln", ("decoder", "ln"))
    return rules


_HF_MAP = [
    ("model.", ""),
    ("encoder.layers.", "encoder.blocks."),
    ("decoder.layers.", "decoder.blocks."),
    ("self_attn_layer_norm", "attn_ln"),
    ("encoder_attn_layer_norm", "cross_attn_ln"),
    ("self_attn.q_proj", "attn.query"),
    ("self_attn.k_proj", "attn.key"),
    ("self_attn.v_proj", "attn.value"),
    ("self_attn.out_proj", "attn.out"),
    ("encoder_attn.q_proj", "cross_attn.query"),
    ("encoder_attn.k_proj", "cross_attn.key"),
    ("encoder_attn.v_proj", "cross_attn.value"),
    ("encoder_attn.out_proj", "cross_attn.out"),
    ("final_layer_norm", "mlp_ln"),
    ("fc1", "mlp.0"),
    ("fc2", "mlp.2"),
    ("encoder.layer_norm", "encoder.ln_post"),
    ("decoder.layer_norm", "decoder.ln"),
    ("decoder.embed_tokens.weight", "decoder.token_embedding.weight"),
    ("decoder.embed_positions.weight", "decoder.positional_embedding"),
    ("encoder.embed_positions.weight", "encoder.positional_embedding"),
]


def hf_to_openai_keys(sd: Dict) -> Dict:
    out = {}
    for k, v in sd.items():
        for a, b in _HF_MAP:
            k = k.replace(a, b)
        out[k] = v
    return out


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def load_whisper(path: str):
    """A local whisper ``.pt`` → (fp32 state dict of the port's ``Whisper``,
    ``WhisperConfig``). The config is the file's ``dims``, else inferred
    from the shapes (heads = state / 64). Every key of the model must be in
    the file (a ``KeyError`` names those missing); others, such as the
    encoder's sinusoids, are ignored, as in the JAX package."""
    from ..models.whisper import WhisperConfig

    ckpt = _load(path)
    dims = ckpt.get("dims", {})
    sd = ckpt.get("model_state_dict", ckpt.get("state_dict", ckpt))
    if any(k.startswith("model.") for k in sd):
        sd = hf_to_openai_keys(sd)
    if dims:
        names = [f.name for f in dataclasses.fields(WhisperConfig) if f.name != "n_mels"]
        cfg = WhisperConfig(**{n: int(dims[n]) for n in names},
                            n_mels=int(dims.get("n_mels", 80)))  # large-v3: 128
    else:
        n_audio_layer = 1 + max(int(k.split(".")[2]) for k in sd
                                if k.startswith("encoder.blocks."))
        n_text_layer = 1 + max(int(k.split(".")[2]) for k in sd
                               if k.startswith("decoder.blocks."))
        emb = sd["decoder.token_embedding.weight"]
        state = emb.shape[1]
        cfg = WhisperConfig(
            n_vocab=emb.shape[0],
            n_audio_state=sd["encoder.conv1.weight"].shape[0],
            n_audio_layer=n_audio_layer,
            n_text_state=state,
            n_text_layer=n_text_layer,
            n_text_ctx=sd["decoder.positional_embedding"].shape[0],
            n_audio_head=max(1, state // 64),
            n_text_head=max(1, state // 64),
            n_mels=sd["encoder.conv1.weight"].shape[1],  # (out, in=n_mels, k)
        )
    keys = [r.torch_key for r in whisper_rules(cfg.n_audio_layer, cfg.n_text_layer)]
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"{len(missing)} torch keys missing: {missing[:8]} ...")
    return {k: torch.as_tensor(sd[k]).to(torch.float32) for k in keys}, cfg


def import_whisper_checkpoint(src: str, out_dir: str) -> str:
    """``cli import-whisper``: whisper weights a user can obtain → the one
    local layout the transcribe tool reads.

    Accepts an OpenAI-whisper ``{size}.pt`` or a HuggingFace whisper
    checkpoint directory (``config.json`` with ``model.safetensors`` or
    ``pytorch_model.bin``, optional tokenizer assets), whose keys are
    translated to OpenAI's and whose ``dims`` come from ``config.json``
    (``proj_out.``, tied to the embedding, is dropped). Writes
    ``<out_dir>/whisper.pt`` and any tokenizer asset found next to the
    source (``*.tiktoken``, ``vocab.json``), checks the file by loading it
    strictly (removing it if that fails), and returns its path."""
    from .safetensors_io import load_file

    src = os.path.abspath(src)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "whisper.pt")

    if os.path.isfile(src):
        ckpt = _load(src)
        dims = dict(ckpt.get("dims", {}))
        sd = dict(ckpt.get("model_state_dict", ckpt.get("state_dict", ckpt)))
        if any(k.startswith("model.") or ".layers." in k for k in sd):
            sd = hf_to_openai_keys(sd)
        asset_dirs = [os.path.dirname(src), os.path.join(os.path.dirname(src), "assets")]
    elif os.path.isdir(src):
        cfg_path = os.path.join(src, "config.json")
        if not os.path.exists(cfg_path):
            raise FileNotFoundError(f"{src}: no config.json (not a HF dir)")
        with open(cfg_path, encoding="utf8") as f:
            hf_cfg = json.load(f)
        if hf_cfg.get("model_type", "whisper") != "whisper":
            raise ValueError(f"{src}: model_type={hf_cfg.get('model_type')} is not whisper")
        st_path = os.path.join(src, "model.safetensors")
        pt_path = os.path.join(src, "pytorch_model.bin")
        if os.path.exists(st_path):
            sd = load_file(st_path)
        elif os.path.exists(pt_path):
            sd = dict(_load(pt_path))
        else:
            raise FileNotFoundError(f"{src}: no model.safetensors / pytorch_model.bin")
        sd = {k: v for k, v in sd.items() if not k.startswith("proj_out.")}
        sd = hf_to_openai_keys(sd)
        dims = dict(
            n_vocab=int(hf_cfg["vocab_size"]),
            n_audio_ctx=int(hf_cfg["max_source_positions"]),
            n_audio_state=int(hf_cfg["d_model"]),
            n_audio_head=int(hf_cfg["encoder_attention_heads"]),
            n_audio_layer=int(hf_cfg["encoder_layers"]),
            n_text_ctx=int(hf_cfg["max_target_positions"]),
            n_text_state=int(hf_cfg["d_model"]),
            n_text_head=int(hf_cfg["decoder_attention_heads"]),
            n_text_layer=int(hf_cfg["decoder_layers"]),
            n_mels=int(hf_cfg.get("num_mel_bins", 80)),
        )
        asset_dirs = [src]
    else:
        raise FileNotFoundError(src)

    torch.save({"dims": dims, "model_state_dict": sd}, out_path)
    try:
        load_whisper(out_path)  # strict round-trip validation
    except Exception:
        os.remove(out_path)
        raise
    for d in asset_dirs:
        if not os.path.isdir(d):
            continue
        for name in ("multilingual.tiktoken", "gpt2.tiktoken", "vocab.json"):
            p = os.path.join(d, name)
            if os.path.exists(p):
                shutil.copy(p, os.path.join(out_dir, name))
    return out_path
