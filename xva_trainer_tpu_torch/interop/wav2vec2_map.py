"""HuggingFace ``Wav2Vec2ForCTC`` checkpoints for the port, and the rule
table that carries the JAX package's flax wav2vec2 across.

The port's copy of ``xva_trainer_tpu/interop/wav2vec2_map.py``. The port's
``models/wav2vec2`` keeps HuggingFace's key names; ``load_wav2vec2`` picks
the model's keys out of the checkpoint (a ``KeyError`` names those missing;
others, such as ``masked_spec_embed``, are ignored, as in the JAX package),
with the positional conv's weight norm in either naming.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import torch

from .mapping import Rule

POS_CONV = "wav2vec2.encoder.pos_conv_embed.conv"


def _ln(tkey: str, fpath) -> List[Rule]:
    return [
        Rule(tkey + ".weight", fpath + ("scale",), "id"),
        Rule(tkey + ".bias", fpath + ("bias",), "id"),
    ]


def _dense(tkey: str, fpath, bias: bool = True) -> List[Rule]:
    rules = [Rule(tkey + ".weight", fpath + ("kernel",), "linear")]
    if bias:
        rules.append(Rule(tkey + ".bias", fpath + ("bias",), "id"))
    return rules


def wav2vec2_rules(num_conv: int, num_layers: int) -> List[Rule]:
    """Every entry of the model but the positional conv's weight-norm pair
    (``_pos_conv_weight``)."""
    W = "wav2vec2."
    rules: List[Rule] = []
    for i in range(num_conv):
        rules.append(Rule(f"{W}feature_extractor.conv_layers.{i}.conv.weight",
                          ("feature_extractor", f"conv_{i}", "kernel"), "conv1d"))
    rules += [
        Rule(f"{W}feature_extractor.conv_layers.0.layer_norm.weight",
             ("feature_extractor", "group_norm", "scale"), "id"),
        Rule(f"{W}feature_extractor.conv_layers.0.layer_norm.bias",
             ("feature_extractor", "group_norm", "bias"), "id"),
    ]
    rules += _ln(f"{W}feature_projection.layer_norm", ("fp_layer_norm",))
    rules += _dense(f"{W}feature_projection.projection", ("fp_projection",))
    rules.append(Rule(f"{POS_CONV}.bias", ("pos_conv_embed", "conv", "bias"), "id"))
    rules += _ln(f"{W}encoder.layer_norm", ("encoder_layer_norm",))
    for i in range(num_layers):
        t = f"{W}encoder.layers.{i}"
        f = (f"layer_{i}",)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            rules += _dense(f"{t}.attention.{proj}", f + (proj,))
        rules += _ln(f"{t}.layer_norm", f + ("layer_norm",))
        rules += _dense(f"{t}.feed_forward.intermediate_dense", f + ("intermediate_dense",))
        rules += _dense(f"{t}.feed_forward.output_dense", f + ("output_dense",))
        rules += _ln(f"{t}.final_layer_norm", f + ("final_layer_norm",))
    rules += _dense("lm_head", ("lm_head",))
    return rules


def _pos_conv_weight(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The positional conv's weight norm (dim 2: g (1, 1, k) over dims 0
    and 1 of v) as the port's ``weight_g``/``weight_v``, from either the
    parametrizations naming or the legacy one."""
    new = f"{POS_CONV}.parametrizations.weight.original"
    if new + "0" in sd:
        g, v = sd[new + "0"], sd[new + "1"]
    else:
        g, v = sd[f"{POS_CONV}.weight_g"], sd[f"{POS_CONV}.weight_v"]
    return {f"{POS_CONV}.weight_g": g, f"{POS_CONV}.weight_v": v}


def load_wav2vec2(hf_dir: str):
    """HF checkpoint directory (``config.json``, ``pytorch_model.bin``,
    ``vocab.json``) → (fp32 state dict of the port's ``Wav2Vec2Model``,
    ``Wav2Vec2Config``, vocabulary)."""
    from ..models.wav2vec2 import Wav2Vec2Config

    with open(os.path.join(hf_dir, "config.json"), encoding="utf8") as f:
        hc = json.load(f)
    cfg = Wav2Vec2Config(
        vocab_size=hc["vocab_size"],
        hidden_size=hc["hidden_size"],
        num_layers=hc["num_hidden_layers"],
        num_heads=hc["num_attention_heads"],
        intermediate_size=hc["intermediate_size"],
        conv_dim=tuple(hc["conv_dim"]),
        conv_stride=tuple(hc["conv_stride"]),
        conv_kernel=tuple(hc["conv_kernel"]),
        pos_conv_kernel=hc["num_conv_pos_embeddings"],
        pos_conv_groups=hc["num_conv_pos_embedding_groups"],
    )
    ckpt_path = None
    for name in ("pytorch_model.bin", "model.pt", "pytorch_model.pt"):
        p = os.path.join(hf_dir, name)
        if os.path.exists(p):
            ckpt_path = p
            break
    if ckpt_path is None:
        raise FileNotFoundError(f"no torch checkpoint in {hf_dir}")
    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    keys = [r.torch_key for r in wav2vec2_rules(len(cfg.conv_dim), cfg.num_layers)]
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"{len(missing)} torch keys missing: {missing[:8]} ...")
    out = {k: sd[k] for k in keys}
    out.update(_pos_conv_weight(sd))
    out = {k: torch.as_tensor(v).to(torch.float32) for k, v in out.items()}
    vocab = {}
    vp = os.path.join(hf_dir, "vocab.json")
    if os.path.exists(vp):
        with open(vp, encoding="utf8") as f:
            vocab = json.load(f)
    return out, cfg, vocab
