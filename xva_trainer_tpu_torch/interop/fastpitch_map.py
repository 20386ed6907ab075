"""Rule table: the reference FastPitch 1.1 state dict <-> JAX's flax
FastPitch, and the port's v2 export and warm start.

The port's copy of ``xva_trainer_tpu/interop/fastpitch_map.py``. The torch
side (384-d, 6 + 6 FFT layers, 1 head x 64, the ConvAttention aligner, the
duration, pitch and energy predictors) is the port's ``FastPitch``'s own
key set, so a reference state dict loads with ``strict=True`` once its
extra keys are set aside. v2 training checkpoints wrap the state dict as
{'state_dict': ..., 'epoch', 'iteration', 'avg_loss_per_epoch', ...}
(reference xva_train.py:1054-1079); the xVASynth export is the bare fp16
state dict (xva_train.py:1030-1047).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from .mapping import Rule

P = Tuple[str, ...]


def _ln(tkey: str, fpath: P) -> List[Rule]:
    return [Rule(tkey + ".weight", fpath + ("scale",), "id"),
            Rule(tkey + ".bias", fpath + ("bias",), "id")]


def _fft_rules(tp: str, fp: P, n_layers: int = 6, embed: bool = False) -> List[Rule]:
    rules: List[Rule] = []
    if embed:
        rules.append(Rule(f"{tp}.word_emb.weight", fp + ("word_emb", "embedding"), "id"))
    for i in range(n_layers):
        a = fp + (f"attn_layers_{i}",)
        ta = f"{tp}.layers.{i}.dec_attn"
        rules += [
            Rule(f"{ta}.qkv_net.weight", a + ("qkv_net", "kernel"), "linear"),
            Rule(f"{ta}.qkv_net.bias", a + ("qkv_net", "bias"), "id"),
            Rule(f"{ta}.o_net.weight", a + ("o_net", "kernel"), "linear"),
            *_ln(f"{ta}.layer_norm", a + ("LayerNorm_0",)),
        ]
        f = fp + (f"ff_layers_{i}",)
        tf = f"{tp}.layers.{i}.pos_ff"
        rules += [
            Rule(f"{tf}.CoreNet.0.weight", f + ("Conv1d_0", "Conv_0", "kernel"), "conv1d"),
            Rule(f"{tf}.CoreNet.0.bias", f + ("Conv1d_0", "Conv_0", "bias"), "id"),
            Rule(f"{tf}.CoreNet.2.weight", f + ("Conv1d_1", "Conv_0", "kernel"), "conv1d"),
            Rule(f"{tf}.CoreNet.2.bias", f + ("Conv1d_1", "Conv_0", "bias"), "id"),
            *_ln(f"{tf}.layer_norm", f + ("LayerNorm_0",)),
        ]
    return rules


def _predictor_rules(tp: str, fp: P, n_layers: int = 2) -> List[Rule]:
    rules: List[Rule] = []
    for i in range(n_layers):
        c = fp + (f"ConvReLUNorm_{i}",)
        rules += [
            Rule(f"{tp}.layers.{i}.conv.weight", c + ("Conv1d_0", "Conv_0", "kernel"), "conv1d"),
            Rule(f"{tp}.layers.{i}.conv.bias", c + ("Conv1d_0", "Conv_0", "bias"), "id"),
            *_ln(f"{tp}.layers.{i}.norm", c + ("LayerNorm_0",)),
        ]
    rules += [Rule(f"{tp}.fc.weight", fp + ("Dense_0", "kernel"), "linear"),
              Rule(f"{tp}.fc.bias", fp + ("Dense_0", "bias"), "id")]
    return rules


def fastpitch_rules(in_layers: int = 6, out_layers: int = 6) -> List[Rule]:
    rules = _fft_rules("encoder", ("encoder",), in_layers, embed=True)
    rules += _fft_rules("decoder", ("decoder",), out_layers)
    rules += _predictor_rules("duration_predictor", ("duration_predictor",))
    rules += _predictor_rules("pitch_predictor", ("pitch_predictor",))
    rules += _predictor_rules("energy_predictor", ("energy_predictor",))
    rules += [
        Rule("pitch_emb.weight", ("pitch_emb", "Conv_0", "kernel"), "conv1d"),
        Rule("pitch_emb.bias", ("pitch_emb", "Conv_0", "bias"), "id"),
        Rule("energy_emb.weight", ("energy_emb", "Conv_0", "kernel"), "conv1d"),
        Rule("energy_emb.bias", ("energy_emb", "Conv_0", "bias"), "id"),
        Rule("proj.weight", ("proj", "kernel"), "linear"),
        Rule("proj.bias", ("proj", "bias"), "id"),
    ]
    # the ConvAttention aligner: the key path, then the query path (flax's
    # creation order)
    for i, (tkey, idx) in enumerate((("key_proj", 0), ("key_proj", 2), ("query_proj", 0),
                                     ("query_proj", 2), ("query_proj", 4))):
        for leaf, tleaf, kind in (("kernel", "weight", "conv1d"), ("bias", "bias", "id")):
            rules.append(Rule(f"attention.{tkey}.{idx}.conv.{tleaf}",
                              ("attention", f"Conv1d_{i}", "Conv_0", leaf), kind))
    return rules


def rules_for_config(cfg) -> List[Rule]:
    return fastpitch_rules(cfg.in_fft_n_layers, cfg.out_fft_n_layers)


def _inv_freq(dim: int = 384) -> np.ndarray:
    return (1.0 / (10000.0 ** (np.arange(0.0, dim, 2.0) / dim))).astype(np.float32)


def fastpitch_extra_keys(pitch_mean: float = 0.0, pitch_std: float = 1.0, dtype=np.float16,
                         d_model: int = 384) -> Dict[str, np.ndarray]:
    """The reference keys with no parameter in the model: the sinusoid
    buffers (recomputed), the unused aligner ``attn_proj``, and the pitch
    normalisation buffers (host state, ``pitch_stats.json``)."""
    return {
        "pitch_mean": np.asarray([pitch_mean], dtype),
        "pitch_std": np.asarray([pitch_std], dtype),
        "encoder.pos_emb.inv_freq": _inv_freq(d_model).astype(dtype),
        "decoder.pos_emb.inv_freq": _inv_freq(d_model).astype(dtype),
        "attention.attn_proj.weight": np.zeros((1, 80, 1, 1), dtype),
        "attention.attn_proj.bias": np.zeros((1,), dtype),
    }


def fastpitch_state_dict(model: nn.Module, *, pitch_mean: float = 0.0, pitch_std: float = 1.0,
                         dtype=torch.float16) -> "OrderedDict[str, torch.Tensor]":
    """The port's FastPitch → the reference's flat state dict (fp16 by
    default) with the extra keys: the JAX package's ``fastpitch_state_dict``
    of the same parameters."""
    sd = OrderedDict((k, v.detach().cpu().to(dtype).contiguous())
                     for k, v in model.state_dict().items())
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    for k, v in fastpitch_extra_keys(pitch_mean, pitch_std, np_dtype,
                                     model.cfg.symbols_embedding_dim).items():
        sd[k] = torch.from_numpy(v)
    return sd


def load_fastpitch_checkpoint(path: str, model: nn.Module) -> Dict:
    """A reference FastPitch checkpoint or export (or the port's) → ``model``
    (a ``FastPitch``), strictly, in place, on its own device and type.
    Every rule key must be in the file; the extra keys are set aside.
    Returns the host meta: ``pitch_mean``, ``pitch_std`` and, where the file
    has them, ``epoch``, ``iteration``, ``training_stage`` and
    ``avg_loss_per_epoch``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt.get("model", ckpt))
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    keys = [r.torch_key for r in rules_for_config(model.cfg)]
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"{len(missing)} torch keys missing: {missing[:8]} ...")
    with torch.no_grad():
        model.load_state_dict({k: sd[k] for k in keys}, strict=True)
    meta = {"pitch_mean": float(np.asarray(sd.get("pitch_mean", [0.0]), np.float64)[0]),
            "pitch_std": float(np.asarray(sd.get("pitch_std", [1.0]), np.float64)[0])}
    for k in ("epoch", "iteration", "training_stage", "avg_loss_per_epoch"):
        if isinstance(ckpt, dict) and k in ckpt:
            meta[k] = ckpt[k]
    return meta
