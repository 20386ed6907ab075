"""Rule table: the reference speaker encoder's torch keys (``speaker_rep.pt``,
python/xvapitch/speaker_representation/main.py) ↔ the JAX package's flax
``ResNetSpeakerEncoder`` paths. The port's copy of
``xva_trainer_tpu/interop/speaker_map.py``: ResNet34-SE H/ASP, layers
[3,4,6,3], filters [32,64,128,256], ASP pooling, a 512-d projection.
BatchNorm running statistics live in flax's ``batch_stats`` collection."""
from __future__ import annotations

from typing import List, Tuple

from .mapping import Rule

P = Tuple[str, ...]

LAYERS = (3, 4, 6, 3)
FILTERS = (32, 64, 128, 256)


def _bn(tkey: str, fpath: P) -> List[Rule]:
    return [
        Rule(tkey + ".weight", fpath + ("scale",), "id"),
        Rule(tkey + ".bias", fpath + ("bias",), "id"),
        Rule(tkey + ".running_mean", fpath + ("mean",), "id", collection="batch_stats"),
        Rule(tkey + ".running_var", fpath + ("var",), "id", collection="batch_stats"),
    ]


def _block(tkey: str, fpath: P, has_downsample: bool) -> List[Rule]:
    rules = [
        Rule(tkey + ".conv1.weight", fpath + ("Conv_0", "kernel"), "conv2d"),
        *_bn(tkey + ".bn1", fpath + ("BatchNorm_0",)),
        Rule(tkey + ".conv2.weight", fpath + ("Conv_1", "kernel"), "conv2d"),
        *_bn(tkey + ".bn2", fpath + ("BatchNorm_1",)),
        Rule(tkey + ".se.fc.0.weight", fpath + ("Dense_0", "kernel"), "linear"),
        Rule(tkey + ".se.fc.0.bias", fpath + ("Dense_0", "bias"), "id"),
        Rule(tkey + ".se.fc.2.weight", fpath + ("Dense_1", "kernel"), "linear"),
        Rule(tkey + ".se.fc.2.bias", fpath + ("Dense_1", "bias"), "id"),
    ]
    if has_downsample:
        rules += [
            Rule(tkey + ".downsample.0.weight", fpath + ("Conv_2", "kernel"), "conv2d"),
            *_bn(tkey + ".downsample.1", fpath + ("BatchNorm_2",)),
        ]
    return rules


def speaker_encoder_rules() -> List[Rule]:
    rules: List[Rule] = [
        Rule("conv1.weight", ("Conv_0", "kernel"), "conv2d"),
        Rule("conv1.bias", ("Conv_0", "bias"), "id"),
        *_bn("bn1", ("BatchNorm_0",)),
    ]
    idx = 0
    for li, nl in enumerate(LAYERS):
        for j in range(nl):
            # layer1.0 keeps 32 channels at stride 1: no downsample branch
            rules += _block(f"layer{li + 1}.{j}", (f"SEBasicBlock_{idx}",), j == 0 and li > 0)
            idx += 1
    rules += [
        Rule("attention.0.weight", ("Conv_1", "kernel"), "conv1d"),
        Rule("attention.0.bias", ("Conv_1", "bias"), "id"),
        *_bn("attention.2", ("BatchNorm_1",)),
        Rule("attention.3.weight", ("Conv_2", "kernel"), "conv1d"),
        Rule("attention.3.bias", ("Conv_2", "bias"), "id"),
        Rule("fc.weight", ("Dense_0", "kernel"), "linear"),
        Rule("fc.bias", ("Dense_0", "bias"), "id"),
    ]
    return rules


def batch_norm_prefixes() -> List[str]:
    """Every BatchNorm of the encoder, by torch prefix (each also holds a
    ``num_batches_tracked`` counter, which flax has no counterpart of)."""
    return [r.torch_key[: -len(".running_mean")] for r in speaker_encoder_rules()
            if r.torch_key.endswith(".running_mean")]
