"""Carry the JAX package's parameters across to the port (xVAPitch, its
discriminator, FastPitch, HiFi-GAN, the speaker encoder, whisper, wav2vec2
and the enhancer), and move the decoder's upsampling weight norm between
the reference's layout and the port's."""
from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch

from .mapping import apply_carry
from .xvapitch_map import rules_for_config, unused_torch_defaults, vits_disc_rules

_UPS_G = re.compile(r"(^|\.)ups\.\d+\.weight_g$")


def _tensors(sd: Dict[str, np.ndarray]) -> "OrderedDict[str, torch.Tensor]":
    return OrderedDict((k, torch.from_numpy(v)) for k, v in sd.items())


def xvapitch_state_dict(jax_params_as_numpy: Dict, cfg) -> Dict[str, torch.Tensor]:
    """JAX XVAPitch parameters (a nested dict of numpy arrays, with or
    without the top-level ``"params"`` key) → the fp32 state dict that loads
    the port's ``XVAPitch(cfg)`` with ``strict=True``.

    Weight norm is carried as flax holds it (``weight_v`` the kernel,
    ``weight_g`` the scale), so that a training step moves the port's
    parameters as it moves the JAX package's. The reference's unused last
    ``norm_layers_2`` of the pitch transformer is emitted at its initial
    value, as the JAX export does.
    """
    sd = apply_carry(jax_params_as_numpy, rules_for_config(cfg))
    for k, (kind, shape) in unused_torch_defaults(cfg.pitch_layers).items():
        sd[k] = (np.ones if kind == "ones" else np.zeros)(shape, np.float32)
    return _tensors(sd)


def vits_disc_state_dict(jax_params_as_numpy: Dict) -> Dict[str, torch.Tensor]:
    """JAX VitsDiscriminator parameters → the fp32 state dict of the port's
    ``VitsDiscriminator``, weight norm carried as in ``xvapitch_state_dict``."""
    return _tensors(apply_carry(jax_params_as_numpy, vits_disc_rules(tp="")))


def train_state_dicts(g_params: Dict, d_params: Dict, cfg) -> Tuple[Dict, Dict]:
    """The JAX trainer's generator and discriminator params (numpy) → the
    port's (XVAPitch, VitsDiscriminator) state dicts."""
    return xvapitch_state_dict(g_params, cfg), vits_disc_state_dict(d_params)


def fastpitch_state_dict(jax_params_as_numpy: Dict, cfg) -> Dict[str, torch.Tensor]:
    """JAX FastPitch parameters (numpy, with or without the top-level
    ``"params"`` key) → the fp32 state dict that loads the port's
    ``FastPitch(cfg)`` with ``strict=True``."""
    from .fastpitch_map import rules_for_config

    return _tensors(apply_carry(jax_params_as_numpy, rules_for_config(cfg)))


def hifigan_v2_state_dict(jax_params_as_numpy: Dict, cfg) -> Dict[str, torch.Tensor]:
    """JAX standalone v2 ``Generator`` parameters → the fp32 state dict of the
    port's ``Generator(cfg)``, weight norm carried as in
    ``xvapitch_state_dict``."""
    from .hifigan_map import v2_generator_rules

    rules = v2_generator_rules(num_ups=len(cfg.upsample_rates),
                               num_kernels=len(cfg.resblock_kernel_sizes),
                               num_dilations=len(cfg.resblock_dilation_sizes[0]))
    return _tensors(apply_carry(jax_params_as_numpy, rules))


def hifigan_v2_disc_state_dict(jax_params_as_numpy: Dict,
                               jax_batch_stats_as_numpy: Dict) -> Dict[str, torch.Tensor]:
    """A JAX ``HifiganDiscriminator``'s parameters and spectral-norm
    ``batch_stats`` (numpy, with or without the top-level keys) → the fp32
    state dict of the port's ``HifiganDiscriminator`` with as many periods
    and scales: the weight norms carried as in ``xvapitch_state_dict``; MSD
    disc 0's kernels as ``weight_orig`` and its ``u`` as ``weight_u``, then
    ``import_msd_spectral`` (``weight_v`` = normalize(Wᵀu), which the forward
    never reads)."""
    from .hifigan_map import SPECTRAL_CONVS, import_msd_spectral, v2_mpd_rules, v2_msd_wn_rules
    from .mapping import _f2t

    params = jax_params_as_numpy.get("params", jax_params_as_numpy)
    stats = jax_batch_stats_as_numpy.get("batch_stats", jax_batch_stats_as_numpy)
    mpd, msd = params["MultiPeriodDiscriminator_0"], params["MultiScaleDiscriminator_0"]
    sd = apply_carry(params, v2_mpd_rules(num_periods=len(mpd))
                     + v2_msd_wn_rules(num_scales=len(msd)))
    s_params = msd["DiscriminatorS_0"]
    s_stats = stats["MultiScaleDiscriminator_0"]["DiscriminatorS_0"]
    spectral = {}
    for i, name in enumerate(SPECTRAL_CONVS):
        key = f"msd.discriminators.0.{name}"
        conv = s_params[f"Conv_{i}"]
        spectral[key + ".weight_orig"] = _f2t(np.asarray(conv["kernel"], np.float32), "conv1d")
        spectral[key + ".bias"] = conv["bias"]
        spectral[key + ".weight_u"] = s_stats[f"SpectralNorm_{i}"][f"Conv_{i}/kernel/u"].reshape(-1)
    sd.update((k, np.array(v, np.float32, order="C"))
              for k, v in import_msd_spectral(spectral).items())
    return _tensors(sd)


def _norm_except(w: torch.Tensor, dim: int) -> torch.Tensor:
    dims = [d for d in range(w.dim()) if d != dim]
    return torch.sqrt(torch.sum(w * w, dim=dims, keepdim=True))


def _renorm(sd: Dict[str, torch.Tensor], src_dim: int, dst_dim: int) -> Dict[str, torch.Tensor]:
    """Re-split each upsampling (weight_g, weight_v) pair normalised over
    ``src_dim`` into one normalised over ``dst_dim``: the effective weight
    w = g v / ||v|| is kept (computed in float64), v = w and g = ||w||.
    Pairs not in ``src_dim``'s layout (g of v's size along ``src_dim``, 1
    elsewhere) pass through: they are over ``dst_dim`` already."""
    out = OrderedDict(sd)
    for kg in sd:
        if not _UPS_G.search(kg):
            continue
        g = sd[kg]
        kv = kg[:-1] + "v"
        src_shape = [1] * sd[kv].dim()
        src_shape[src_dim] = sd[kv].shape[src_dim]
        if list(g.shape) != src_shape:
            continue  # already normalised over dst_dim
        v = sd[kv].double()
        w = g.double() * v / _norm_except(v, src_dim)
        out[kg] = _norm_except(w, dst_dim).to(torch.float32)
        out[kv] = w.to(torch.float32)
    return out


def ups_from_reference(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference state dict (``weight_g`` of the decoder's ConvTranspose1d
    ``ups`` of shape (in, 1, 1): per input channel) → the port's layout
    (1, out, 1): per output channel. Every other entry is unchanged; so is
    every upsampling conv's effective weight, up to fp32 rounding."""
    return _renorm(sd, 0, 1)


def ups_to_reference(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of ``ups_from_reference``: the port's state dict → the
    reference's layout, for writing a ``.pt`` that xVASynth loads."""
    return _renorm(sd, 1, 0)


def speaker_encoder_state_dict(jax_variables_as_numpy: Dict) -> Dict[str, torch.Tensor]:
    """The JAX ``ResNetSpeakerEncoder``'s variables (``params`` and
    ``batch_stats``, numpy) → the state dict that loads the port's
    ``ResNetSpeakerEncoder`` with ``strict=True``: the rules' entries and each
    BatchNorm's ``num_batches_tracked`` at 0, as a fresh torch module has it."""
    from .speaker_map import batch_norm_prefixes, speaker_encoder_rules

    sd = _tensors(apply_carry(jax_variables_as_numpy, speaker_encoder_rules()))
    for p in batch_norm_prefixes():
        sd[p + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def _count(tree: Dict, prefix: str) -> int:
    return sum(1 for k in tree if k.startswith(prefix))


def whisper_state_dict(jax_params_as_numpy: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``Whisper`` parameters (numpy, with or without the top-level
    ``"params"`` key) → the fp32 state dict of the port's ``Whisper`` in
    OpenAI's names (``interop/whisper_map.py::whisper_rules``)."""
    from .whisper_map import whisper_rules

    p = jax_params_as_numpy.get("params", jax_params_as_numpy)
    rules = whisper_rules(_count(p["encoder"], "block_"), _count(p["decoder"], "block_"))
    return _tensors(apply_carry(p, rules))


def wav2vec2_state_dict(jax_params_as_numpy: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``Wav2Vec2Model`` parameters (numpy) → the fp32 state dict of
    the port's ``Wav2Vec2Model`` in HuggingFace's names. JAX holds the
    positional conv's folded kernel; it is split into ``weight_v`` (the
    kernel) and ``weight_g`` (its norm over dims 0 and 1, per kernel
    position)."""
    from .mapping import _f2t
    from .wav2vec2_map import POS_CONV, wav2vec2_rules

    p = jax_params_as_numpy.get("params", jax_params_as_numpy)
    rules = wav2vec2_rules(_count(p["feature_extractor"], "conv_"), _count(p, "layer_"))
    sd = apply_carry(p, rules)
    w = _f2t(np.asarray(p["pos_conv_embed"]["conv"]["kernel"], np.float32), "conv1d")
    sd[f"{POS_CONV}.weight_g"] = np.sqrt((w.astype(np.float64) ** 2).sum(
        axis=(0, 1), keepdims=True)).astype(np.float32)
    sd[f"{POS_CONV}.weight_v"] = np.array(w, order="C")
    return _tensors(sd)


def enhancer_rules(depth: int):
    """flax's auto-names of ``ComplexMaskNet`` (call order) → the port's
    modules (``models/enhance/model.py``)."""
    from .mapping import Rule

    def conv(tkey, name, kind):
        return [Rule(tkey + ".weight", (name, "kernel"), kind),
                Rule(tkey + ".bias", (name, "bias"), "id")]

    def norm(tkey, name):
        return [Rule(tkey + ".weight", (name, "scale"), "id"),
                Rule(tkey + ".bias", (name, "bias"), "id")]

    rules = []
    for d in range(depth):
        rules += conv(f"enc.{d}", f"Conv_{2 * d}", "conv2d")
        rules += norm(f"enc_norm.{d}", f"LayerNorm_{d}")
        rules += conv(f"down.{d}", f"Conv_{2 * d + 1}", "conv2d")
    for i in range(depth):
        rules += conv(f"up.{i}", f"ConvTranspose_{i}", "convT2d")
        rules += norm(f"dec_norm.{i}", f"LayerNorm_{depth + i}")
    return rules + conv("out", f"Conv_{2 * depth}", "conv2d")


def enhancer_state_dict(jax_params_as_numpy: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``ComplexMaskNet`` parameters (numpy; the shipped
    ``enhancer_default.npz`` unflattened) → the fp32 state dict of the
    port's ``ComplexMaskNet``; each transposed conv's kernel flipped on
    both spatial axes (kind ``convT2d``)."""
    p = jax_params_as_numpy.get("params", jax_params_as_numpy)
    return _tensors(apply_carry(p, enhancer_rules(_count(p, "ConvTranspose_"))))


def waveglow_rules(cfg):
    """flax's names of ``WaveGlow`` → the port's modules
    (``models/waveglow/model.py``)."""
    from .mapping import Rule
    from .xvapitch_map import _wn_rules

    rules = [Rule("upsample.weight", ("upsample", "kernel"), "convT1d"),
             Rule("upsample.bias", ("upsample", "bias"), "id")]
    for k in range(cfg.n_flows):
        tk, fk = f"couplings.{k}", f"couplings_{k}"
        rules.append(Rule(f"convs.{k}.W", (f"convs_{k}", "W"), "id"))
        for name in ("start", "end"):
            rules += [Rule(f"{tk}.{name}.weight", (fk, name, "kernel"), "linear"),
                      Rule(f"{tk}.{name}.bias", (fk, name, "bias"), "id")]
        rules += _wn_rules(f"{tk}.wn", (fk, "wn"), cfg.wn_layers, cond=True)
    return rules


def waveglow_state_dict(jax_params_as_numpy: Dict, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``WaveGlow`` parameters (numpy) → the fp32 state dict of the
    port's ``WaveGlow``: the upsampler's kernel flipped (kind ``convT1d``),
    each weight norm carried as flax holds it."""
    return _tensors(apply_carry(jax_params_as_numpy, waveglow_rules(cfg)))
