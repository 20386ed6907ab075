"""Warm starts from reference-layout checkpoints: the v3 trainer's
xVAPitch ``.pt`` and the HiFi-GAN trainer's ``g_``/``do_`` files.

Counterpart of ``xva_trainer_tpu/interop/pretrained.py``'s
``load_xvapitch_base``, ``extract_state_dict``, ``load_hifigan_generator``
and ``load_hifigan_discriminators``. The product is fine-tuning: xVAPitch
training warm-starts from the shipped ``xVAPitch_5820651.pt`` base
(reference xva_train.py:104-131,250), or from any export of this
repository, which has the same layout; the reference's HiFi-GAN stage from
the [male]/[female] ``g_``/``do_`` checkpoints (hifigan/xva_train.py:276-296).
The speaker-encoder loader belongs to ``models/speaker_encoder``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from .convert import ups_from_reference
from .hifigan_map import import_msd_spectral


def extract_state_dict(ckpt: Dict[str, Any]) -> Dict[str, Any]:
    """Reference checkpoints hold the model under 'model' (training
    checkpoints, xva_train.py:952-963), 'state_dict' or 'generator', or are
    a bare state dict (exports)."""
    for key in ("model", "state_dict", "generator"):
        if key in ckpt and isinstance(ckpt[key], dict):
            return ckpt[key]
    return ckpt


@torch.no_grad()
def load_xvapitch_base(path: str, model: nn.Module, disc: Optional[nn.Module] = None) -> bool:
    """Load a reference-layout xVAPitch ``.pt`` into ``model`` (an
    ``XVAPitch``) and, when the file has ``disc.*`` keys, into ``disc`` (a
    ``VitsDiscriminator``), both with ``strict=True``, in place, on the
    modules' own device and dtype. The decoder's upsampling weight norm is
    moved to the port's layout first (``convert.ups_from_reference``), as
    ``serve.load_xvapitch`` does. Without ``disc.*`` keys the discriminator
    is left as it is. Returns whether the discriminator was loaded."""
    sd = extract_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    g_sd = {k: v for k, v in sd.items() if not k.startswith("disc.") and k != "step"}
    model.load_state_dict(ups_from_reference(g_sd), strict=True)
    d_sd = {k[len("disc."):]: v for k, v in sd.items() if k.startswith("disc.")}
    if d_sd and disc is not None:
        disc.load_state_dict(d_sd, strict=True)
    return bool(d_sd) and disc is not None


@torch.no_grad()
def load_hifigan_generator(path: str, gen: nn.Module) -> None:
    """Load a reference ``g_`` checkpoint ({'generator': sd}, or a bare state
    dict) into ``gen`` (the port's v2 ``Generator``) with ``strict=True``, in
    place, its ``ups`` weight norm moved to the port's layout first
    (``convert.ups_from_reference``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    gen.load_state_dict(ups_from_reference(ckpt.get("generator", ckpt)), strict=True)


@torch.no_grad()
def load_hifigan_discriminators(path: str, disc: nn.Module) -> Dict[str, Any]:
    """Load a reference ``do_`` checkpoint ({'mpd': sd, 'msd': sd, 'steps',
    'epoch', ...}) into ``disc`` (the port's ``HifiganDiscriminator``) with
    ``strict=True``, in place. Returns the file's ``steps`` and ``epoch``.

    The MPD and the weight-normed MSD discs load as they are (the same keys
    and layout); MSD disc 0 through ``import_msd_spectral``: ``weight_orig``,
    ``weight_u`` and ``weight_v`` from the file. As in the JAX package, the
    file's u is where the next power iteration starts: every forward
    iterates once more from it, so after a warm start the effective weight
    is W/σ of that iteration, not the reference's stored W/σ."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = {f"{group}.{k}": v for group in ("mpd", "msd") for k, v in ckpt[group].items()}
    spectral = import_msd_spectral({k: v.numpy() for k, v in sd.items()
                                    if k.startswith("msd.discriminators.0.")})
    sd.update({k: torch.from_numpy(v) for k, v in spectral.items()})
    disc.load_state_dict(sd, strict=True)
    return {k: ckpt[k] for k in ("steps", "epoch") if k in ckpt}
