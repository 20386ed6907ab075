"""Warm start of the v3 trainer from a reference-layout xVAPitch ``.pt``.

Counterpart of ``xva_trainer_tpu/interop/pretrained.py::load_xvapitch_base``
and ``extract_state_dict``. The product is fine-tuning: xVAPitch training
warm-starts from the shipped ``xVAPitch_5820651.pt`` base (reference
xva_train.py:104-131,250), or from any export of this repository, which
has the same layout. The HiFi-GAN and speaker-encoder loaders of the JAX
module belong to other paths.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from .convert import ups_from_reference


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
