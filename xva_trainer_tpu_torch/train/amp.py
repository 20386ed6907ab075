"""Mixed precision for training: bf16 compute, fp32 master parameters, fp32
losses.

Counterpart of ``xva_trainer_tpu/train/amp.py``. The JAX package casts the
parameters and float inputs to bf16 at the model's boundary; here
``torch.autocast`` runs the convolutions and matrix products in bf16 while
the parameters, their gradients and the optimiser state stay fp32. bf16
keeps fp32's exponent range, so no gradient scaler is needed. The duration
predictor runs in an autocast-disabled region (its spline flows' logdets),
MAS accumulates fp32 inside ``ops/mas.py``, and every loss is computed in
fp32 from outputs cast back with ``to_fp32``.
"""
from __future__ import annotations

import torch


def autocast(device: torch.device, enabled: bool = True):
    """bf16 autocast on ``device``'s type (a no-op context when disabled)."""
    return torch.autocast(device_type=device.type, dtype=torch.bfloat16, enabled=enabled)


def to_fp32(tree):
    """Cast every floating tensor of a dict/list/tuple tree to fp32; other
    leaves pass through."""
    if isinstance(tree, dict):
        return {k: to_fp32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_fp32(v) for v in tree)
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.float()
    return tree
