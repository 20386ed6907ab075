"""Convolution helpers shared by the port's models."""
from __future__ import annotations

import warnings

import torch
import torch.nn as nn


def weight_norm(module: nn.Module, dim: int = 0) -> nn.Module:
    """Legacy ``torch.nn.utils.weight_norm`` (``weight_g``/``weight_v``, the
    reference's key names) over the output axis ``dim``; its deprecation
    warning is silenced. The scale starts at 1 per output filter, as flax's
    ``nn.WeightNorm`` initialises it, so the effective weight starts as the
    module's own weight normalised to unit norm (torch would keep its norm)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        module = nn.utils.weight_norm(module, dim=dim)
    with torch.no_grad():
        module.weight_g.fill_(1.0)
    return module


def same_conv1d(in_ch: int, out_ch: int, kernel_size: int = 1, dilation: int = 1,
                groups: int = 1, bias: bool = True) -> nn.Conv1d:
    """Conv1d with symmetric 'same' padding (odd effective kernels)."""
    return nn.Conv1d(in_ch, out_ch, kernel_size, dilation=dilation, groups=groups,
                     padding=dilation * (kernel_size - 1) // 2, bias=bias)
