"""SSIM over spectrogram images (reference python/xvapitch/util.py:601-640:
an 11 × 11 Gaussian window through a grouped conv2d), in PyTorch.

Counterpart of ``xva_trainer_tpu/ops/ssim.py``. The JAX function is a plain
product (``lax.conv_general_dilated``), not a Pallas kernel, so the port's
is ``F.conv2d`` with ``groups=C`` and lax's "SAME" padding.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)[None, None]  # (1, 1, k, k)


def _blur(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """Depthwise Gaussian blur of (B, C, H, W), SAME-padded with zeros."""
    C = x.shape[1]
    k = torch.from_numpy(_window(window_size)).to(x).expand(C, 1, window_size, window_size)
    lo = (window_size - 1) // 2
    x = F.pad(x, (lo, window_size - 1 - lo, lo, window_size - 1 - lo))
    return F.conv2d(x, k, groups=C)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """img (B, C, H, W) in [0, 1]; the mean SSIM, or per item (B,)."""
    mu1, mu2 = _blur(img1, window_size), _blur(img2, window_size)
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = _blur(img1 * img1, window_size) - mu1_sq
    s2 = _blur(img2 * img2, window_size) - mu2_sq
    s12 = _blur(img1 * img2, window_size) - mu12
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu12 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return m.mean() if size_average else m.mean(dim=(1, 2, 3))
