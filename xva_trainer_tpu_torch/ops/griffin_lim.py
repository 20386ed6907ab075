"""Griffin-Lim phase reconstruction and the inverse STFT, in plain torch.

Counterpart of ``xva_trainer_tpu/ops/griffin_lim.py`` (reference
AudioProcessor griffin-lim, python/xvapitch/audio.py:632-760, and the
conv-basis iSTFT, python/xvapitch/stft.py:121-153). The FastPitch
trainer's previews turn predicted mels into audio with it
(output_samples, xva_train.py:1323-1365), without a vocoder.

The initial phases are uniform in [-pi, pi): given as ``angles``, or drawn
from a ``torch.Generator`` seeded ``seed`` (JAX draws them with
``jax.random.uniform``; the draws differ between the packages).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .mel import inverse_mel_filterbank
from .stft import DEFAULT_MEL, MelConfig, frame_signal, hann_window


def _window(cfg: MelConfig, device) -> torch.Tensor:
    return torch.from_numpy(hann_window(cfg.win_length, cfg.n_fft)).to(device)


def istft(spec: torch.Tensor, cfg: MelConfig = DEFAULT_MEL) -> torch.Tensor:
    """Complex (n_freqs, T) → waveform of (T - 1)·hop samples by overlap-add
    with the window-sum-square normalisation."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    frames = torch.fft.irfft(spec.T, n=n_fft, dim=-1)  # (T, n_fft)
    win = _window(cfg, spec.device)
    frames = frames * win
    T = spec.shape[-1]
    out_len = n_fft + (T - 1) * hop
    idx = (torch.arange(T, device=spec.device)[:, None] * hop
           + torch.arange(n_fft, device=spec.device)[None, :]).reshape(-1)
    out = torch.zeros(out_len, device=spec.device).index_add_(0, idx, frames.reshape(-1))
    wss = torch.zeros(out_len, device=spec.device).index_add_(
        0, idx, (win ** 2).repeat(T))
    out = out / torch.clamp(wss, min=1e-8)
    return out[n_fft // 2: n_fft // 2 + (T - 1) * hop]


def _stft_complex(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    n_fft, hop = cfg.n_fft, cfg.hop_length
    T = y.shape[-1]
    y = torch.nn.functional.pad(y[None, None], (n_fft // 2, n_fft // 2), mode="reflect")[0, 0]
    num_frames = 1 + T // hop
    need = (num_frames + n_fft // hop - 1) * hop
    if y.shape[-1] < need:
        y = torch.nn.functional.pad(y, (0, need - y.shape[-1]))
    frames = frame_signal(y, n_fft, hop, num_frames)
    return torch.fft.rfft(frames * _window(cfg, y.device), n=n_fft, dim=-1).T


def griffin_lim(magnitude: torch.Tensor, cfg: MelConfig = DEFAULT_MEL, n_iter: int = 32,
                seed: int = 0, angles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """|STFT| (n_freqs, T) → waveform by ``n_iter`` rounds of phase
    refinement from ``angles`` (default: uniform, seeded ``seed``)."""
    if angles is None:
        g = torch.Generator().manual_seed(seed)
        angles = (torch.rand(magnitude.shape, generator=g) * (2 * np.pi) - np.pi)
    angles = angles.to(magnitude.device, torch.float32)
    T = magnitude.shape[1]
    for _ in range(n_iter):
        y = istft(magnitude * torch.exp(1j * angles), cfg)
        angles = torch.angle(_stft_complex(y, cfg)[:, :T])
    return istft(magnitude * torch.exp(1j * angles), cfg)


def mel_to_wav(log_mel: torch.Tensor, cfg: MelConfig = DEFAULT_MEL, n_iter: int = 32,
               seed: int = 0, angles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """log-mel (n_mels, T) → waveform (preview quality, Griffin-Lim)."""
    inv = torch.from_numpy(inverse_mel_filterbank(
        sample_rate=cfg.sample_rate, n_fft=cfg.n_fft, n_mels=cfg.n_mels, fmin=cfg.fmin,
        fmax=cfg.fmax)).to(log_mel.device)
    mag = torch.clamp(inv @ torch.exp(log_mel.float()), min=0.0)
    return griffin_lim(mag, cfg, n_iter, seed, angles)
