"""Fused waveform → log-mel (+ 513-bin linear) spectrogram: the wrapper of
the hand-written CUDA kernel ``csrc/fused_stft.cu`` and its plain version.

Counterpart of ``xva_trainer_tpu/ops/pallas_stft.py::mel_spectrogram_pallas``
with the same host contract:

- ``center=True``: reflect-pad n_fft/2 (Tacotron); ``center=False``:
  reflect-pad (n_fft-hop)/2, used with ``mag_eps=1e-9`` (HiFi-GAN);
  ``center=None``: the caller already padded, frames = 1 + (T-n_fft)//hop;
- input (T,) or (B, T); output (..., n_mels, frames) and, with
  ``return_linear``, (..., n_freqs, frames).

The JAX function's ``algorithm`` ("split" or "full") chooses how the TPU's
matrix unit groups the DFT; both compute one function, which the one CUDA
kernel here computes by an FFT, so the port takes no such argument.

A CUDA tensor goes through the kernel (n_fft must be 1024; any hop) or the
call raises; a CPU tensor goes through the plain version. Nothing falls back
from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _cuda
from .mel import mel_filterbank
from .stft import (DEFAULT_MEL, MelConfig, device_constant, dft_basis, frame_signal,
                   hann_window, mel_basis, num_frames_for, pad_for_center)

KERNEL = "fused_stft"
KERNEL_N_FFT = 1024
_HALF = KERNEL_N_FFT // 2   # length of the kernel's complex FFT


# ---------------- constants (numpy, host) ----------------


def _cis(angle: np.ndarray) -> np.ndarray:
    """(n, 2) float32 [cos, sin] of float64 angles."""
    return np.stack([np.cos(angle), np.sin(angle)], -1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def kernel_consts(cfg: MelConfig) -> Tuple[np.ndarray, ...]:
    """The kernel's tables, computed in float64 and stored as float32, each
    complex one as (n, 2) [re, im]:

    - the window as (512, 2) pairs (w[2m], w[2m+1]);
    - the 512-point FFT's twiddles exp(-2πi e/512) in the order its passes
      read them: pass 2's at 8 (r-1) + t, e = 8 r t (r = 1..7, t = j % 8),
      then pass 3's at 56 + 64 (r-1) + j, e = r j (j < 64); (512, 2) with
      the last 8 rows unused;
    - the post-processing twiddles exp(-2πik/1024), k < 512;
    - the mel filters' nonzero weights, packed filter after filter and
      zero-padded to a multiple of 4;
    - each filter's (lo, hi, first weight, 0): its nonzero bins are
      [lo, hi), int32 (n_mels, 4)."""
    win = hann_window(cfg.win_length, KERNEL_N_FFT).reshape(_HALF, 2)
    r = np.arange(1, 8)[:, None]
    e = np.concatenate([(8 * r * np.arange(8)).ravel(), (r * np.arange(64)).ravel(),
                        np.zeros(_HALF - 7 * 72)])
    twp = _cis(-2 * np.pi * e / _HALF)
    tw1024 = _cis(-2 * np.pi * np.arange(_HALF) / KERNEL_N_FFT)
    fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    nz = fb != 0
    lo = np.where(nz.any(1), nz.argmax(1), 0).astype(np.int32)
    hi = np.where(nz.any(1), fb.shape[1] - nz[:, ::-1].argmax(1), 0).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(hi - lo)])
    melw = np.zeros(-(-off[-1] // 4) * 4, np.float32)
    for m in range(cfg.n_mels):
        melw[off[m]:off[m + 1]] = fb[m, lo[m]:hi[m]]
    span = np.stack([lo, hi, off[:-1], np.zeros_like(lo)], 1).astype(np.int32)
    return np.ascontiguousarray(win), twp, tw1024, melw, span


@functools.lru_cache(maxsize=None)
def _device_kernel_consts(cfg: MelConfig, device: torch.device):
    return tuple(torch.from_numpy(c).to(device) for c in kernel_consts(cfg))


# ---------------- host contract ----------------


def _prepare(y: torch.Tensor, cfg: MelConfig, center):
    if y.dim() not in (1, 2):
        raise ValueError(f"expected (T,) or (B, T) input, got {tuple(y.shape)}")
    num_frames = num_frames_for(y.shape[-1], cfg, center)
    if num_frames < 1:
        raise ValueError(f"signal of {y.shape[-1]} samples holds no frame")
    yp = pad_for_center(y.float(), cfg, center)
    return yp.reshape(-1, yp.shape[-1]).contiguous(), num_frames


def _finish(y: torch.Tensor, mel: torch.Tensor, lin: Optional[torch.Tensor],
            return_linear: bool):
    if y.dim() == 1:
        mel = mel[0]
        lin = lin[0] if lin is not None else None
    return (mel, lin) if return_linear else mel


def _plain(yp: torch.Tensor, cfg: MelConfig, num_frames: int, mag_eps: float,
           return_linear: bool):
    """The kernel's math in plain torch on (B, T_padded)."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    need = (num_frames - 1) * hop + n_fft
    if yp.shape[-1] < need:
        yp = F.pad(yp, (0, need - yp.shape[-1]))
    frames = frame_signal(yp, n_fft, hop, num_frames)  # (B, F, n_fft)
    proj = torch.matmul(frames, device_constant(dft_basis, (n_fft, cfg.win_length), yp.device))
    re, im = proj[..., :cfg.n_freqs], proj[..., cfg.n_freqs:]
    mag = torch.sqrt(re * re + im * im + mag_eps)  # (B, F, n_freqs)
    mel = torch.matmul(mag, mel_basis(cfg, yp.device).T)
    mel = torch.log(torch.clamp(mel, min=cfg.clip_val)).transpose(1, 2).contiguous()
    lin = mag.transpose(1, 2).contiguous() if return_linear else None
    return mel, lin


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library (built on first use) with its C signatures."""
    lib = _cuda.load(KERNEL)
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    lib.fused_stft_forward.argtypes = [p, i64, i64, i64, p, p, p, p, p, p, p,
                                       i32, i32, i32, i32, f32, f32, p]
    lib.fused_stft_forward.restype = ctypes.c_int
    lib.fused_stft_error_string.argtypes = [ctypes.c_int]
    lib.fused_stft_error_string.restype = ctypes.c_char_p
    return lib


def _launch(yp: torch.Tensor, cfg: MelConfig, num_frames: int, mag_eps: float,
            return_linear: bool):
    """Launch the CUDA kernel on (B, T_padded) float32 CUDA memory."""
    if cfg.n_fft != KERNEL_N_FFT or cfg.win_length > cfg.n_fft:
        raise ValueError(f"the CUDA kernel takes n_fft={KERNEL_N_FFT}, got {cfg.n_fft}")
    B, T = yp.shape
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel's grid limit 65535")
    win, twp, tw1024, melw, span = _device_kernel_consts(cfg, yp.device)
    mel = torch.empty((B, cfg.n_mels, num_frames), dtype=torch.float32, device=yp.device)
    lin = (torch.empty((B, cfg.n_freqs, num_frames), dtype=torch.float32, device=yp.device)
           if return_linear else None)
    if B == 0:  # nothing to launch, so nothing to count
        return mel, lin
    lib = _lib()
    with torch.cuda.device(yp.device):
        rc = lib.fused_stft_forward(
            yp.data_ptr(), B, T, T, win.data_ptr(), twp.data_ptr(), tw1024.data_ptr(),
            melw.data_ptr(), span.data_ptr(), mel.data_ptr(),
            lin.data_ptr() if lin is not None else None,
            num_frames, cfg.hop_length, cfg.n_mels, melw.numel(), float(mag_eps),
            float(cfg.clip_val),
            torch.cuda.current_stream(yp.device).cuda_stream)
    if rc != 0:
        msg = lib.fused_stft_error_string(rc).decode()
        raise RuntimeError(f"fused_stft kernel launch failed: CUDA error {rc} ({msg})")
    _cuda.LAUNCHES[KERNEL] += 1
    return mel, lin


def mel_spectrogram_fused(
    y: torch.Tensor,
    cfg: MelConfig = DEFAULT_MEL,
    *,
    center=True,
    mag_eps: float = 0.0,
    return_linear: bool = False,
):
    """Fused log-mel (and optional linear) spectrogram of (T,) or (B, T).

    CUDA tensors run the hand-written kernel; CPU tensors run the plain
    version. Returns (..., n_mels, frames) [+ (..., n_freqs, frames)].
    """
    yp, num_frames = _prepare(y, cfg, center)
    if yp.device.type == "cuda":
        mel, lin = _launch(yp, cfg, num_frames, mag_eps, return_linear)
    elif yp.device.type == "cpu":
        mel, lin = _plain(yp, cfg, num_frames, mag_eps, return_linear)
    else:
        raise ValueError(f"unsupported device {yp.device}")
    return _finish(y, mel, lin, return_linear)


def mel_spectrogram_fused_reference(
    y: torch.Tensor,
    cfg: MelConfig = DEFAULT_MEL,
    *,
    center=True,
    mag_eps: float = 0.0,
    return_linear: bool = False,
):
    """The plain torch version of ``mel_spectrogram_fused`` on any device:
    the reference the kernel is held to."""
    yp, num_frames = _prepare(y, cfg, center)
    mel, lin = _plain(yp, cfg, num_frames, mag_eps, return_linear)
    return _finish(y, mel, lin, return_linear)
