"""Mel filterbank construction, numerically matching librosa.filters.mel.

Numpy copy of ``xva_trainer_tpu/ops/mel.py`` (Slaney-scale, Slaney-normed
triangular filters; the reference builds its basis with
``librosa_mel_fn(22050, 1024, 80, 0.0, 8000.0)``). Host-side, run once per
config; the matrix is a constant of the spectrogram ops and the CUDA kernel.
"""
from __future__ import annotations

import functools

import numpy as np

# Slaney mel scale constants (librosa hz_to_mel/mel_to_hz with htk=False).
_F_SP = 200.0 / 3.0          # linear region: mels per Hz below 1 kHz
_MIN_LOG_HZ = 1000.0         # beginning of log region
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0  # step size for log region


def hz_to_mel(frequencies: np.ndarray) -> np.ndarray:
    """Slaney-scale Hz→mel (librosa.hz_to_mel, htk=False)."""
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    mels = frequencies / _F_SP
    log_t = frequencies >= _MIN_LOG_HZ
    return np.where(
        log_t,
        _MIN_LOG_MEL + np.log(np.maximum(frequencies, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    """Slaney-scale mel→Hz (librosa.mel_to_hz, htk=False)."""
    mels = np.asanyarray(mels, dtype=np.float64)
    freqs = _F_SP * mels
    log_t = mels >= _MIN_LOG_MEL
    return np.where(log_t, _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)), freqs)


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asanyarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asanyarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    sample_rate: int = 22050,
    n_fft: int = 1024,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: float = 8000.0,
    dtype=np.float32,
    htk: bool = False,
    norm: str = "slaney",
) -> np.ndarray:
    """Triangular mel filterbank, shape (n_mels, n_fft//2+1).

    Defaults match ``librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax)``
    (htk=False, norm='slaney'); htk=True, norm=None matches torchaudio's
    MelSpectrogram.
    """
    if fmax is None:
        fmax = float(sample_rate) / 2

    n_freqs = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, float(sample_rate) / 2, n_freqs, dtype=np.float64)

    to_mel = hz_to_mel_htk if htk else hz_to_mel
    to_hz = mel_to_hz_htk if htk else mel_to_hz
    # n_mels + 2 band edges, uniformly spaced on the mel scale.
    mel_edges = np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2)
    hz_edges = to_hz(mel_edges)

    fdiff = np.diff(hz_edges)
    ramps = hz_edges[:, None] - fftfreqs[None, :]  # (n_mels+2, n_freqs)

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        # Slaney-style energy normalization: filters integrate to ~constant.
        enorm = 2.0 / (hz_edges[2 : n_mels + 2] - hz_edges[:n_mels])
        weights *= enorm[:, None]

    return weights.astype(dtype)


def inverse_mel_filterbank(**kwargs) -> np.ndarray:
    """Pseudo-inverse of the mel basis (for mel → linear, Griffin-Lim)."""
    basis = mel_filterbank(**kwargs)
    return np.linalg.pinv(basis.astype(np.float64)).astype(basis.dtype)
