"""Host-side wav I/O and resampling (numpy and scipy).

The port's copy of ``xva_trainer_tpu/data/audio_io.py``. The JAX package
decodes with its ``native/`` C++ library when that is built; the port has
only scipy's decoder, which gives the same samples for 8/16/32-bit PCM and
float wavs.
"""
from __future__ import annotations

import math
import os
import wave
from typing import Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

TARGET_SR = 22050


def load_wav(path: str, target_sr: int | None = None, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Read a wav → float32 in [-1, 1]; optional mono mixdown and resample."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        y = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        y = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        y = (data.astype(np.float32) - 128.0) / 128.0
    else:
        y = data.astype(np.float32)
    if mono and y.ndim > 1:
        y = y.mean(axis=1)
    if target_sr is not None and sr != target_sr:
        y = resample(y, sr, target_sr)
        sr = target_sr
    return np.clip(y, -1.0, 1.0), sr


def wav_duration(path: str) -> float:
    """Clip length in seconds from the wav header (no sample decode)."""
    try:
        with wave.open(path, "rb") as w:
            return w.getnframes() / max(w.getframerate(), 1)
    except (wave.Error, EOFError):  # e.g. a float wav, which ``wave`` cannot read
        y, sr = load_wav(path)
        return len(y) / sr


def save_wav(path: str, y: np.ndarray, sr: int = TARGET_SR) -> None:
    """Write float [-1, 1] → 16-bit PCM wav."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    pcm = (np.clip(y, -1.0, 1.0) * 32767.0).astype(np.int16)
    wavfile.write(path, sr, pcm)


def resample(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling."""
    if orig_sr == target_sr:
        return y
    g = math.gcd(int(orig_sr), int(target_sr))
    return resample_poly(y, target_sr // g, orig_sr // g).astype(np.float32)


def trim_silence_db(y: np.ndarray, top_db: float = 45.0, frame: int = 2048,
                    hop: int = 512) -> np.ndarray:
    """Trim leading and trailing frames whose RMS is below (max - top_db) dB
    (librosa.effects.trim with trim_db=45, as the reference configures it)."""
    if len(y) < frame:
        return y
    n = 1 + (len(y) - frame) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(frame)[None, :]
    rms = np.sqrt((y[idx] ** 2).mean(axis=1) + 1e-12)
    db = 20.0 * np.log10(rms + 1e-12)
    keep = np.where(db > db.max() - top_db)[0]
    if len(keep) == 0:
        return y
    start = keep[0] * hop
    end = min(len(y), keep[-1] * hop + frame)
    return y[start:end]
