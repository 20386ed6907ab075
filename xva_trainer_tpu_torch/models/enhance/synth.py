"""Synthetic noisy-speech pairs for enhancer training and evaluation.

The port's copy of ``xva_trainer_tpu/models/enhance/synth.py`` (numpy
only), the generator of the pairs the shipped ``assets/enhancer_default.npz``
was trained on and is held to.
"""
from __future__ import annotations

import numpy as np

SR = 22050


def synth_speech(seconds: float, rng: np.random.Generator) -> np.ndarray:
    """Speech-like signal: voiced harmonic segments with pitch contours,
    formant-ish filtering, amplitude envelopes, and pauses."""
    y = np.zeros(int(SR * seconds), np.float32)
    t_cur = 0.0
    while t_cur < seconds - 0.3:
        dur = rng.uniform(0.15, 0.5)
        n = int(SR * dur)
        t = np.arange(n) / SR
        f0 = rng.uniform(90, 300)
        contour = f0 * (1 + 0.1 * np.sin(2 * np.pi * rng.uniform(1, 4) * t)
                        + rng.uniform(-0.05, 0.05))
        phase = 2 * np.pi * np.cumsum(contour) / SR
        seg = np.zeros(n)
        for h in range(1, 12):
            seg += rng.uniform(0.2, 1.0) / h * np.sin(h * phase)
        fc = rng.uniform(300, 3000)
        k = np.arange(-32, 33)
        fir = np.sinc(k * 2 * fc / SR) * np.hanning(65)
        seg = np.convolve(seg, fir / (np.abs(fir).sum() + 1e-9), mode="same")
        env = np.minimum(1.0, 10 * t) * np.minimum(1.0, 10 * (dur - t))
        seg = seg * env * rng.uniform(0.3, 0.8)
        a = int(t_cur * SR)
        m = min(n, len(y) - a)  # clip the final segment at the buffer end
        y[a:a + m] += seg[:m].astype(np.float32)
        t_cur += dur + (rng.uniform(0.05, 0.4) if rng.random() < 0.5 else 0.0)
    peak = np.abs(y).max() + 1e-9
    return (0.5 * y / peak).astype(np.float32)


def synth_noise(n: int, rng: np.random.Generator) -> np.ndarray:
    """Mixture of white + pink + mains hum, random levels."""
    white = rng.standard_normal(n)
    pink = np.cumsum(rng.standard_normal(n))
    pink = pink - np.convolve(pink, np.ones(512) / 512, mode="same")
    pink /= np.abs(pink).std() + 1e-9
    t = np.arange(n) / SR
    hum = np.sin(2 * np.pi * 50 * t) + 0.5 * np.sin(2 * np.pi * 150 * t)
    mix = (rng.uniform(0, 1) * white + rng.uniform(0, 1.5) * pink
           + rng.uniform(0, 0.8) * hum)
    return (mix / (np.abs(mix).std() + 1e-9)).astype(np.float32)


def make_pair(seconds: float, snr_db: float, rng) -> tuple:
    """(noisy, clean) at the requested SNR."""
    clean = synth_speech(seconds, rng)
    noise = synth_noise(len(clean), rng)
    sp = np.sqrt((clean ** 2).mean() + 1e-12)
    npow = np.sqrt((noise ** 2).mean() + 1e-12)
    noise = noise * (sp / npow) * (10 ** (-snr_db / 20))
    return (clean + noise).astype(np.float32), clean
