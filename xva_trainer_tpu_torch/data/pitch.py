"""Pitch constants of the f0 estimator and the v2 cache's pitch
normalisation (copies of the ones in ``xva_trainer_tpu/data/pitch.py``:
librosa.pyin's C2..C7 range; the port's f0 estimator is ``ops/yin.py``)."""
from __future__ import annotations

import numpy as np

FMIN = 65.40639  # C2
FMAX = 2093.0045  # C7


def normalize_pitch(pitch: np.ndarray, mean: float, std: float) -> np.ndarray:
    """(p - mean)/std with unvoiced zeros preserved (reference :165-170)."""
    out = (pitch - mean) / max(std, 1e-8)
    out[pitch == 0.0] = 0.0
    return out.astype(np.float32)
