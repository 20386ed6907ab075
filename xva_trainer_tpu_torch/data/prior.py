"""Beta-binomial alignment prior on the host (reference data_function.py:60-95).

The port's copy of ``xva_trainer_tpu/data/prior.py``: prior[t_mel, t_text]
= BetaBinom(P, i, M+1-i).pmf per mel frame i, cached at rounded sizes and
bilinearly zoomed to the exact (mel_len, text_len). The batcher collates it
only when the step does not compute the prior on the device
(``ops/attn_prior.py``).
"""
from __future__ import annotations

import functools

import numpy as np
from scipy import ndimage
from scipy.stats import betabinom


@functools.lru_cache(maxsize=256)
def beta_binomial_prior(phoneme_count: int, mel_count: int, scaling: float = 1.0) -> np.ndarray:
    """(mel_count, phoneme_count) prior matrix."""
    P, M = phoneme_count, mel_count
    x = np.arange(P)
    rows = []
    for i in range(1, M + 1):
        a, b = scaling * i, scaling * (M + 1 - i)
        rows.append(betabinom(P, a, b).pmf(x))
    return np.asarray(rows, dtype=np.float32)


class BetaBinomialInterpolator:
    """Cache priors at rounded sizes, zoom to the exact size (reference :60-81)."""

    def __init__(self, round_mel_len_to: int = 100, round_text_len_to: int = 20):
        self.round_mel_len_to = round_mel_len_to
        self.round_text_len_to = round_text_len_to

    @staticmethod
    def _round(val: int, to: int) -> int:
        return max(1, int(np.round((val + 1) / to))) * to

    def __call__(self, mel_len: int, text_len: int) -> np.ndarray:
        bw = self._round(mel_len, self.round_mel_len_to)
        bh = self._round(text_len, self.round_text_len_to)
        base = beta_binomial_prior(bh, bw)  # (bw, bh)
        ret = ndimage.zoom(base, zoom=(mel_len / bw, text_len / bh), order=1)
        assert ret.shape == (mel_len, text_len)
        return ret.astype(np.float32)
