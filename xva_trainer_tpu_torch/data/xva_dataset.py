"""Language ids and the pitch normalisation of the v3 model: the port's
copy of ``LANG_CODES``, ``lang_to_id`` and the xVASpeech pitch statistics of
``xva_trainer_tpu/data/xva_dataset.py``. The feature cache and the batcher
are not ported yet."""
from __future__ import annotations

import numpy as np

# f0 statistics of the xVASpeech data the base model was trained on; the
# feature cache stores (f0 - mean) / std on voiced frames and 0 elsewhere
XVASPEECH_PITCH_MEAN = 104.606
XVASPEECH_PITCH_STD = 123.4384

LANG_CODES = [
    "am", "ar", "da", "de", "el", "en", "es", "fi", "fr", "ha", "hi", "hu",
    "it", "jp", "ko", "la", "nl", "pl", "pt", "ro", "ru", "sw", "sv", "th",
    "tr", "uk", "vi", "wo", "yo", "zh", "mn",
]  # 31 languages (reference python/xvapitch/text/__init__.py:5-37)


def lang_to_id(lang: str) -> int:
    lang = (lang or "en").lower()
    return LANG_CODES.index(lang) if lang in LANG_CODES else LANG_CODES.index("en")


def normalize_pitch(f0: np.ndarray) -> np.ndarray:
    """Hz f0 (0 where unvoiced) → the cache's normalised pitch."""
    return np.where(f0 > 0, (f0 - XVASPEECH_PITCH_MEAN) / XVASPEECH_PITCH_STD,
                    0.0).astype(np.float32)
