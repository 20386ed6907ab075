from .model import (
    SpecialTokens,
    Whisper,
    WhisperASR,
    WhisperConfig,
    WHISPER_SIZES,
    log_mel_spectrogram,
)
from .tokenizer import BpeDecoder

__all__ = [
    "SpecialTokens", "Whisper", "WhisperASR", "WhisperConfig",
    "WHISPER_SIZES", "log_mel_spectrogram", "BpeDecoder",
]
