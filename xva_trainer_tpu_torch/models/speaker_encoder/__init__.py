from .model import ResNetSpeakerEncoder, SpeakerEncoder, spk_mel_spectrogram

__all__ = ["ResNetSpeakerEncoder", "SpeakerEncoder", "spk_mel_spectrogram"]
