from .model import Wav2Vec2Config, Wav2Vec2CTC, Wav2Vec2Model, ctc_greedy_decode

__all__ = ["Wav2Vec2Config", "Wav2Vec2CTC", "Wav2Vec2Model", "ctc_greedy_decode"]
