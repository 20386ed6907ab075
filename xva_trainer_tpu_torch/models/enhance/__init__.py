from .model import (
    ComplexMaskNet,
    EnhanceConfig,
    SpeechEnhancer,
    load_params_npz,
    si_sdr,
    train_enhancer,
)

__all__ = ["ComplexMaskNet", "EnhanceConfig", "SpeechEnhancer", "load_params_npz", "si_sdr",
           "train_enhancer"]
