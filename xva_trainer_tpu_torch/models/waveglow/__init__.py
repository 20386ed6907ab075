from .model import WaveGlow, WaveGlowConfig, WaveGlowDenoiser
