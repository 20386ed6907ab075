"""FastPitch 1.1 (the v2 acoustic model) in PyTorch."""
from .model import FastPitch, FastPitchConfig, average_pitch, regulate_len

__all__ = ["FastPitch", "FastPitchConfig", "average_pitch", "regulate_len"]
