"""ResNet34-SE "H/ASP" speaker encoder (arXiv 2009.14153) in PyTorch.

Counterpart of ``xva_trainer_tpu/models/speaker_encoder/model.py``, with the
reference's module and key names (python/xvapitch/speaker_representation/
main.py:65-261): pre-emphasis 0.97 → 16 kHz power mel (n_fft 512, a 400-
sample Hamming window, hop 160, 64 HTK mels without norm) → log(x + 1e-6) →
instance norm over time (population variance) → SE-ResNet34 [3,4,6,3] ×
[32,64,128,256] with the reference's conv→relu→bn order → attentive
statistics pooling → 512-d embedding. ``SpeakerEncoder.compute_embedding``
is the mean of 10 crop embeddings, L2-normalised (:226-261);
``SpeakerEncoder.embed`` embeds a batch of crops.

Inference only: every BatchNorm uses its running statistics. The spectrogram
is ``torch.fft.rfft`` and a product, as the JAX package's is ``jnp.fft``: no
hand kernel stands behind either.
"""
from __future__ import annotations

import functools
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ... import resolve_device
from ...ops.mel import mel_filterbank
from ...ops.stft import device_constant, frame_signal

SAMPLE_RATE = 16000
N_FFT = 512
WIN = 400
HOP = 160
N_MELS = 64
EMB_DIM = 512
LAYERS = (3, 4, 6, 3)
FILTERS = (32, 64, 128, 256)


@functools.lru_cache(maxsize=None)
def hamming_window(win: int = WIN, n_fft: int = N_FFT) -> np.ndarray:
    """Periodic Hamming window (torch's default), zero-padded to n_fft
    around its centre."""
    n = np.arange(win)
    w = 0.54 - 0.46 * np.cos(2 * np.pi * n / win)
    pad = (n_fft - win) // 2
    return np.pad(w, (pad, n_fft - win - pad)).astype(np.float32)


def _spk_mel_basis() -> np.ndarray:
    return mel_filterbank(SAMPLE_RATE, N_FFT, N_MELS, 0.0, SAMPLE_RATE / 2, htk=True, norm=None)


def spk_mel_spectrogram(y: torch.Tensor) -> torch.Tensor:
    """(B, T) 16 kHz wave → (B, 64, frames) power mel (torchaudio semantics:
    centred reflect padding, power 2, HTK mel, no norm)."""
    y = y.float()
    # pre-emphasis with a 1-sample reflect pad (reference PreEmphasis :7-17)
    y = torch.cat([y[:, 1:2], y], dim=1)
    y = y[:, 1:] - 0.97 * y[:, :-1]
    num_frames = 1 + y.shape[-1] // HOP
    y = F.pad(y[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    # HOP does not divide N_FFT (512 / 160): the last frame needs
    # (num_frames - 1) * HOP + N_FFT samples, which may be past the padding
    need = (num_frames - 1) * HOP + N_FFT
    if y.shape[-1] < need:
        y = F.pad(y, (0, need - y.shape[-1]))
    frames = frame_signal(y, N_FFT, HOP, num_frames)
    spec = torch.fft.rfft(frames * device_constant(hamming_window, (), y.device), n=N_FFT)
    power = spec.real ** 2 + spec.imag ** 2  # (B, frames, 257)
    fb = device_constant(_spk_mel_basis, (), y.device)
    return torch.einsum("mf,btf->bmt", fb, power)


class SELayer(nn.Module):
    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(channels, channels // reduction), nn.ReLU(),
                                nn.Linear(channels // reduction, channels), nn.Sigmoid())

    def forward(self, x):
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class SEBasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.se = SELayer(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False),
                nn.BatchNorm2d(planes))

    def forward(self, x):
        out = self.bn1(F.relu(self.conv1(x)))  # the reference's conv → relu → bn
        out = self.se(self.bn2(self.conv2(out)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNetSpeakerEncoder(nn.Module):
    """wav (B, T) at 16 kHz → (B, 512). Always in eval mode."""

    def __init__(self, layers=LAYERS, num_filters=FILTERS, proj_dim: int = EMB_DIM):
        super().__init__()
        self.conv1 = nn.Conv2d(1, num_filters[0], 3, padding=1)
        self.bn1 = nn.BatchNorm2d(num_filters[0])
        inplanes = num_filters[0]
        for i, (nf, nl) in enumerate(zip(num_filters, layers)):
            blocks = []
            for j in range(nl):
                blocks.append(SEBasicBlock(inplanes, nf, 2 if (i > 0 and j == 0) else 1))
                inplanes = nf
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.n_layers = len(layers)
        out_dim = num_filters[-1] * (N_MELS // 2 ** (len(layers) - 1))
        self.attention = nn.Sequential(
            nn.Conv1d(out_dim, 128, 1), nn.ReLU(), nn.BatchNorm1d(128),
            nn.Conv1d(128, out_dim, 1), nn.Softmax(dim=2))
        self.fc = nn.Linear(out_dim * 2, proj_dim)
        self.eval()

    def forward(self, wav: torch.Tensor, l2_norm: bool = False,
                spectrogram: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Pass ``spectrogram`` (B, 64, T') to skip the mel front end
        (reference ``use_torch_spec=False``)."""
        x = spk_mel_spectrogram(wav) if spectrogram is None else spectrogram
        x = torch.log(x + 1e-6)
        # instance norm over time per mel channel, without affine, with the
        # population variance (jnp.var; torch.var is unbiased by default)
        x = (x - x.mean(dim=2, keepdim=True)) / torch.sqrt(
            x.var(dim=2, keepdim=True, unbiased=False) + 1e-5)
        x = self.bn1(F.relu(self.conv1(x[:, None])))
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i + 1}")(x)
        # (B, C, H, T) → (B, C·H, T): channel-major, index c·H + h (main.py:204)
        x = x.reshape(x.shape[0], -1, x.shape[-1])
        w = self.attention(x)
        mu = torch.sum(x * w, dim=2)
        sg = torch.sqrt(torch.clamp(torch.sum(x * x * w, dim=2) - mu * mu, min=1e-5))
        emb = self.fc(torch.cat([mu, sg], dim=1))
        if l2_norm:
            emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True), min=1e-8)
        return emb


def load_speaker_rep(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a reference ``speaker_rep.pt`` (``{"model": sd}`` or
    the bare sd), without the reference's front-end buffers (``torch_spec.*``:
    its window and mel basis, which ``spk_mel_spectrogram`` computes)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    return {k: v for k, v in sd.items() if not k.startswith("torch_spec.")}


class SpeakerEncoder:
    """Host-facing wrapper: weights, device, and the 10-crop embedding.

    The weights are ``state_dict`` when given (loaded strictly), else the
    reference ``speaker_rep.pt`` at ``weights_path`` or ``$XVA_SPEAKER_REP``,
    else the module's own initialisation under ``torch.manual_seed(seed)``
    (in a forked RNG, so the caller's global state is untouched)."""

    def __init__(self, state_dict: Optional[Dict[str, torch.Tensor]] = None, seed: int = 0,
                 weights_path: Optional[str] = None, device="cuda"):
        self.device = resolve_device(device)
        weights_path = weights_path or os.environ.get("XVA_SPEAKER_REP")
        if state_dict is None and weights_path and os.path.exists(weights_path):
            state_dict = load_speaker_rep(weights_path)
        self.pretrained = state_dict is not None
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = ResNetSpeakerEncoder()
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device)

    @torch.no_grad()
    def compute_embedding(self, wav16k: np.ndarray, num_frames: int = 250,
                          num_eval: int = 10) -> np.ndarray:
        """(T,) 16 kHz wave → (512,) mean of the L2-normalised embeddings of
        ``num_eval`` evenly spaced crops of ``num_frames`` frames (one batch
        on the device), L2-normalised."""
        n = num_frames * HOP
        if len(wav16k) < n:
            wav16k = np.pad(wav16k, (0, n - len(wav16k)))
        offsets = np.linspace(0, len(wav16k) - n, num=num_eval).astype(int)
        emb = self.embed(np.stack([wav16k[o: o + n] for o in offsets])).mean(axis=0)
        return emb / max(np.linalg.norm(emb), 1e-8)

    @torch.no_grad()
    def embed(self, crops: np.ndarray) -> np.ndarray:
        """(B, T) 16 kHz crops → (B, 512) L2-normalised embeddings, one
        batch on the device: the counterpart of the JAX wrapper's jitted
        ``_embed``, which diarization calls on its windows' crops."""
        x = torch.from_numpy(np.ascontiguousarray(crops, np.float32)).to(self.device)
        return self.model(x, l2_norm=True).float().cpu().numpy()
