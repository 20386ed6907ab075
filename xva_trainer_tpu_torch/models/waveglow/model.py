"""WaveGlow, the flow vocoder of the legacy v2 inference path, in PyTorch.

Counterpart of ``xva_trainer_tpu/models/waveglow/model.py`` (reference
python/fastpitch1_1/waveglow/model.py, NVIDIA's WaveGlow): the audio in
groups of 8, ``n_flows`` flows of [invertible 1×1 conv → WN affine
coupling] conditioned on the upsampled mel, ``n_early_size`` channels sent
to the output every ``n_early_every`` flows; and the denoiser's bias
removal. As in JAX, the synthesis direction (``infer``) is the one the app
would use, and ``forward`` (training) is there for completeness.

The layout is JAX's, channels-last: a mel is (B, T_mel, 80), the flows'
state (B, T / 8, channels). Three places follow flax, not torch:
- the upsampler is flax's ``ConvTranspose(kernel 1024, stride hop,
  "SAME")``: its kernel is not flipped and it pads as ``lax.conv_transpose``
  does. The port runs torch's transposed convolution with no padding on the
  kernel carried flipped (``interop/convert.py::waveglow_state_dict``) and
  keeps lax's window of T_mel · hop samples;
- the coupling's projection puts ``log_s`` in its second half and ``b`` in
  its first (NVIDIA's order, which imported checkpoints depend on);
- ``infer`` takes its noise as tensors (``noise``: the main draw, then one
  draw per early exit in the order JAX makes them) or draws it from
  ``generator``.

The coupling's WaveNet is the port's ``WN`` (``models/xvapitch/layers.py``)
with a per-frame condition and an all-ones mask, since JAX passes none.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from ...ops.griffin_lim import _stft_complex, istft
from ...ops.stft import DEFAULT_MEL
from ...parallel import draws
from ..xvapitch.layers import WN


@dataclasses.dataclass(frozen=True)
class WaveGlowConfig:
    n_mel_channels: int = 80
    n_flows: int = 12
    n_group: int = 8
    n_early_every: int = 4
    n_early_size: int = 2
    wn_layers: int = 8
    wn_channels: int = 256
    wn_kernel: int = 3
    hop_length: int = 256
    upsample_kernel: int = 1024

    def flow_sizes(self) -> List[int]:
        """Each flow's channel count, flow 0 first."""
        sizes, n = [], self.n_group
        for k in range(self.n_flows):
            if k % self.n_early_every == 0 and k > 0:
                n -= self.n_early_size
            sizes.append(n)
        return sizes


class Invertible1x1Conv(nn.Module):
    """z @ W over the channels, log|det W| per frame; W orthogonal with
    det +1 at initialisation."""

    def __init__(self, channels: int):
        super().__init__()
        w = torch.linalg.qr(torch.randn(channels, channels))[0]
        if torch.linalg.det(w) < 0:
            w[:, 0] = -w[:, 0]
        self.W = nn.Parameter(w)

    def forward(self, z, reverse: bool = False):
        if reverse:
            return z @ torch.linalg.inv(self.W)
        logdet = torch.log(torch.abs(torch.linalg.det(self.W))) * z.shape[1]
        return z @ self.W, logdet


class AffineCoupling(nn.Module):
    """z1 → exp(log_s)·z1 + b, with (log_s, b) from WN(start(z0) | cond)."""

    def __init__(self, half: int, cond_channels: int, wn_layers: int = 8,
                 wn_channels: int = 256, wn_kernel: int = 3):
        super().__init__()
        self.half = half
        self.start = nn.Linear(half, wn_channels)
        self.wn = WN(wn_channels, wn_kernel, 2, wn_layers, cond_channels=cond_channels)
        self.end = nn.Linear(wn_channels, 2 * half)
        nn.init.zeros_(self.end.weight)  # an identity at the start of training
        nn.init.zeros_(self.end.bias)

    def _ls_b(self, z0, cond):
        h = self.start(z0).transpose(1, 2)  # (B, H, T)
        ones = torch.ones_like(h[:, :1])
        out = self.end(self.wn(h, ones, g=cond).transpose(1, 2))
        return out[..., self.half:], out[..., :self.half]

    def forward(self, z, cond, reverse: bool = False):
        z0, z1 = z[..., :self.half], z[..., self.half:]
        log_s, b = self._ls_b(z0, cond)
        if reverse:
            return torch.cat([z0, (z1 - b) * torch.exp(-log_s)], dim=-1)
        return torch.cat([z0, torch.exp(log_s) * z1 + b], dim=-1), log_s.sum(dim=(1, 2))


class WaveGlow(nn.Module):
    def __init__(self, cfg: WaveGlowConfig = WaveGlowConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.upsample = nn.ConvTranspose1d(c.n_mel_channels, c.n_mel_channels,
                                           c.upsample_kernel, stride=c.hop_length)
        sizes = c.flow_sizes()
        self.convs = nn.ModuleList(Invertible1x1Conv(n) for n in sizes)
        self.couplings = nn.ModuleList(
            AffineCoupling(n // 2, c.n_mel_channels * c.n_group, c.wn_layers, c.wn_channels,
                           c.wn_kernel) for n in sizes)

    def _cond(self, mel, t_groups: int) -> torch.Tensor:
        """mel (B, T_mel, 80) → the condition (B, 80·n_group, t_groups),
        channels-first for the WN."""
        c = self.cfg
        k, s = c.upsample_kernel, c.hop_length
        pad_len = k + s - 2  # lax.conv_transpose's "SAME"
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
        up = self.upsample(mel.transpose(1, 2))  # (B, 80, (T_mel - 1)·s + k)
        start = k - 1 - pad_a
        up = up[:, :, start:start + mel.shape[1] * s][:, :, :t_groups * c.n_group]
        B = up.shape[0]
        up = up.transpose(1, 2).reshape(B, t_groups, c.n_group * c.n_mel_channels)
        return up.transpose(1, 2)

    def forward(self, audio, mel):
        """Training direction: audio (B, T, 1) → (z (B, T/8, n_group),
        logdet (B,))."""
        c = self.cfg
        B, T, _ = audio.shape
        tg = T // c.n_group
        z = audio[:, :tg * c.n_group, 0].reshape(B, tg, c.n_group)
        cond = self._cond(mel, tg)
        out_z = []
        logdet = torch.zeros(B, device=audio.device, dtype=audio.dtype)
        for k in range(c.n_flows):
            if k % c.n_early_every == 0 and k > 0:
                out_z.append(z[..., :c.n_early_size])
                z = z[..., c.n_early_size:]
            z, ld1 = self.convs[k](z)
            z, ld2 = self.couplings[k](z, cond)
            logdet = logdet + ld1 + ld2
        out_z.append(z)
        return torch.cat(out_z, dim=-1), logdet

    def infer(self, mel, sigma: float = 1.0, generator: Optional[torch.Generator] = None,
              noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """mel (B, T_mel, 80) → audio (B, T_mel · hop). The noise is
        ``noise`` (the (B, T/8, last flow's channels) draw, then each early
        exit's (B, T/8, n_early_size), last flow first) or comes from
        ``generator``; either is scaled by ``sigma``."""
        c = self.cfg
        B, t_mel, _ = mel.shape
        tg = t_mel * c.hop_length // c.n_group
        cond = self._cond(mel, tg)
        given = list(noise) if noise is not None else None

        def normal(shape):
            if given is not None:
                return given.pop(0).to(mel)
            if generator is None:
                raise ValueError("pass the noise tensors or a torch.Generator to draw them from")
            return draws.randn(shape, generator).to(mel)

        z = normal((B, tg, c.flow_sizes()[-1])) * sigma
        for k in reversed(range(c.n_flows)):
            z = self.couplings[k](z, cond, reverse=True)
            z = self.convs[k](z, reverse=True)
            if k % c.n_early_every == 0 and k > 0:
                z = torch.cat([normal((B, tg, c.n_early_size)) * sigma, z], dim=-1)
        return z.reshape(B, tg * c.n_group)


class WaveGlowDenoiser:
    """Removes WaveGlow's model bias from synthesized audio (reference
    fastpitch1_1/waveglow/denoiser.py:32-61): the vocoder's output for a
    zero mel at sigma 0, the magnitude of its first STFT frame as the bias
    spectrum, then ``strength`` times it subtracted from any clip's
    magnitude, the phase kept."""

    @torch.no_grad()
    def __init__(self, model: WaveGlow, n_mel: int = 80, frames: int = 88):
        dev = next(model.parameters()).device
        mel = torch.zeros((1, frames, n_mel), device=dev)
        shapes = [model.cfg.flow_sizes()[-1]] + [model.cfg.n_early_size] * (
            (model.cfg.n_flows - 1) // model.cfg.n_early_every)
        tg = frames * model.cfg.hop_length // model.cfg.n_group
        bias = model.infer(mel, 0.0, noise=[torch.zeros((1, tg, n), device=dev) for n in shapes])
        self.bias_spec = torch.abs(_stft_complex(bias[0], DEFAULT_MEL)[:, :1])

    @torch.no_grad()
    def __call__(self, audio: torch.Tensor, strength: float = 0.1) -> torch.Tensor:
        spec = _stft_complex(audio, DEFAULT_MEL)
        mag = torch.clamp(torch.abs(spec) - self.bias_spec * strength, min=0.0)
        phase = spec / torch.clamp(torch.abs(spec), min=1e-8)
        return istft(mag * phase, DEFAULT_MEL)[: audio.shape[-1]]
