"""xVAPitch sub-networks in PyTorch: text/posterior encoders, coupling flows,
the stochastic duration predictor (both directions), the pitch predictor and
the language classifier.

Counterparts of ``xva_trainer_tpu/models/xvapitch/modules.py``, channels-first
(B, C, T), with the reference torch parameter names. Noise that JAX draws
from its ``"noise"`` RNG stream is an optional tensor argument here (a
standard normal draw); without it the module draws from ``generator``, which
also draws the dropout masks in training mode.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...parallel import draws
from .layers import (
    ConvFlow,
    DilatedDepthSeparableConv,
    ElementwiseAffine,
    RelativePositionTransformer,
    WN,
)


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths → (B, 1, max_len) float mask."""
    ar = torch.arange(max_len, device=lengths.device)
    return (ar[None, :] < lengths[:, None]).unsqueeze(1).float()


def standard_normal(shape, like: torch.Tensor,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """N(0, 1) of ``shape`` drawn from ``generator`` on its device, returned
    on ``like``'s device and dtype. Every draw is explicit: without a
    generator (and without the noise tensor the caller could pass instead)
    this raises rather than read the global RNG."""
    if generator is None:
        raise ValueError("pass the noise tensor or a torch.Generator to draw it from")
    return draws.randn(shape, generator).to(like)


def _cond3(g: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(B, C) → (B, C, 1); (B, C, T) unchanged."""
    return g.unsqueeze(-1) if (g is not None and g.dim() == 2) else g


class TextEncoder(nn.Module):
    def __init__(self, n_vocab: int, out_channels: int = 256, hidden_channels: int = 256,
                 hidden_channels_ffn: int = 768, num_heads: int = 2, num_layers: int = 10,
                 kernel_size: int = 3, language_emb_dim: int = 12, dropout_p: float = 0.1):
        super().__init__()
        self.out_channels = out_channels
        self.hidden_channels = hidden_channels
        self.emb = nn.Embedding(n_vocab, hidden_channels)
        nn.init.normal_(self.emb.weight, 0.0, hidden_channels ** -0.5)
        h = hidden_channels + language_emb_dim
        self.encoder = RelativePositionTransformer(h, h, hidden_channels_ffn, num_heads,
                                                   num_layers, kernel_size,
                                                   dropout_p=dropout_p)
        self.proj = nn.Conv1d(h, out_channels * 2, 1)

    def forward(self, tokens, x_lengths, lang_emb, generator: Optional[torch.Generator] = None):
        """tokens (B, T) int; lang_emb (B, lang_dim).
        Returns x (B, h+lang, T), x_emb (B, h, T), x_mask (B, 1, T)."""
        x_emb = (self.emb(tokens) * math.sqrt(self.hidden_channels)).transpose(1, 2)
        lang = lang_emb[:, :, None].expand(-1, -1, tokens.shape[1])
        x = torch.cat([x_emb, lang], dim=1)
        x_mask = sequence_mask(x_lengths, tokens.shape[1])
        return self.encoder(x * x_mask, x_mask, generator), x_emb, x_mask

    def stats(self, x, x_mask):
        """Prior stats from the encoded text: (m_p, logs_p) each (B, out, T)."""
        s = self.proj(x) * x_mask
        return s[:, : self.out_channels], s[:, self.out_channels:]


class PosteriorEncoder(nn.Module):
    def __init__(self, in_channels: int = 513, out_channels: int = 256,
                 hidden_channels: int = 256, kernel_size: int = 5, dilation_rate: int = 1,
                 num_layers: int = 16, cond_channels: int = 512):
        super().__init__()
        self.out_channels = out_channels
        self.pre = nn.Conv1d(in_channels, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, num_layers, cond_channels)
        self.proj = nn.Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, y, y_lengths, g=None, *, noise=None,
                generator: Optional[torch.Generator] = None):
        """y (B, 513, T) linear spectrogram; g (B, cond).
        Returns z, m, logs (each (B, out, T)) and y_mask (B, 1, T)."""
        y_mask = sequence_mask(y_lengths, y.shape[2])
        h = self.enc(self.pre(y) * y_mask, y_mask, g=_cond3(g), generator=generator)
        stats = self.proj(h) * y_mask
        m, logs = stats[:, : self.out_channels], stats[:, self.out_channels:]
        if noise is None:
            noise = standard_normal(m.shape, m, generator)
        z = (m + noise * torch.exp(logs)) * y_mask
        return z, m, logs, y_mask


class ResidualCouplingBlock(nn.Module):
    """Mean-only affine coupling with a WN inner net (reference :1476-1544)."""

    def __init__(self, channels: int = 256, hidden_channels: int = 256, kernel_size: int = 5,
                 dilation_rate: int = 1, num_layers: int = 4, cond_channels: int = 512):
        super().__init__()
        self.half = channels // 2
        self.pre = nn.Conv1d(self.half, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, num_layers, cond_channels)
        self.post = nn.Conv1d(hidden_channels, self.half, 1)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x[:, : self.half], x[:, self.half:]
        h = self.enc(self.pre(x0) * x_mask, x_mask, g=_cond3(g))
        m = self.post(h) * x_mask
        x1 = (x1 - m) * x_mask if reverse else (m + x1) * x_mask
        return torch.cat([x0, x1], dim=1)


class ResidualCouplingBlocks(nn.Module):
    """Coupling flows with a channel flip between them (reference :1358-1421)."""

    def __init__(self, channels: int = 256, hidden_channels: int = 256, kernel_size: int = 5,
                 dilation_rate: int = 1, num_layers: int = 4, num_flows: int = 4,
                 cond_channels: int = 512):
        super().__init__()
        self.flows = nn.ModuleList(
            ResidualCouplingBlock(channels, hidden_channels, kernel_size, dilation_rate,
                                  num_layers, cond_channels)
            for _ in range(num_flows))

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        if not reverse:
            for flow in self.flows:
                x = torch.flip(flow(x, x_mask, g=g), dims=[1])
            return x
        for flow in reversed(self.flows):
            x = flow(torch.flip(x, dims=[1]), x_mask, g=g, reverse=True)
        return x


class StochasticDurationPredictor(nn.Module):
    """Spline-flow SDP (reference python/xvapitch/sdp.py:179-326):
    ``forward`` gives the training duration NLL, ``reverse`` samples
    log-durations."""

    def __init__(self, in_channels: int = 268, hidden_channels: int = 256,
                 kernel_size: int = 3, num_flows: int = 4, cond_channels: int = 512,
                 language_emb_dim: int = 12, dropout_p: float = 0.5):
        super().__init__()
        self.pre = nn.Conv1d(in_channels, hidden_channels, 1)
        self.convs = DilatedDepthSeparableConv(hidden_channels, kernel_size, 3, dropout_p)
        self.proj = nn.Conv1d(hidden_channels, hidden_channels, 1)
        self.flows = nn.ModuleList(
            [ElementwiseAffine(2)]
            + [ConvFlow(2, hidden_channels, kernel_size) for _ in range(num_flows)])
        self.post_pre = nn.Conv1d(1, hidden_channels, 1)
        self.post_convs = DilatedDepthSeparableConv(hidden_channels, kernel_size, 3, dropout_p)
        self.post_proj = nn.Conv1d(hidden_channels, hidden_channels, 1)
        self.post_flows = nn.ModuleList(
            [ElementwiseAffine(2)]
            + [ConvFlow(2, hidden_channels, kernel_size) for _ in range(num_flows)])
        if cond_channels:
            self.cond = nn.Conv1d(cond_channels, hidden_channels, 1)
        if language_emb_dim:
            self.cond_lang = nn.Conv1d(language_emb_dim, hidden_channels, 1)

    def encode_text(self, x, x_mask, g=None, lang_emb=None,
                    generator: Optional[torch.Generator] = None):
        x = self.pre(x.detach())  # detach_dp_input (reference model.py:793)
        if g is not None:
            x = x + self.cond(_cond3(g))
        if lang_emb is not None:
            x = x + self.cond_lang(_cond3(lang_emb))
        return self.proj(self.convs(x, x_mask, generator=generator)) * x_mask

    def forward(self, x, x_mask, dr, g=None, lang_emb=None, *, noise=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Duration NLL per item, (B,). x (B, in, T) text encoding (detached
        here); dr (B, 1, T) durations; ``noise`` the (B, 2, T) standard normal
        draw of the posterior, multiplied here by ``x_mask``."""
        x = self.encode_text(x, x_mask, g, lang_emb, generator)
        B, _, T = x.shape
        h = self.post_convs(self.post_pre(dr), x_mask, generator=generator)
        h = self.post_proj(h) * x_mask
        if noise is None:
            noise = standard_normal((B, 2, T), x, generator)
        noise = noise * x_mask
        z_q, logdet_tot_q = noise, 0.0
        for idx, flow in enumerate(self.post_flows):
            z_q, logdet_q = flow(z_q, x_mask, g=x + h)
            logdet_tot_q = logdet_tot_q + logdet_q
            if idx > 0:
                z_q = torch.flip(z_q, dims=[1])
        z_u, z_v = z_q[:, :1], z_q[:, 1:]
        u = torch.sigmoid(z_u) * x_mask
        z0 = (dr - u) * x_mask
        logdet_tot_q = logdet_tot_q + torch.sum(
            (F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * x_mask, dim=(1, 2))
        nll_posterior = (torch.sum(-0.5 * (math.log(2 * math.pi) + noise ** 2) * x_mask,
                                   dim=(1, 2)) - logdet_tot_q)
        z0 = torch.log(torch.clamp(z0, min=1e-5)) * x_mask
        logdet_tot = torch.sum(-z0, dim=(1, 2))
        z = torch.cat([z0, z_v], dim=1)
        for idx, flow in enumerate(self.flows):
            z, logdet = flow(z, x_mask, g=x)
            logdet_tot = logdet_tot + logdet
            if idx > 0:
                z = torch.flip(z, dims=[1])
        nll_flow = (torch.sum(0.5 * (math.log(2 * math.pi) + z ** 2) * x_mask, dim=(1, 2))
                    - logdet_tot)
        return nll_flow + nll_posterior

    def reverse(self, x, x_mask, g=None, lang_emb=None, noise_scale: float = 1.0, *,
                noise=None, generator: Optional[torch.Generator] = None):
        """Sample log-durations (B, 1, T). ``noise`` is the (B, 2, T) standard
        normal draw, scaled here by ``noise_scale``."""
        x = self.encode_text(x, x_mask, g, lang_emb)
        B, _, T = x.shape
        flows = list(reversed(self.flows))
        flows = flows[:-2] + [flows[-1]]  # drop the unused flow (reference :322)
        if noise is None:
            noise = standard_normal((B, 2, T), x, generator)
        z = noise * noise_scale
        for flow in flows:
            z = flow(torch.flip(z, dims=[1]), x_mask, g=x, reverse=True)
        return z[:, :1]


class RelativePositioningPitchEnergyEncoder(nn.Module):
    """Per-token pitch predictor: rel-pos transformer over the text encoding
    concatenated with the speaker embedding, one output channel (reference
    model.py:1268-1355)."""

    def __init__(self, hidden_channels: int = 268, hidden_channels_ffn: int = 768,
                 num_heads: int = 2, num_layers: int = 3, kernel_size: int = 3,
                 conditioning_emb_dim: int = 512, dropout_p: float = 0.1):
        super().__init__()
        h = hidden_channels + conditioning_emb_dim
        self.encoder = RelativePositionTransformer(1, h, hidden_channels_ffn, num_heads,
                                                   num_layers, kernel_size,
                                                   dropout_p=dropout_p)

    def forward(self, x, x_lengths, speaker_emb=None,
                generator: Optional[torch.Generator] = None):
        # x (B, hidden, T); speaker_emb (B, cond)
        if speaker_emb is not None:
            x = torch.cat([x, speaker_emb[:, :, None].expand(-1, -1, x.shape[2])], dim=1)
        x_mask = sequence_mask(x_lengths, x.shape[2])
        return self.encoder(x * x_mask, x_mask, generator)


class GradientReversal(torch.autograd.Function):
    """Identity forward; the backward negates the gradient and clips it to
    [-clamp, clamp] (the JAX package's ``gradient_reversal``)."""

    @staticmethod
    def forward(ctx, x, clamp: float = 0.25):
        ctx.clamp = clamp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return -torch.clamp(grad, -ctx.clamp, ctx.clamp), None


def gradient_reversal(x: torch.Tensor, clamp: float = 0.25) -> torch.Tensor:
    return GradientReversal.apply(x, clamp)


class ReversalClassifier(nn.Module):
    """Language classifier over z_p frames (reference model.py:1045-1085):
    hidden linear → language logits. As in the reference, whose forward has
    the reversal commented out (model.py:1068), ``forward`` does NOT apply
    ``gradient_reversal``: the encoder trains toward language
    predictability."""

    def __init__(self, input_dim: int = 256, hidden_dim: int = 256, output_dim: int = 31):
        super().__init__()
        self._classifier = nn.Sequential(nn.Linear(input_dim, hidden_dim),
                                         nn.Linear(hidden_dim, output_dim))

    def forward(self, x):
        """x (B, T, input_dim) → (B, T, output_dim)."""
        return self._classifier(x)
