"""xVAPitch (VITS-family) building blocks in PyTorch.

Counterparts of ``xva_trainer_tpu/models/xvapitch/layers.py``. Tensors are
channels-first (B, C, T) and parameters carry the reference torch names
(reference python/xvapitch/glow_tts.py, wavenet.py, sdp.py), so the same
state dict loads with ``strict=True``:

- RelativePositionMultiHeadAttention / FeedForwardNetwork /
  RelativePositionTransformer: window-4 relative attention, conv FFN masked
  before each conv, post-LayerNorm with eps 1e-4;
- WN: gated dilated conv stack with global conditioning and weight norm;
- DilatedDepthSeparableConv (LayerNorm eps 1e-5, exact-erf GELU),
  ElementwiseAffine and ConvFlow (rational-quadratic spline coupling).

Dropout sits where the JAX layers have it (attention probabilities, the FFN's
hidden layer, both residual branches of the transformer, WN's input convs,
each DDSConv step). It is active only in training mode, and its mask is
drawn from the ``generator`` passed down the forward call: nothing reads the
global RNG.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.spline import rational_quadratic_spline
from ...parallel import draws
from ..conv import same_conv1d, weight_norm


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1-p and scale by 1/(1-p),
    in training mode only. The mask is drawn from ``generator`` on its device;
    without a generator a training-mode dropout raises."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator to draw its mask")
    keep = draws.rand(x.shape, generator).to(x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


class LayerNorm(nn.Module):
    """LayerNorm over the channel axis of (B, C, T) (reference ``gamma`` and
    ``beta`` parameter names)."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        x = F.layer_norm(x.transpose(1, -1), (x.shape[1],), self.gamma, self.beta, self.eps)
        return x.transpose(1, -1)


def _expand_relative_embeddings(emb: torch.Tensor, length: int, window: int) -> torch.Tensor:
    """(1, 2w+1, k) → (1, 2*length-1, k): zero-pad or center-slice."""
    pad = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    out = F.pad(emb, (0, 0, pad, pad))
    return out[:, start: start + 2 * length - 1]


def _relative_to_absolute(x: torch.Tensor) -> torch.Tensor:
    """(B,H,T,2T-1) relative logits → (B,H,T,T) absolute."""
    B, H, T, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(B, H, T * 2 * T)
    x = F.pad(x, (0, T - 1)).reshape(B, H, T + 1, 2 * T - 1)
    return x[:, :, :T, T - 1:]


def _absolute_to_relative(x: torch.Tensor) -> torch.Tensor:
    """(B,H,T,T) → (B,H,T,2T-1)."""
    B, H, T, _ = x.shape
    x = F.pad(x, (0, T - 1)).reshape(B, H, T * (2 * T - 1))
    x = F.pad(x, (T, 0)).reshape(B, H, T, 2 * T)
    return x[:, :, :, 1:]


class RelativePositionMultiHeadAttention(nn.Module):
    """Multi-head self-attention with windowed relative position embeddings
    (reference glow_tts.py:59-310, window 4)."""

    def __init__(self, channels: int, out_channels: int, num_heads: int,
                 window_size: int = 4, dropout_p: float = 0.0):
        super().__init__()
        self.dropout_p = dropout_p
        self.num_heads = num_heads
        self.window_size = window_size
        self.k_channels = channels // num_heads
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        self.conv_o = nn.Conv1d(channels, out_channels, 1)
        std = self.k_channels ** -0.5
        self.emb_rel_k = nn.Parameter(torch.randn(1, 2 * window_size + 1, self.k_channels) * std)
        self.emb_rel_v = nn.Parameter(torch.randn(1, 2 * window_size + 1, self.k_channels) * std)

    def forward(self, x, attn_mask, generator: Optional[torch.Generator] = None):
        # x (B, C, T); attn_mask (B, 1, T, T)
        B, C, T = x.shape
        H, kc = self.num_heads, self.k_channels

        def heads(t):
            return t.view(B, H, kc, T).transpose(2, 3)  # (B, H, T, kc)

        q = heads(self.conv_q(x)) * (1.0 / math.sqrt(kc))
        k, v = heads(self.conv_k(x)), heads(self.conv_v(x))
        scores = torch.matmul(q, k.transpose(-1, -2))
        rel_k = _expand_relative_embeddings(self.emb_rel_k, T, self.window_size)
        scores = scores + _relative_to_absolute(torch.matmul(q, rel_k[0].T))
        scores = scores.masked_fill(attn_mask <= 0, -1e4)
        p = dropout(torch.softmax(scores, dim=-1), self.dropout_p, self.training, generator)
        out = torch.matmul(p, v)
        rel_v = _expand_relative_embeddings(self.emb_rel_v, T, self.window_size)
        out = out + torch.matmul(_absolute_to_relative(p), rel_v[0])
        return self.conv_o(out.transpose(2, 3).reshape(B, C, T))


class FeedForwardNetwork(nn.Module):
    """conv(k) → relu → dropout → conv(k), masked before each conv and after."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int,
                 kernel_size: int = 3, dropout_p: float = 0.0):
        super().__init__()
        self.dropout_p = dropout_p
        self.pad = ((kernel_size - 1) // 2, kernel_size - 1 - (kernel_size - 1) // 2)
        self.conv_1 = nn.Conv1d(in_channels, hidden_channels, kernel_size)
        self.conv_2 = nn.Conv1d(hidden_channels, out_channels, kernel_size)

    def forward(self, x, x_mask, generator: Optional[torch.Generator] = None):
        h = torch.relu(self.conv_1(F.pad(x * x_mask, self.pad)))
        h = dropout(h, self.dropout_p, self.training, generator)
        return self.conv_2(F.pad(h * x_mask, self.pad)) * x_mask


class RelativePositionTransformer(nn.Module):
    """Rel-pos attention + conv FFN stack with post-LN (reference
    glow_tts.py:373-465). When ``out_channels == 1`` the last layer's output
    is ``proj(x)``: its FFN result and ``norm_layers_2`` entry are unused
    (kept for checkpoint parity)."""

    def __init__(self, out_channels: int, hidden_channels: int, hidden_channels_ffn: int,
                 num_heads: int, num_layers: int, kernel_size: int = 3,
                 window_size: int = 4, dropout_p: float = 0.0):
        super().__init__()
        self.dropout_p = dropout_p
        self.out_channels = out_channels
        self.hidden_channels = hidden_channels
        self.num_layers = num_layers
        self.attn_layers = nn.ModuleList()
        self.norm_layers_1 = nn.ModuleList()
        self.ffn_layers = nn.ModuleList()
        self.norm_layers_2 = nn.ModuleList()
        for i in range(num_layers):
            last = i + 1 == num_layers
            ffn_out = out_channels if last else hidden_channels
            self.attn_layers.append(RelativePositionMultiHeadAttention(
                hidden_channels, hidden_channels, num_heads, window_size, dropout_p))
            self.norm_layers_1.append(LayerNorm(hidden_channels, 1e-4))
            self.ffn_layers.append(FeedForwardNetwork(
                hidden_channels, ffn_out, hidden_channels_ffn, kernel_size, dropout_p))
            self.norm_layers_2.append(LayerNorm(ffn_out, 1e-4))
        if hidden_channels != out_channels:
            self.proj = nn.Conv1d(hidden_channels, out_channels, 1)

    def forward(self, x, x_mask, generator: Optional[torch.Generator] = None):
        # x (B, C, T); x_mask (B, 1, T)
        attn_mask = x_mask.unsqueeze(2) * x_mask.unsqueeze(-1)  # (B, 1, T, T)
        p, training = self.dropout_p, self.training
        for i in range(self.num_layers):
            last = i + 1 == self.num_layers
            x = x * x_mask
            y = dropout(self.attn_layers[i](x, attn_mask, generator), p, training, generator)
            x = self.norm_layers_1[i](x + y)
            y = dropout(self.ffn_layers[i](x, x_mask, generator), p, training, generator)
            if last and self.hidden_channels != self.out_channels:
                x = self.proj(x)
            if self.out_channels != 1 or not last:
                x = self.norm_layers_2[i](x + y)
        return x * x_mask


class WN(nn.Module):
    """Non-causal WaveNet stack with gated units and global conditioning
    (reference wavenet.py:15-118)."""

    def __init__(self, hidden_channels: int, kernel_size: int = 5, dilation_rate: int = 1,
                 num_layers: int = 16, cond_channels: int = 0, dropout_p: float = 0.0):
        super().__init__()
        self.dropout_p = dropout_p
        self.hidden_channels = hidden_channels
        self.num_layers = num_layers
        if cond_channels:
            self.cond_layer = weight_norm(
                nn.Conv1d(cond_channels, 2 * hidden_channels * num_layers, 1))
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(num_layers):
            self.in_layers.append(weight_norm(same_conv1d(
                hidden_channels, 2 * hidden_channels, kernel_size,
                dilation=dilation_rate ** i)))
            rs_ch = 2 * hidden_channels if i < num_layers - 1 else hidden_channels
            self.res_skip_layers.append(weight_norm(nn.Conv1d(hidden_channels, rs_ch, 1)))

    def forward(self, x, x_mask, g=None, generator: Optional[torch.Generator] = None):
        # x (B, H, T); x_mask (B, 1, T); g (B, cond, 1)
        Hc = self.hidden_channels
        output = torch.zeros_like(x)
        g_all = self.cond_layer(g) if (g is not None and hasattr(self, "cond_layer")) else None
        for i in range(self.num_layers):
            acts = dropout(self.in_layers[i](x), self.dropout_p, self.training, generator)
            if g_all is not None:
                acts = acts + g_all[:, i * 2 * Hc: (i + 1) * 2 * Hc]
            acts = torch.tanh(acts[:, :Hc]) * torch.sigmoid(acts[:, Hc:])
            res_skip = self.res_skip_layers[i](acts)
            if i < self.num_layers - 1:
                x = (x + res_skip[:, :Hc]) * x_mask
                output = output + res_skip[:, Hc:]
            else:
                output = output + res_skip
        return output * x_mask


class DilatedDepthSeparableConv(nn.Module):
    """Depthwise dilated (k^i) + pointwise convs with per-step LayerNorm
    (eps 1e-5) and exact GELU (reference sdp.py:40-94)."""

    def __init__(self, channels: int, kernel_size: int = 3, num_layers: int = 3,
                 dropout_p: float = 0.0):
        super().__init__()
        self.dropout_p = dropout_p
        self.num_layers = num_layers
        self.convs_sep = nn.ModuleList()
        self.convs_1x1 = nn.ModuleList()
        self.norms_1 = nn.ModuleList()
        self.norms_2 = nn.ModuleList()
        for i in range(num_layers):
            self.convs_sep.append(same_conv1d(channels, channels, kernel_size,
                                              dilation=kernel_size ** i, groups=channels))
            self.convs_1x1.append(nn.Conv1d(channels, channels, 1))
            self.norms_1.append(LayerNorm(channels, 1e-5))
            self.norms_2.append(LayerNorm(channels, 1e-5))

    def forward(self, x, x_mask, g=None, generator: Optional[torch.Generator] = None):
        if g is not None:
            x = x + g
        for i in range(self.num_layers):
            y = F.gelu(self.norms_1[i](self.convs_sep[i](x * x_mask)))
            y = F.gelu(self.norms_2[i](self.convs_1x1[i](y)))
            x = x + dropout(y, self.dropout_p, self.training, generator)
        return x * x_mask


class ElementwiseAffine(nn.Module):
    """Learned per-channel affine flow (reference sdp.py:97-113)."""

    def __init__(self, channels: int):
        super().__init__()
        self.translation = nn.Parameter(torch.zeros(channels, 1))
        self.log_scale = nn.Parameter(torch.zeros(channels, 1))

    def forward(self, x, x_mask, reverse: bool = False, **kwargs):
        if not reverse:
            y = (self.translation + torch.exp(self.log_scale) * x) * x_mask
            return y, torch.sum(self.log_scale * x_mask, dim=(1, 2))
        return (x - self.translation) * torch.exp(-self.log_scale) * x_mask


class ConvFlow(nn.Module):
    """Coupling flow with a rational-quadratic spline (reference
    sdp.py:116-178): [x0 | spline(x1; params(x0, g))]. ``proj`` starts at
    zero, so every flow starts as the identity."""

    def __init__(self, in_channels: int = 2, filter_channels: int = 192,
                 kernel_size: int = 3, num_layers: int = 3, num_bins: int = 10,
                 tail_bound: float = 5.0):
        super().__init__()
        self.half = in_channels // 2
        self.filter_channels = filter_channels
        self.num_bins = num_bins
        self.tail_bound = tail_bound
        self.pre = nn.Conv1d(self.half, filter_channels, 1)
        self.convs = DilatedDepthSeparableConv(filter_channels, kernel_size, num_layers)
        self.proj = nn.Conv1d(filter_channels, self.half * (num_bins * 3 - 1), 1)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x[:, : self.half], x[:, self.half:]
        h = self.convs(self.pre(x0), x_mask, g=g)
        params = self.proj(h) * x_mask
        B, _, T = x0.shape
        params = params.view(B, self.half, 3 * self.num_bins - 1, T).permute(0, 1, 3, 2)
        K = self.num_bins
        denom = math.sqrt(self.filter_channels)
        out1, logabsdet = rational_quadratic_spline(
            x1, params[..., :K] / denom, params[..., K: 2 * K] / denom, params[..., 2 * K:],
            inverse=reverse, tail_bound=self.tail_bound)
        out = torch.cat([x0, out1], dim=1) * x_mask
        if reverse:
            return out
        return out, torch.sum(logabsdet * x_mask, dim=(1, 2))
