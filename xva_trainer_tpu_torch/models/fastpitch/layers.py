"""FastPitch building blocks in PyTorch.

Counterparts of ``xva_trainer_tpu/models/fastpitch/layers.py`` (reference
python/fastpitch1_1/fastpitch/transformer.py, model.py:103-122,
common/layers.py, attention.py:83-220). Tensors are channels-last
(B, T, C), as in the JAX layers; parameters carry the reference's torch
names, so that a reference state dict loads with ``strict=True``.

- Every LayerNorm has eps 1e-5; every convolution is 'same'-padded (all
  kernels are odd).
- A masked attention score is filled with the most negative finite value of
  its type, as JAX fills it (``finfo(dtype).min``), not with -inf: a row
  whose keys are all masked (the all-zero rows that pad a bucket's short
  last batch, and their length-0 decoder rows) then gets uniform weights.
  A -inf fill, or a boolean mask to ``scaled_dot_product_attention``, makes
  such a row NaN, and a NaN loss makes the step skip its update.
- Dropout follows the model's mode; its mask is drawn from the
  ``generator`` passed down the call (nothing reads the global RNG).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..xvapitch.layers import dropout


@functools.lru_cache(maxsize=64)
def _sinusoids(length: int, dim: int) -> np.ndarray:
    inv_freq = 1.0 / (10000 ** (np.arange(0.0, dim, 2.0) / dim))
    pos = np.arange(length, dtype=np.float64)[:, None] * inv_freq[None, :]
    return np.concatenate([np.sin(pos), np.cos(pos)], axis=1).astype(np.float32)


def sinusoid_positions(length: int, dim: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """[sin | cos] embeddings (reference transformer.py:21-35), computed in
    float64 and rounded, as JAX computes them: (length, dim)."""
    return torch.from_numpy(_sinusoids(length, dim)).to(device=device, dtype=dtype)


class Conv1d(nn.Conv1d):
    """'same'-padded Conv1d over (B, T, C)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, bias: bool = True):
        super().__init__(in_ch, out_ch, kernel_size, padding=kernel_size // 2, bias=bias)

    def forward(self, x):
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class ConvReLUNorm(nn.Module):
    """conv → relu → LayerNorm → dropout (reference common/layers.py)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, p_dropout: float = 0.1):
        super().__init__()
        self.conv = Conv1d(in_ch, out_ch, kernel_size)
        self.norm = nn.LayerNorm(out_ch, eps=1e-5)
        self.p_dropout = p_dropout

    def forward(self, x, generator=None):
        x = self.norm(F.relu(self.conv(x)))
        return dropout(x, self.p_dropout, self.training, generator)


class TemporalPredictor(nn.Module):
    """Per-position predictor (duration, pitch, energy): (B, T, C) →
    (B, T, n_predictions), masked."""

    def __init__(self, in_ch: int, filter_size: int = 256, kernel_size: int = 3,
                 p_dropout: float = 0.1, n_layers: int = 2, n_predictions: int = 1):
        super().__init__()
        self.layers = nn.ModuleList(
            ConvReLUNorm(in_ch if i == 0 else filter_size, filter_size, kernel_size, p_dropout)
            for i in range(n_layers))
        self.fc = nn.Linear(filter_size, n_predictions)

    def forward(self, enc_out, enc_mask, generator=None):
        out = enc_out * enc_mask
        for layer in self.layers:
            out = layer(out, generator)
        return self.fc(out) * enc_mask


class MultiHeadAttn(nn.Module):
    """Post-LN self attention (reference transformer.py:81-152)."""

    def __init__(self, d_model: int, n_head: int, d_head: int, p_dropout: float = 0.1,
                 p_dropatt: float = 0.1):
        super().__init__()
        self.n_head, self.d_head = n_head, d_head
        self.qkv_net = nn.Linear(d_model, 3 * n_head * d_head)
        self.o_net = nn.Linear(n_head * d_head, d_model, bias=False)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5)
        self.p_dropout, self.p_dropatt = p_dropout, p_dropatt

    def forward(self, x, pad_mask, generator=None):
        # x (B, T, C); pad_mask (B, T, 1), 1 at valid positions
        B, T, C = x.shape
        q, k, v = (t.reshape(B, T, self.n_head, self.d_head)
                   for t in self.qkv_net(x).chunk(3, dim=-1))
        score = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / np.sqrt(self.d_head))
        score = score.masked_fill(pad_mask[:, None, None, :, 0] <= 0,
                                  torch.finfo(score.dtype).min)
        prob = dropout(torch.softmax(score, dim=-1), self.p_dropatt, self.training, generator)
        vec = torch.einsum("bhqk,bkhd->bqhd", prob.to(v.dtype), v).reshape(B, T, -1)
        out = dropout(self.o_net(vec), self.p_dropout, self.training, generator)
        return self.layer_norm(x + out)


class PositionwiseConvFF(nn.Module):
    """conv(k) → relu → conv(k) → dropout, post-LN residual."""

    def __init__(self, d_model: int, d_inner: int, kernel_size: int = 3, p_dropout: float = 0.1):
        super().__init__()
        pad = kernel_size // 2
        self.CoreNet = nn.Sequential(nn.Conv1d(d_model, d_inner, kernel_size, padding=pad),
                                     nn.ReLU(),
                                     nn.Conv1d(d_inner, d_model, kernel_size, padding=pad))
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5)
        self.p_dropout = p_dropout

    def forward(self, x, generator=None):
        h = self.CoreNet(x.transpose(1, 2)).transpose(1, 2)
        h = dropout(h, self.p_dropout, self.training, generator)
        return self.layer_norm(x + h)


class TransformerLayer(nn.Module):
    def __init__(self, d_model, n_head, d_head, d_inner, kernel_size, p_dropout, p_dropatt):
        super().__init__()
        self.dec_attn = MultiHeadAttn(d_model, n_head, d_head, p_dropout, p_dropatt)
        self.pos_ff = PositionwiseConvFF(d_model, d_inner, kernel_size, p_dropout)


class FFTransformer(nn.Module):
    """Self-attention and conv-FF layers with sinusoidal positions (reference
    transformer.py:170-262). ``embed_input``: token embedding (the encoder)
    or pre-encoded frames with lengths (the decoder)."""

    def __init__(self, n_layer: int = 6, n_head: int = 1, d_model: int = 384, d_head: int = 64,
                 d_inner: int = 1536, kernel_size: int = 3, p_dropout: float = 0.1,
                 p_dropatt: float = 0.1, p_dropemb: float = 0.0, embed_input: bool = True,
                 n_embed: int = 148, padding_idx: int = 0):
        super().__init__()
        self.d_model, self.embed_input, self.padding_idx = d_model, embed_input, padding_idx
        self.p_dropemb = p_dropemb
        if embed_input:
            self.word_emb = nn.Embedding(n_embed, d_model)
        self.layers = nn.ModuleList(
            TransformerLayer(d_model, n_head, d_head, d_inner, kernel_size, p_dropout, p_dropatt)
            for _ in range(n_layer))

    def forward(self, inp, seq_lens: Optional[torch.Tensor] = None, conditioning=0.0,
                generator=None):
        if self.embed_input:
            x = self.word_emb(inp)
            mask = (inp != self.padding_idx)[..., None].to(x.dtype)
        else:
            x = inp
            T = x.shape[1]
            mask = (torch.arange(T, device=x.device)[None, :] < seq_lens[:, None])[..., None]
            mask = mask.to(x.dtype)
        pos = sinusoid_positions(x.shape[1], self.d_model, x.device, x.dtype)[None] * mask
        out = dropout(x + pos + conditioning, self.p_dropemb, self.training, generator)
        for layer in self.layers:
            out = layer.dec_attn(out, mask, generator) * mask
            out = layer.pos_ff(out, generator) * mask
        return out, mask


class ConvNorm(nn.Module):
    """The reference's ConvNorm: a 'same' conv under the name ``conv``,
    channels-first."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1):
        super().__init__()
        self.conv = nn.Conv1d(in_ch, out_ch, kernel_size, padding=kernel_size // 2)

    def forward(self, x):
        return self.conv(x)


class ConvAttention(nn.Module):
    """Gaussian-isotropic soft aligner between mel frames (queries) and text
    (keys), reference attention.py:83-220 with ``align_query_enc_type`` 3xconv.
    Returns (attn_soft, attn_logprob), both (B, T_mel, T_text)."""

    def __init__(self, n_mel_channels: int = 80, n_text_channels: int = 384,
                 n_att_channels: int = 80):
        super().__init__()
        self.key_proj = nn.Sequential(ConvNorm(n_text_channels, n_text_channels * 2, 3),
                                      nn.ReLU(),
                                      ConvNorm(n_text_channels * 2, n_att_channels, 1))
        self.query_proj = nn.Sequential(ConvNorm(n_mel_channels, n_mel_channels * 2, 3),
                                        nn.ReLU(),
                                        ConvNorm(n_mel_channels * 2, n_mel_channels, 1),
                                        nn.ReLU(),
                                        ConvNorm(n_mel_channels, n_att_channels, 1))

    def forward(self, queries, keys, key_pad_mask, attn_prior=None):
        # queries (B, T_mel, n_mel); keys (B, T_text, C); key_pad_mask (B, T_text), 1 valid
        k = self.key_proj(keys.transpose(1, 2)).transpose(1, 2)
        q = self.query_proj(queries.transpose(1, 2)).transpose(1, 2)
        # -0.0005 * ||q - k||^2 → (B, T_mel, T_text)
        q2 = (q ** 2).sum(-1)[:, :, None]
        k2 = (k ** 2).sum(-1)[:, None, :]
        qk = torch.einsum("bqc,bkc->bqk", q, k)
        attn = -0.0005 * (q2 - 2.0 * qk + k2)
        if attn_prior is not None:
            attn = F.log_softmax(attn, dim=-1) + torch.log(attn_prior + 1e-8)
        attn_logprob = attn
        attn = attn.masked_fill(key_pad_mask[:, None, :] <= 0, torch.finfo(attn.dtype).min)
        return torch.softmax(attn, dim=-1), attn_logprob
