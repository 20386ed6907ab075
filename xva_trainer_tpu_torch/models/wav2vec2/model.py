"""wav2vec 2.0 CTC ASR in PyTorch: the transcribe tool's per-language
backend (the reference loads HuggingFace ``Wav2Vec2ForCTC`` checkpoints per
language).

Counterpart of ``xva_trainer_tpu/models/wav2vec2/model.py``. Base
architecture (``do_stable_layer_norm=False``, group-norm feature
extractor): strided conv feature extractor → LN + projection → grouped conv
positional embedding → post-LN transformer stack → CTC head. The modules
keep HuggingFace's names (``wav2vec2.feature_extractor.conv_layers.{i}.conv
.weight``, ..., ``lm_head``), and the positional conv its weight norm over
dim 2 (``weight_g``/``weight_v``), so a ``Wav2Vec2ForCTC`` state dict loads
strictly (``interop/wav2vec2_map.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ... import resolve_device
from ..conv import weight_norm


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    vocab_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16


class ConvLayer(nn.Module):
    """One feature-extractor layer: a bias-free strided conv; on layer 0 a
    GroupNorm with groups = channels (per channel over time)."""

    def __init__(self, cin: int, cout: int, k: int, s: int, norm: bool):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, stride=s, bias=False)
        self.layer_norm = nn.GroupNorm(cout, cout, eps=1e-5) if norm else None

    def forward(self, x):
        x = self.conv(x)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return F.gelu(x)


class FeatureExtractor(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        ins = (1,) + tuple(cfg.conv_dim[:-1])
        self.conv_layers = nn.ModuleList(
            ConvLayer(i, d, k, s, norm=n == 0) for n, (i, d, s, k) in enumerate(
                zip(ins, cfg.conv_dim, cfg.conv_stride, cfg.conv_kernel)))

    def forward(self, wav):
        """wav (B, T) → (B, conv_dim[-1], T')."""
        x = wav[:, None]
        for layer in self.conv_layers:
            x = layer(x)
        return x


class FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=1e-5)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class PosConvEmbed(nn.Module):
    """Grouped conv with padding k//2, weight norm over dim 2 (per kernel
    position); an even kernel drops the last frame (HF ``SamePadLayer``)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        k = cfg.pos_conv_kernel
        self.conv = weight_norm(nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                                          groups=cfg.pos_conv_groups), dim=2)
        self.trim = k % 2 == 0

    def forward(self, x):
        """x (B, T, C) → (B, T, C)."""
        h = self.conv(x.transpose(1, 2))
        if self.trim:
            h = h[..., :-1]
        return F.gelu(h).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        C = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.q_proj = nn.Linear(C, C)
        self.k_proj = nn.Linear(C, C)
        self.v_proj = nn.Linear(C, C)
        self.out_proj = nn.Linear(C, C)

    def forward(self, x):
        B, T, C = x.shape
        H = self.num_heads
        d = C // H

        def heads(t):
            return t.reshape(B, T, H, d).permute(0, 2, 1, 3)

        q = self.q_proj(x) * (d ** -0.5)
        w = torch.softmax(heads(q) @ heads(self.k_proj(x)).transpose(-1, -2), dim=-1)
        attn = (w @ heads(self.v_proj(x))).permute(0, 2, 1, 3).reshape(B, T, C)
        return self.out_proj(attn)


class FeedForward(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    """Post-LN transformer layer."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.attention = Attention(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.feed_forward = FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, x):
        x = self.layer_norm(x + self.attention(x))
        return self.final_layer_norm(x + self.feed_forward(x))


class Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = PosConvEmbed(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_layers))

    def forward(self, x):
        x = self.layer_norm(x + self.pos_conv_embed(x))
        for layer in self.layers:
            x = layer(x)
        return x


class Wav2Vec2Backbone(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.feature_extractor = FeatureExtractor(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = Encoder(cfg)

    def forward(self, wav):
        x = self.feature_extractor(wav).transpose(1, 2)
        return self.encoder(self.feature_projection(x))


class Wav2Vec2Model(nn.Module):
    """wav (B, T) 16 kHz → CTC logits (B, T', vocab)."""

    def __init__(self, cfg: Wav2Vec2Config = Wav2Vec2Config()):
        super().__init__()
        self.cfg = cfg
        self.wav2vec2 = Wav2Vec2Backbone(cfg)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size)

    def forward(self, wav):
        return self.lm_head(self.wav2vec2(wav))


def ctc_greedy_decode(logits: np.ndarray, id_to_char: dict,
                      blank_id: int = 0, word_delim: str = "|") -> str:
    """Argmax CTC decode: collapse repeats, drop blanks and ``<...>``
    specials (HF's decode strips them), '|' → space."""
    ids = np.asarray(logits).argmax(axis=-1).reshape(-1)
    out = []
    prev = -1
    for i in ids:
        if i != prev and i != blank_id:
            ch = id_to_char.get(int(i), "")
            if ch.startswith("<") and ch.endswith(">"):
                prev = i
                continue
            out.append(" " if ch == word_delim else ch)
        prev = i
    return "".join(out).strip()


class Wav2Vec2CTC:
    """Host-facing wrapper on ``device``: a local HF checkpoint directory →
    transcription."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], cfg: Wav2Vec2Config, vocab: dict,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = Wav2Vec2Model(cfg)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        self.id_to_char = {int(v): k for k, v in vocab.items()}

    @classmethod
    def from_hf_dir(cls, path: str, device="cuda") -> "Wav2Vec2CTC":
        from ...interop.wav2vec2_map import load_wav2vec2

        return cls(*load_wav2vec2(path), device=device)

    @torch.no_grad()
    def logits(self, wav16k: np.ndarray) -> np.ndarray:
        """(T,) → (T', vocab) after HF's zero-mean, unit-variance input
        normalisation."""
        x = np.asarray(wav16k, np.float32)
        x = (x - x.mean()) / np.sqrt(x.var() + 1e-7)
        return self.model(torch.from_numpy(x)[None].to(self.device))[0].float().cpu().numpy()

    def transcribe(self, wav16k: np.ndarray) -> str:
        return ctc_greedy_decode(self.logits(wav16k), self.id_to_char)
