"""Whisper ASR in PyTorch: the transcribe tool's native backend.

Counterpart of ``xva_trainer_tpu/models/whisper/model.py`` (the role of the
reference's vendored OpenAI whisper: a local ``{size}.pt``, a 30 s log-mel,
greedy decoding). The modules keep OpenAI's state-dict names
(``encoder.blocks.{i}.attn.query.weight``, ``decoder.token_embedding.weight``,
...), so a user's checkpoint loads with a strict ``load_state_dict``; the
encoder's sinusoids are a buffer that is not saved, computed in numpy as
the JAX package computes them (``interop/whisper_map.py::load_whisper``
ignores a file's copy, as JAX's rule table does).

As in JAX, the decoder re-runs on the whole fixed-length token buffer at
every greedy step (no KV cache); only the current position's row is
projected onto the vocabulary.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ... import resolve_device
from ...ops.mel import mel_filterbank

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_MELS = 80
CHUNK_SECONDS = 30
N_SAMPLES = SAMPLE_RATE * CHUNK_SECONDS   # 480000
N_FRAMES = N_SAMPLES // HOP               # 3000


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_vocab: int = 51865
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4
    n_mels: int = 80  # large-v3 / v3-turbo use 128

    @property
    def multilingual(self) -> bool:
        return self.n_vocab >= 51865


# "tiny" through "large" dims (OpenAI ModelDimensions)
WHISPER_SIZES = {
    "tiny": WhisperConfig(51865, 1500, 384, 6, 4, 448, 384, 6, 4),
    "base": WhisperConfig(51865, 1500, 512, 8, 6, 448, 512, 8, 6),
    "small": WhisperConfig(51865, 1500, 768, 12, 12, 448, 768, 12, 12),
    "medium": WhisperConfig(51865, 1500, 1024, 16, 24, 448, 1024, 16, 24),
    "large": WhisperConfig(51865, 1500, 1280, 20, 32, 448, 1280, 20, 32),
}


def log_mel_spectrogram(audio: np.ndarray, n_mels: int = N_MELS) -> np.ndarray:
    """OpenAI whisper log-mel on the host: 400/160 hann STFT → slaney mel →
    log10, 8-dB dynamic range, (x+4)/4; the last frame dropped. The JAX
    package's numpy, operation for operation, so bit-identical."""
    x = np.asarray(audio, np.float32)
    if len(x) > N_SAMPLES:
        x = x[:N_SAMPLES]
    else:
        x = np.pad(x, (0, N_SAMPLES - len(x)))
    window = np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    frames = 1 + N_SAMPLES // HOP
    xp = np.pad(x, (N_FFT // 2, N_FFT // 2), mode="reflect")
    idx = np.arange(N_FFT)[None, :] + HOP * np.arange(frames)[:, None]
    stft = np.fft.rfft(xp[idx] * window, axis=1)
    mag2 = (np.abs(stft[:-1]) ** 2).T
    fb = mel_filterbank(SAMPLE_RATE, N_FFT, n_mels, 0.0, SAMPLE_RATE / 2)
    mel = fb @ mag2
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)  # (80, 3000)


def _sinusoids(length: int, channels: int) -> np.ndarray:
    log_timescale = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


class MHA(nn.Module):
    """Multi-head attention: q and k each scaled by d^-0.25, no key bias,
    the mask sliced ``[:T, :S]``."""

    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)

    def forward(self, x, xa=None, mask=None):
        """x (B, T, C) queries; xa (B, S, C) cross keys (None: self)."""
        q = self.query(x)
        src = x if xa is None else xa
        k = self.key(src)
        v = self.value(src)
        B, T, C = q.shape
        S = k.shape[1]
        H = self.n_head
        d = C // H
        scale = d ** -0.25
        qh = (q.reshape(B, T, H, d) * scale).permute(0, 2, 1, 3)
        kh = (k.reshape(B, S, H, d) * scale).permute(0, 2, 3, 1)
        vh = v.reshape(B, S, H, d).permute(0, 2, 1, 3)
        qk = qh @ kh  # (B, H, T, S)
        if mask is not None:
            qk = qk + mask[:T, :S]
        w = torch.softmax(qk, dim=-1)
        return self.out((w @ vh).permute(0, 2, 1, 3).reshape(B, T, C))


class ResidualBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int, cross: bool = False):
        super().__init__()
        self.attn = MHA(n_state, n_head)
        self.attn_ln = nn.LayerNorm(n_state, eps=1e-5)
        self.cross_attn = MHA(n_state, n_head) if cross else None
        self.cross_attn_ln = nn.LayerNorm(n_state, eps=1e-5) if cross else None
        self.mlp = nn.Sequential(nn.Linear(n_state, 4 * n_state), nn.GELU(),
                                 nn.Linear(4 * n_state, n_state))
        self.mlp_ln = nn.LayerNorm(n_state, eps=1e-5)

    def forward(self, x, xa=None, mask=None):
        x = x + self.attn(self.attn_ln(x), mask=mask)
        if self.cross_attn is not None:
            x = x + self.cross_attn(self.cross_attn_ln(x), xa=xa)
        return x + self.mlp(self.mlp_ln(x))


class AudioEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        c = cfg
        self.conv1 = nn.Conv1d(c.n_mels, c.n_audio_state, 3, padding=1)
        self.conv2 = nn.Conv1d(c.n_audio_state, c.n_audio_state, 3, stride=2, padding=1)
        self.register_buffer("positional_embedding",
                             torch.from_numpy(_sinusoids(c.n_audio_ctx, c.n_audio_state)),
                             persistent=False)
        self.blocks = nn.ModuleList(ResidualBlock(c.n_audio_state, c.n_audio_head)
                                    for _ in range(c.n_audio_layer))
        self.ln_post = nn.LayerNorm(c.n_audio_state, eps=1e-5)

    def forward(self, mel):
        """mel (B, n_mels, 3000) → (B, 1500, C)."""
        x = F.gelu(self.conv1(mel))
        x = F.gelu(self.conv2(x)).transpose(1, 2)
        x = x + self.positional_embedding
        for block in self.blocks:
            x = block(x)
        return self.ln_post(x)


class TextDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        c = cfg
        self.token_embedding = nn.Embedding(c.n_vocab, c.n_text_state)
        self.positional_embedding = nn.Parameter(torch.empty(c.n_text_ctx, c.n_text_state))
        nn.init.normal_(self.token_embedding.weight, std=0.02)  # flax's initialisers
        nn.init.normal_(self.positional_embedding, std=0.02)
        self.blocks = nn.ModuleList(ResidualBlock(c.n_text_state, c.n_text_head, cross=True)
                                    for _ in range(c.n_text_layer))
        self.ln = nn.LayerNorm(c.n_text_state, eps=1e-5)
        self.register_buffer("mask", torch.full((c.n_text_ctx, c.n_text_ctx),
                                                float("-inf")).triu(1), persistent=False)

    def hidden(self, tokens, audio_feats):
        """tokens (B, T) int; audio_feats (B, 1500, C) → (B, T, C) after ``ln``."""
        x = self.token_embedding(tokens) + self.positional_embedding[: tokens.shape[1]]
        for block in self.blocks:
            x = block(x, xa=audio_feats, mask=self.mask)
        return self.ln(x)

    def forward(self, tokens, audio_feats):
        """→ logits (B, T, V), tied to the token embedding."""
        return self.hidden(tokens, audio_feats) @ self.token_embedding.weight.T


class Whisper(nn.Module):
    def __init__(self, cfg: WhisperConfig = WhisperConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = AudioEncoder(cfg)
        self.decoder = TextDecoder(cfg)

    def encode(self, mel):
        return self.encoder(mel)

    def decode_logits(self, tokens, audio_feats):
        return self.decoder(tokens, audio_feats)

    def forward(self, mel, tokens):
        return self.decoder(tokens, self.encoder(mel))


# ---------------- special-token layout (OpenAI multilingual vocab) ----------

WHISPER_LANGS = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln ha "
    "ba jw su"
).split()


class SpecialTokens:
    """Token-id layout of the whisper vocab: text tokens | eot | sot |
    languages | translate | transcribe | sot_lm | sot_prev | no_speech |
    no_timestamps | 1501 timestamps. Multilingual (51 865, 99 languages)
    and large-v3 (51 866, with ``yue``): eot 50257; English-only (51 864):
    eot 50256. Tiny test vocabularies keep the order, packed at the top."""

    def __init__(self, n_vocab: int = 51865):
        self.langs = list(WHISPER_LANGS)
        if n_vocab >= 51866:
            self.langs.append("yue")
        n_timestamps = 1501 if n_vocab > 2000 else 0
        specials = 8  # eot..no_timestamps incl. sot_lm
        base = n_vocab - n_timestamps - len(self.langs) - specials
        if base < 0:
            base = max(0, n_vocab - len(self.langs) - specials)
        self.eot = base
        self.sot = base + 1
        self.lang_base = base + 2
        self.translate = self.lang_base + len(self.langs)
        self.transcribe = self.translate + 1
        sot_lm = self.transcribe + 1
        self.sot_prev = sot_lm + 1
        self.no_speech = self.sot_prev + 1
        self.no_timestamps = self.no_speech + 1

    def lang_id(self, lang: str) -> int:
        return self.lang_base + self.langs.index(lang)


class WhisperASR:
    """Host-facing greedy decoder (the role of ``whisper.decode`` in the
    reference's transcribe tool) on ``device``, from a state dict in
    OpenAI's names (``interop/whisper_map.py::load_whisper``)."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], cfg: WhisperConfig,
                 max_tokens: int = 224, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = Whisper(cfg)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        self.st = SpecialTokens(cfg.n_vocab)
        self.max_tokens = max_tokens

    @torch.no_grad()
    def encode(self, audio16k: np.ndarray) -> torch.Tensor:
        """(T,) 16 kHz → the encoder's (1, 1500, C) on the device."""
        mel = log_mel_spectrogram(audio16k, self.cfg.n_mels)[None]
        return self.model.encode(torch.from_numpy(mel).to(self.device))

    @torch.no_grad()
    def _next(self, buf: torch.Tensor, idx: int, feats: torch.Tensor) -> int:
        """The argmax over ``[: eot + 1]`` of the logits at ``idx``."""
        h = self.model.decoder.hidden(buf, feats)[0, idx]
        row = h @ self.model.decoder.token_embedding.weight[: self.st.eot + 1].T
        return int(torch.argmax(row))

    @torch.no_grad()
    def _lang_logits(self, feats: torch.Tensor) -> torch.Tensor:
        """The language tokens' logits one step after ``sot`` (the
        reference's ``whisper.detect_language``), on the full buffer."""
        buf = torch.zeros((1, self.max_tokens), dtype=torch.long, device=self.device)
        buf[0, 0] = self.st.sot
        row = self.model.decode_logits(buf, feats)[0, 0]
        return row[self.st.lang_base: self.st.lang_base + len(self.st.langs)]

    def detect_language(self, audio16k_or_feats, is_feats: bool = False) -> str:
        """The most probable language code from the first decode step."""
        if not self.cfg.multilingual:
            return "en"
        feats = audio16k_or_feats if is_feats else self.encode(audio16k_or_feats)
        return self.st.langs[int(torch.argmax(self._lang_logits(feats)))]

    def transcribe_tokens(self, audio16k: np.ndarray, lang: Optional[str] = "en") -> list:
        """Greedy token ids after the prefix (``sot, lang, transcribe,
        no_timestamps`` on a multilingual vocabulary, ``sot, no_timestamps``
        otherwise; ``lang`` None or "" autodetects), up to ``eot`` or the
        buffer's end."""
        feats = self.encode(audio16k)
        st = self.st
        prefix = [st.sot]
        if self.cfg.multilingual:
            if not lang:
                lang = self.detect_language(feats, is_feats=True)
            prefix += [st.lang_id(lang), st.transcribe]
        prefix.append(st.no_timestamps)
        buf = torch.zeros((1, self.max_tokens), dtype=torch.long)
        buf[0, : len(prefix)] = torch.tensor(prefix)
        buf = buf.to(self.device)
        out = []
        idx = len(prefix) - 1
        for _ in range(self.max_tokens - len(prefix)):
            nxt = self._next(buf, idx, feats)
            if nxt == st.eot:
                break
            idx += 1
            buf[0, idx] = nxt
            out.append(nxt)
        return out
