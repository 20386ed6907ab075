"""FastPitch 1.1, the v2 acoustic model, in PyTorch.

Counterpart of ``xva_trainer_tpu/models/fastpitch/model.py`` (reference
python/fastpitch1_1/fastpitch/model.py: regulate_len:59-79,
average_pitch:82-100, the staged forward:325-390, infer:426-482), with its
staged methods: ``stage1`` (the aligner), ``stage2`` and
``stage2_from_durs`` (the duration predictor), ``full`` (stages 3 and 4)
and ``infer``. Parameters carry the reference's torch key names (the
``tp`` side of ``interop/fastpitch_map.py``); the sinusoid buffers, the
unused ``attention.attn_proj`` and the pitch statistics are written by the
export (``fastpitch_extra_keys``), not held here.

The aligner's hard path is ``ops/mas.py::maximum_path`` of the soft
attention, detached and swapped to (B, T_text, T_mel), with the float
outer product of the two length masks: on the card the MAS kernel, which
takes the soft attention in fp32 or bf16 (under autocast torch keeps
``softmax`` in fp32, where JAX's AMP gives bf16).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from ...ops.mas import maximum_path
from .layers import ConvAttention, Conv1d, FFTransformer, TemporalPredictor


@dataclasses.dataclass(frozen=True)
class FastPitchConfig:
    n_mel_channels: int = 80
    n_symbols: int = 148
    padding_idx: int = 0
    symbols_embedding_dim: int = 384
    in_fft_n_layers: int = 6
    in_fft_n_heads: int = 1
    in_fft_d_head: int = 64
    in_fft_kernel_size: int = 3
    in_fft_filter_size: int = 1536
    out_fft_n_layers: int = 6
    out_fft_n_heads: int = 1
    out_fft_d_head: int = 64
    out_fft_kernel_size: int = 3
    out_fft_filter_size: int = 1536
    p_fft_dropout: float = 0.1
    p_fft_dropatt: float = 0.1
    predictor_filter_size: int = 256
    predictor_kernel_size: int = 3
    p_predictor_dropout: float = 0.1
    predictor_n_layers: int = 2
    pitch_embedding_kernel_size: int = 3
    energy_conditioning: bool = True
    energy_embedding_kernel_size: int = 3
    max_duration: float = 75.0


def regulate_len(durations: torch.Tensor, enc_out: torch.Tensor, pace: float = 1.0,
                 mel_max_len: Optional[int] = None):
    """Expand text-rate features to frame rate as a one-hot product with a
    fixed ``mel_max_len`` (reference model.py:59-79). durations (B, T_text);
    enc_out (B, T_text, C) → (B, mel_max_len, C), dec_lens (B,)."""
    if mel_max_len is None:
        raise ValueError("mel_max_len must be given")
    reps = (durations.float() * pace + 0.5).to(torch.int32)
    dec_lens = reps.sum(dim=1)
    cums = torch.cumsum(nn.functional.pad(reps, (1, 0)), dim=1)  # (B, T+1)
    rng = torch.arange(mel_max_len, device=enc_out.device)[None, :, None]
    mult = (cums[:, None, :-1] <= rng) & (cums[:, None, 1:] > rng)
    enc_rep = torch.einsum("bmt,btc->bmc", mult.to(enc_out.dtype), enc_out)
    return enc_rep, torch.clamp(dec_lens, max=mel_max_len)


def average_pitch(pitch: torch.Tensor, durs: torch.Tensor) -> torch.Tensor:
    """Mean of the nonzero pitch frames of each text token (reference
    model.py:82-100): pitch (B, n_formants, T_mel), durs (B, T_text) →
    (B, n_formants, T_text). Token bounds past the frames are clipped."""
    ends = torch.cumsum(durs, dim=1).to(torch.long)
    starts = nn.functional.pad(ends[:, :-1], (1, 0))
    pad = (1, 0)
    nz_cums = nn.functional.pad(torch.cumsum((pitch != 0.0).float(), dim=2), pad)
    cums = nn.functional.pad(torch.cumsum(pitch, dim=2), pad)
    T1 = cums.shape[-1]
    shape = (pitch.shape[0], pitch.shape[1], durs.shape[1])
    ends_c = ends.clamp(0, T1 - 1)[:, None, :].expand(shape)
    starts_c = starts.clamp(0, T1 - 1)[:, None, :].expand(shape)
    sums = torch.gather(cums, 2, ends_c) - torch.gather(cums, 2, starts_c)
    nelems = torch.gather(nz_cums, 2, ends_c) - torch.gather(nz_cums, 2, starts_c)
    return torch.where(nelems == 0.0, 0.0, sums / torch.clamp(nelems, min=1.0))


class FastPitch(nn.Module):
    """Encoder FFT → (aligner | duration, pitch and energy predictors) →
    decoder FFT → mel projection."""

    def __init__(self, cfg: FastPitchConfig = FastPitchConfig()):
        super().__init__()
        c = self.cfg = cfg
        d = c.symbols_embedding_dim
        self.encoder = FFTransformer(
            c.in_fft_n_layers, c.in_fft_n_heads, d, c.in_fft_d_head, c.in_fft_filter_size,
            c.in_fft_kernel_size, c.p_fft_dropout, c.p_fft_dropatt, embed_input=True,
            n_embed=c.n_symbols, padding_idx=c.padding_idx)
        self.decoder = FFTransformer(
            c.out_fft_n_layers, c.out_fft_n_heads, d, c.out_fft_d_head, c.out_fft_filter_size,
            c.out_fft_kernel_size, c.p_fft_dropout, c.p_fft_dropatt, embed_input=False)

        def predictor():
            return TemporalPredictor(d, c.predictor_filter_size, c.predictor_kernel_size,
                                     c.p_predictor_dropout, c.predictor_n_layers)

        self.duration_predictor = predictor()
        self.pitch_predictor = predictor()
        self.pitch_emb = Conv1d(1, d, c.pitch_embedding_kernel_size)
        if c.energy_conditioning:
            self.energy_predictor = predictor()
            self.energy_emb = Conv1d(1, d, c.energy_embedding_kernel_size)
        self.proj = nn.Linear(d, c.n_mel_channels)
        self.attention = ConvAttention(c.n_mel_channels, d, n_att_channels=80)

    # ---------- alignment (training stage 1, and duration extraction) ----------

    def _alignment(self, tokens, input_lens, mel_tgt, mel_lens, attn_prior):
        text_emb = self.encoder.word_emb(tokens)  # the encoder's embedding, shared
        key_pad = (tokens != self.cfg.padding_idx).float()
        attn_soft, attn_logprob = self.attention(mel_tgt, text_emb, key_pad, attn_prior)
        t_text, t_mel = tokens.shape[1], mel_tgt.shape[1]
        dev = tokens.device
        mask = ((torch.arange(t_text, device=dev)[None, :, None] < input_lens[:, None, None])
                & (torch.arange(t_mel, device=dev)[None, None, :] < mel_lens[:, None, None])
                ).float()
        attn_hard = maximum_path(attn_soft.detach().transpose(1, 2), mask).transpose(1, 2)
        durations = attn_hard.sum(dim=1)  # (B, T_text)
        return attn_soft, attn_logprob, attn_hard, durations

    def stage1(self, tokens, input_lens, mel_tgt, mel_lens, attn_prior):
        """The aligner alone (reference forward:348-360). The encoder's
        output is not read in this stage, so it is not computed: its layers
        get no gradient, as in JAX, where they get zeros. The aligner has
        no dropout."""
        attn_soft, attn_logprob, attn_hard, durs = self._alignment(
            tokens, input_lens, mel_tgt, mel_lens, attn_prior)
        return {"attn_soft": attn_soft, "attn_logprob": attn_logprob, "attn_hard": attn_hard,
                "durations": durs}

    def _durations_pred(self, enc_out, enc_mask, generator):
        log_dur_pred = self.duration_predictor(enc_out, enc_mask, generator)[..., 0]
        dur_pred = torch.clamp(torch.exp(log_dur_pred) - 1, 0, self.cfg.max_duration)
        return log_dur_pred, dur_pred

    def stage2(self, tokens, input_lens, mel_tgt, mel_lens, attn_prior, generator=None):
        """The duration predictor on the aligner's durations (reference
        forward:368-374)."""
        enc_out, enc_mask = self.encoder(tokens, generator=generator)
        _, _, _, durs = self._alignment(tokens, input_lens, mel_tgt, mel_lens, attn_prior)
        log_dur_pred, dur_pred = self._durations_pred(enc_out, enc_mask, generator)
        return {"log_dur_pred": log_dur_pred, "dur_pred": dur_pred, "durations": durs}

    def stage2_from_durs(self, tokens, input_lens, durs_gt, generator=None):
        """The duration predictor on extracted durations (no aligner)."""
        enc_out, enc_mask = self.encoder(tokens, generator=generator)
        log_dur_pred, dur_pred = self._durations_pred(enc_out, enc_mask, generator)
        return {"log_dur_pred": log_dur_pred, "dur_pred": dur_pred, "durations": durs_gt}

    def _pitch_energy(self, enc_out, enc_mask, pitch_dense, energy_dense, dur_tgt, use_gt_pitch,
                      generator):
        pitch_pred = self.pitch_predictor(enc_out, enc_mask, generator)  # (B, T_text, 1)
        pitch_tgt = average_pitch(pitch_dense, dur_tgt)  # (B, 1, T_text)
        pitch_in = pitch_tgt.transpose(1, 2) if use_gt_pitch else pitch_pred
        enc_out = enc_out + self.pitch_emb(pitch_in)
        energy_pred = energy_tgt = None
        if self.cfg.energy_conditioning:
            energy_pred = self.energy_predictor(enc_out, enc_mask, generator)[..., 0]
            energy_tgt = torch.log(1.0 + average_pitch(energy_dense[:, None, :], dur_tgt))
            enc_out = enc_out + self.energy_emb(energy_tgt.transpose(1, 2))
            energy_tgt = energy_tgt[:, 0, :]
        return enc_out, pitch_pred, pitch_tgt, energy_pred, energy_tgt

    def full(self, tokens, input_lens, mel_tgt, mel_lens, pitch_dense, energy_dense,
             attn_prior=None, durs_gt=None, *, use_gt_pitch: bool = True,
             mel_max_len: Optional[int] = None, run_aligner: bool = True, generator=None):
        """Stages 3 and 4 (reference forward:325-390): the durations from the
        aligner (``run_aligner``) or ``durs_gt``."""
        enc_out, enc_mask = self.encoder(tokens, generator=generator)
        if run_aligner:
            _, _, _, dur_tgt = self._alignment(tokens, input_lens, mel_tgt, mel_lens, attn_prior)
        else:
            dur_tgt = durs_gt
        log_dur_pred, dur_pred = self._durations_pred(enc_out, enc_mask, generator)
        enc_out, pitch_pred, pitch_tgt, energy_pred, energy_tgt = self._pitch_energy(
            enc_out, enc_mask, pitch_dense, energy_dense, dur_tgt, use_gt_pitch, generator)
        mel_max_len = mel_max_len or mel_tgt.shape[1]
        len_regulated, dec_lens = regulate_len(dur_tgt, enc_out, 1.0, mel_max_len)
        dec_out, dec_mask = self.decoder(len_regulated, seq_lens=dec_lens, generator=generator)
        return {"mel_out": self.proj(dec_out), "dec_mask": dec_mask, "dur_pred": dur_pred,
                "log_dur_pred": log_dur_pred, "pitch_pred": pitch_pred, "pitch_tgt": pitch_tgt,
                "energy_pred": energy_pred, "energy_tgt": energy_tgt, "durations": dur_tgt,
                "dec_lens": dec_lens}

    def infer(self, tokens, *, pace: float = 1.0, mel_max_len: int = 2048, pitch_transform=None,
              generator=None):
        """Inference (reference infer:426-482): mel_out (B, n_mel, T)."""
        enc_out, enc_mask = self.encoder(tokens, generator=generator)
        _, dur_pred = self._durations_pred(enc_out, enc_mask, generator)
        pitch_pred = self.pitch_predictor(enc_out, enc_mask, generator)
        if pitch_transform is not None:
            pitch_pred = pitch_transform(pitch_pred)
        enc_out = enc_out + self.pitch_emb(pitch_pred)
        if self.cfg.energy_conditioning:
            energy_pred = self.energy_predictor(enc_out, enc_mask, generator)[..., 0]
            enc_out = enc_out + self.energy_emb(energy_pred[..., None])
        len_regulated, dec_lens = regulate_len(dur_pred, enc_out, pace, mel_max_len)
        dec_out, _ = self.decoder(len_regulated, seq_lens=dec_lens, generator=generator)
        return {"mel_out": self.proj(dec_out).transpose(1, 2), "dec_lens": dec_lens,
                "dur_pred": dur_pred, "pitch_pred": pitch_pred}
