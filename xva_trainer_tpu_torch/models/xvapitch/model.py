"""xVAPitch (VITS + pitch conditioning), the v3 model, in PyTorch: the
training forward, inference and voice conversion.

Counterpart of ``xva_trainer_tpu/models/xvapitch/model.py`` (reference
python/xvapitch/model.py: train_step :681-905, infer :417-599,
voice_conversion :602-622) with the "big" configuration (latent 256, 12-dim
language embedding over 31 languages, 512-d speaker d-vectors).
Channels-first; parameter names are the reference's, so
``interop.convert.xvapitch_state_dict`` loads it with ``strict=True`` (and so
does a reference state dict, once ``interop.convert.ups_from_reference`` has
moved its decoder's upsampling weight norm to the output axis). The config
keeps the JAX fields, so either config converts to the other field by field.

Every random draw is an explicit input: the posterior's (B, latent, T)
noise, the SDP's (B, 2, T_text) noise, the segment starts' uniform draw
(B,) and, in training mode, the dropout masks, each a tensor argument or
drawn from a passed ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.mas import maximum_path
from ...parallel import draws
from ..hifigan.models import Generator as HifiganGenerator, HifiganConfig
from .modules import (
    PosteriorEncoder,
    RelativePositioningPitchEnergyEncoder,
    ResidualCouplingBlocks,
    ReversalClassifier,
    StochasticDurationPredictor,
    TextEncoder,
    sequence_mask,
    standard_normal,
)

NUM_LANGUAGES = 31  # reference python/xvapitch/text/__init__.py:5-37


@dataclasses.dataclass(frozen=True)
class XVAPitchConfig:
    n_vocab: int = 524  # len(ALL_SYMBOLS)
    big: bool = True
    pitch: bool = True
    energy: bool = False
    # language-adversarial reversal classifier: off on the app path (reference
    # --mltts_rc default 0) and absent from the shipped base checkpoint
    mltts_rc: bool = False
    pe_scaling: float = 0.1   # pitch conditioning scale (inference parity)
    lang_w: float = 1.0
    d_vector_dim: int = 512
    spec_segment_size: int = 32
    hop_length: int = 256
    num_languages: int = NUM_LANGUAGES
    # structural depths (reference values; reducible for tests)
    text_layers: int = 10
    posterior_layers: int = 16
    flow_wn_layers: int = 4
    num_flows: int = 4
    sdp_flows: int = 4
    pitch_layers: int = 3
    # decoder (HiFi-GAN MRF)
    upsample_rates: tuple = (8, 8, 2, 2)
    upsample_kernel_sizes: tuple = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: tuple = (3, 7, 11)
    # the reference forces inference_noise_scale=0 before sampling
    # (reference model.py:549-550): synthesis sits at the prior mean
    inference_noise_scale: float = 0.0
    inference_noise_scale_dp: float = 0.333
    length_scale: float = 1.0

    @property
    def latent_size(self) -> int:
        return 256 if self.big else 192

    @property
    def lang_emb_dim(self) -> int:
        return 12 if self.big else 4


def rand_segments(x: torch.Tensor, x_lengths: torch.Tensor, segment_size: int, *,
                  u: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None):
    """Random per-item ``segment_size``-frame slices of (B, C, T) (reference
    util.py:145-163). The start is floor(u * (max_start + 1)), clipped to
    T - segment_size, with u (B,) uniform in [0, 1): passed, or drawn from
    ``generator``. Returns the (B, C, segment_size) slices and the starts."""
    B, _, T = x.shape
    max_start = torch.clamp(x_lengths - segment_size, min=0)
    if u is None:
        if generator is None:
            raise ValueError("pass the segment draw u or a torch.Generator to draw it from")
        u = draws.rand((B,), generator)
    starts = (u.to(x.device).float() * (max_start + 1).float()).long()
    starts = torch.clamp(starts, max=max(T - segment_size, 0))
    return segment(x, starts, segment_size), starts


def segment(x: torch.Tensor, starts: torch.Tensor, segment_size: int) -> torch.Tensor:
    """(B, C, T) → (B, C, segment_size) slices at per-item ``starts``
    (reference util.py:165-178)."""
    idx = starts[:, None] + torch.arange(segment_size, device=x.device)[None, :]
    return torch.gather(x, 2, idx[:, None, :].expand(-1, x.shape[1], -1))


def average_pitch(pitch: torch.Tensor, durs: torch.Tensor) -> torch.Tensor:
    """Mean of the nonzero pitch frames of each text token: pitch
    (B, n, T_mel), durations (B, T_text) → (B, n, T_text). The same math as
    ``xva_trainer_tpu/models/fastpitch/model.py::average_pitch``, which the v3
    step uses for its pitch target."""
    ends = torch.cumsum(durs, dim=1).long()
    starts = F.pad(ends[:, :-1], (1, 0))
    nz_cums = F.pad(torch.cumsum((pitch != 0.0).float(), dim=2), (1, 0))
    cums = F.pad(torch.cumsum(pitch, dim=2), (1, 0))
    last = cums.shape[-1] - 1
    n = pitch.shape[1]
    ends_c = ends.clamp(0, last)[:, None, :].expand(-1, n, -1)
    starts_c = starts.clamp(0, last)[:, None, :].expand(-1, n, -1)
    sums = torch.gather(cums, 2, ends_c) - torch.gather(cums, 2, starts_c)
    nelems = torch.gather(nz_cums, 2, ends_c) - torch.gather(nz_cums, 2, starts_c)
    return torch.where(nelems == 0.0, torch.zeros_like(sums), sums / torch.clamp(nelems, min=1.0))


def _generate_path(durs: torch.Tensor, x_mask: torch.Tensor, max_frames: int) -> torch.Tensor:
    """durations (B, T_text) → monotonic path (B, T_text, max_frames)
    (reference util.py generate_path)."""
    cum = torch.cumsum(durs, dim=1)
    prev = torch.nn.functional.pad(cum[:, :-1], (1, 0))
    frames = torch.arange(max_frames, device=durs.device)[None, None, :]
    path = (frames >= prev[:, :, None]) & (frames < cum[:, :, None])
    return path.float() * x_mask[:, :, None]


class XVAPitch(nn.Module):
    def __init__(self, cfg: XVAPitchConfig = XVAPitchConfig()):
        super().__init__()
        c = self.cfg = cfg
        latent, lang = c.latent_size, c.lang_emb_dim
        self.emb_l = nn.Embedding(c.num_languages, lang)
        self.text_encoder = TextEncoder(c.n_vocab, latent, latent, 768, 2, c.text_layers, 3,
                                        language_emb_dim=lang, dropout_p=0.1)
        self.posterior_encoder = PosteriorEncoder(513, latent, latent, 5, 1,
                                                  c.posterior_layers, c.d_vector_dim)
        self.flow = ResidualCouplingBlocks(latent, latent, 5, 1, c.flow_wn_layers,
                                           c.num_flows, c.d_vector_dim)
        # the SDP reads the text encoding, latent + language channels wide
        self.duration_predictor = StochasticDurationPredictor(
            latent + lang, latent, 3, c.sdp_flows, c.d_vector_dim, lang, dropout_p=0.5)
        self.waveform_decoder = HifiganGenerator(HifiganConfig(
            resblock_kernel_sizes=c.resblock_kernel_sizes,
            upsample_rates=c.upsample_rates,
            upsample_kernel_sizes=c.upsample_kernel_sizes,
            upsample_initial_channel=c.upsample_initial_channel,
            in_channels=latent,
            cond_channels=c.d_vector_dim,
            conv_pre_weight_norm=False,
            conv_post_weight_norm=False,
            conv_post_bias=False,
        ))
        if c.pitch:
            self.pitch_predictor = RelativePositioningPitchEnergyEncoder(
                latent + lang, 768, 2, c.pitch_layers, 3, c.d_vector_dim, dropout_p=0.1)
            self.pitch_emb = nn.Conv1d(1, latent, 3, padding=1)
        if c.mltts_rc:
            self.reversal_classifier = ReversalClassifier(latent, latent, c.num_languages)

    # ---------------- training forward ----------------

    def train_step(
        self,
        tokens: torch.Tensor,          # (B, T_text) int
        text_lengths: torch.Tensor,    # (B,)
        linear: torch.Tensor,          # (B, 513, T_spec)
        spec_lengths: torch.Tensor,    # (B,)
        pitch: torch.Tensor,           # (B, 1, T_spec)
        energy: Optional[torch.Tensor],  # (B, T_spec), unused unless cfg.energy
        waveform: torch.Tensor,        # (B, 1, T_spec * hop)
        d_vectors: torch.Tensor,       # (B, 512)
        language_ids: torch.Tensor,    # (B,)
        *,
        noise: Optional[torch.Tensor] = None,     # (B, latent, T_spec) N(0,1)
        dp_noise: Optional[torch.Tensor] = None,  # (B, 2, T_text) N(0,1)
        seg_u: Optional[torch.Tensor] = None,     # (B,) U[0,1)
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        """Generator-side training forward (reference model.py:681-905).

        MAS runs on the stop-gradient prior and posterior stats, under
        ``no_grad``; the duration predictor runs in fp32 with autocast off
        (its spline flows' logdets), on the detached text encoding and
        speaker embedding but the language embedding with its gradient.
        Dropout is active in training mode only. Outputs are channels-first
        except ``lang_prediction`` (B, T_spec, languages)."""
        c = self.cfg
        g = d_vectors
        lang_emb = self.emb_l(language_ids) * c.lang_w  # (B, lang)

        z, m_q, logs_q, y_mask = self.posterior_encoder(linear, spec_lengths, g=g, noise=noise,
                                                        generator=generator)
        x, _, x_mask = self.text_encoder(tokens, text_lengths, lang_emb, generator)
        m_p, logs_p = self.text_encoder.stats(x, x_mask)
        z_p = self.flow(z, y_mask, g=g)

        lang_prediction = None
        if c.mltts_rc:
            lang_prediction = self.reversal_classifier(z_p.transpose(1, 2))
        if c.pitch:
            # condition the prior on ground-truth pitch (reference :758-762)
            z_p = z_p - self.pitch_emb(pitch) * c.pe_scaling

        with torch.no_grad():
            # log N(z_p; m_p, exp(logs_p)) of every (token, frame) pair: four
            # terms, the two products as matrix products (B, T_text, T_spec)
            o_scale = torch.exp(-2.0 * logs_p)  # (B, C, T_text)
            logp1 = torch.sum(-0.5 * math.log(2 * math.pi) - logs_p, dim=1)[:, :, None]
            logp2 = torch.matmul(o_scale.transpose(1, 2), -0.5 * z_p ** 2)
            logp3 = torch.matmul((m_p * o_scale).transpose(1, 2), z_p)
            logp4 = torch.sum(-0.5 * m_p ** 2 * o_scale, dim=1)[:, :, None]
            logp = logp1 + logp2 + logp3 + logp4
            attn_mask = x_mask[:, 0, :, None] * y_mask[:, 0, None, :]
            attn = maximum_path(logp, attn_mask).float()  # (B, T_text, T_spec)
        attn_durations = attn.sum(dim=2)  # (B, T_text)

        with torch.autocast(device_type=x.device.type, enabled=False):
            nll_dur = self.duration_predictor(
                x.float(), x_mask, dr=attn_durations[:, None, :], g=g.detach().float(),
                lang_emb=lang_emb.float(), noise=dp_noise, generator=generator)
        loss_duration = nll_dur / torch.sum(x_mask)

        w_ceil = torch.ceil(attn_durations * x_mask[:, 0])  # (B, T_text)
        pitch_tgt = pitch_pred = None
        if c.pitch:
            pitch_tgt = average_pitch(pitch, w_ceil).detach()  # (B, 1, T_text)
            pitch_pred = self.pitch_predictor(x.detach(), text_lengths, speaker_emb=g,
                                              generator=generator)  # (B, 1, T_text)

        # the prior's stats at frame rate
        m_p_exp = torch.matmul(m_p, attn.to(m_p.dtype))
        logs_p_exp = torch.matmul(logs_p, attn.to(logs_p.dtype))

        z_slice, slice_ids = rand_segments(z, spec_lengths, c.spec_segment_size, u=seg_u,
                                           generator=generator)
        o = self.waveform_decoder(z_slice, g)  # (B, 1, segment * hop)
        wav_seg = segment(waveform, slice_ids * c.hop_length, c.spec_segment_size * c.hop_length)
        return {
            "model_outputs": o,
            "waveform_seg": wav_seg,
            "z": z,
            "z_p": z_p,
            "m_p": m_p_exp,
            "logs_p": logs_p_exp,
            "m_q": m_q,
            "logs_q": logs_q,
            "y_mask": y_mask,
            "x_mask": x_mask,
            "loss_duration": loss_duration,
            "pitch_tgt": pitch_tgt,
            "pitch_pred": pitch_pred,
            "lang_prediction": lang_prediction,
            "attn_durations": attn_durations,
            "slice_ids": slice_ids,
        }

    def train_hifi_only(self, linear, spec_lengths, waveform, d_vectors, *,
                        noise: Optional[torch.Tensor] = None,
                        seg_u: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """The hifi_only stage: posterior → decoder only (reference :649-679)."""
        c = self.cfg
        z, m_q, logs_q, _ = self.posterior_encoder(linear, spec_lengths, g=d_vectors,
                                                   noise=noise, generator=generator)
        z_slice, slice_ids = rand_segments(z, spec_lengths, c.spec_segment_size, u=seg_u,
                                           generator=generator)
        o = self.waveform_decoder(z_slice, d_vectors)
        wav_seg = segment(waveform, slice_ids * c.hop_length, c.spec_segment_size * c.hop_length)
        return {"model_outputs": o, "waveform_seg": wav_seg, "m_q": m_q, "logs_q": logs_q,
                "slice_ids": slice_ids}

    # ---------------- inference ----------------

    @torch.no_grad()
    def infer(
        self,
        tokens: torch.Tensor,        # (B, T_text) int
        d_vector: torch.Tensor,      # (B, 512)
        language_id: torch.Tensor,   # (B,)
        x_lengths: Optional[torch.Tensor] = None,
        *,
        pacing: float = 1.0,
        max_frames: int = 1024,
        noise: Optional[torch.Tensor] = None,     # (B, latent, max_frames) N(0,1)
        dp_noise: Optional[torch.Tensor] = None,  # (B, 2, T_text) N(0,1)
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """text → waveform (reference infer :417-599).

        Returns ``wav`` (B, max_frames*hop), ``y_lengths`` (B,),
        ``durations`` (B, T_text) and ``logw`` (B, T_text)."""
        c = self.cfg
        if x_lengths is None:
            x_lengths = torch.clamp((tokens > 0).sum(dim=1), min=1)
        g = d_vector
        lang_emb = self.emb_l(language_id) * c.lang_w

        x, _, x_mask = self.text_encoder(tokens, x_lengths, lang_emb)
        m_p, logs_p = self.text_encoder.stats(x, x_mask)

        logw = self.duration_predictor.reverse(
            x, x_mask, g=g, lang_emb=lang_emb, noise_scale=c.inference_noise_scale_dp,
            noise=dp_noise, generator=generator)[:, 0]  # (B, T_text)
        w = torch.exp(logw) * x_mask[:, 0] * c.length_scale * pacing
        w_ceil = torch.ceil(w)
        y_lengths = torch.clamp(w_ceil.sum(dim=1).long(), 1, max_frames)
        y_mask = sequence_mask(y_lengths, max_frames)

        attn = _generate_path(w_ceil, x_mask[:, 0], max_frames)  # (B, T_text, F)
        m_p_exp = torch.einsum("btf,bct->bcf", attn, m_p)
        logs_p_exp = torch.einsum("btf,bct->bcf", attn, logs_p)

        if c.pitch:
            pitch_pred = self.pitch_predictor(x, x_lengths, speaker_emb=g)  # (B, 1, T_text)
            pitch_frames = torch.einsum("btf,bct->bcf", attn, pitch_pred)
            pitch_cond = self.pitch_emb(pitch_frames) * c.pe_scaling
        else:
            pitch_cond = 0.0

        if noise is None:
            noise = standard_normal(m_p_exp.shape, m_p_exp, generator)
        z_p = m_p_exp + noise * torch.exp(logs_p_exp) * c.inference_noise_scale
        z_p = z_p + pitch_cond
        z = self.flow(z_p * y_mask, y_mask, g=g, reverse=True)
        wav = self.waveform_decoder(z * y_mask, g)  # (B, 1, F*hop)
        return {"wav": wav[:, 0], "y_lengths": y_lengths, "durations": w_ceil,
                "logw": logw}

    @torch.no_grad()
    def voice_conversion(self, linear: torch.Tensor, spec_lengths: torch.Tensor,
                         src_emb: torch.Tensor, tgt_emb: torch.Tensor, *,
                         noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """posterior(src) → flow forward (src) → flow reverse (tgt) → decode
        (reference :602-622). linear (B, 513, T); returns (B, T*hop)."""

        def norm(e):
            return e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True), min=1e-8)

        g_src, g_tgt = norm(src_emb), norm(tgt_emb)
        z, _, _, y_mask = self.posterior_encoder(linear, spec_lengths, g=g_src,
                                                 noise=noise, generator=generator)
        z_p = self.flow(z, y_mask, g=g_src)
        z_hat = self.flow(z_p, y_mask, g=g_tgt, reverse=True)
        return self.waveform_decoder(z_hat * y_mask, g_tgt)[:, 0]
