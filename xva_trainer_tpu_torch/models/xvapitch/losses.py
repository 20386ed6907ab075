"""xVAPitch losses (reference python/xvapitch/losses.py), in fp32.

Counterpart of ``xva_trainer_tpu/models/xvapitch/losses.py``:
VitsGeneratorLoss (:18-324) is the mel L1 ×45 on the Tacotron-style 0-8 kHz
log-mel, the KL normalised by Σz_mask, feature matching ×2, the LSGAN
generator term, the duration NLL, the pitch MSE (/B ×0.1) and the language
CE, plus the per-sample mel, KL and pitch terms that the loss-sorted
resampling reads; VitsDiscriminatorLoss (:323-351) is the LSGAN.

Under data parallelism each loss takes the data ``group``: a term normalised
by a sum over the batch (the KL's Σz_mask, the language CE's mask, the
duration's and the pitch's Σx_mask, the pitch's B) divides this rank's
numerator by the global sum, and a plain mean over the batch (mel L1,
feature matching, LSGAN) is the local mean over the group's size. Summed
over the group, the terms are the global batch's loss, and so are the
summed gradients. With no group nothing changes.

The generated side of the mel loss needs its gradient and goes through the
differentiable ``ops/stft.py`` (``torch.fft.rfft``); the real side carries
no gradient and goes through the fused STFT kernel (its plain version on the
CPU), which computes the same function.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ...ops.fused_stft import mel_spectrogram_fused
from ...ops.stft import DEFAULT_MEL, mel_spectrogram
from ...parallel.mesh import global_sum, group_size
from ..hifigan.models import discriminator_loss as lsgan_discriminator_loss
from ..hifigan.models import feature_matching_loss
from ..hifigan.models import generator_adv_loss as lsgan_generator_loss

MEL_LOSS_ALPHA = 45.0
PITCH_LOSS_SCALE = 0.1


def mel_l1(wav: torch.Tensor, wav_hat: torch.Tensor) -> torch.Tensor:
    """|mel(wav) - mel(wav_hat)| of (B, N) waveforms, (B, 80, frames): the
    real side through the fused kernel, the generated side differentiable."""
    with torch.no_grad():
        mel = mel_spectrogram_fused(wav.float().contiguous(), DEFAULT_MEL, center=True)
    return torch.abs(mel - mel_spectrogram(wav_hat.float(), DEFAULT_MEL))


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask, group=None):
    """Prior/posterior KL (reference :88-104). All (B, C, T); z_mask
    (B, 1, T). Returns (scalar loss, per-sample sums); normalised by the
    frame count Σz_mask only, not frames × channels (reference :103)."""
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * (z_p - m_p) ** 2 * torch.exp(-2.0 * logs_p)
    per_sample = (kl * z_mask).sum(dim=(1, 2))
    return per_sample.sum() / torch.clamp(global_sum(z_mask.sum(), group), min=1.0), per_sample


def language_prediction_loss(lang_prediction, language_ids, spec_lengths, group=None):
    """Masked CE over z_p frames; lang_prediction (B, T, languages)."""
    B, T, L = lang_prediction.shape
    mask = (torch.arange(T, device=lang_prediction.device)[None, :]
            < spec_lengths[:, None]).float()
    logp = F.log_softmax(lang_prediction.float(), dim=-1)
    tgt = F.one_hot(language_ids.long(), L).float()[:, None, :]
    ce = -(logp * tgt).sum(-1) * mask
    return ce.sum() / torch.clamp(global_sum(mask.sum(), group), min=1.0)


def generator_loss(outputs: Dict, scores_disc_fake, feats_disc_fake, feats_disc_real,
                   language_ids=None, spec_lengths=None, *, hifi_only: bool = False,
                   group=None):
    """Total generator loss and its components (and the per-sample terms);
    this rank's share of the global batch's loss under a data ``group``."""
    w = group_size(group)
    l1 = mel_l1(outputs["waveform_seg"][:, 0], outputs["model_outputs"][:, 0])
    loss_mel = l1.mean() * MEL_LOSS_ALPHA
    loss_gen = lsgan_generator_loss(scores_disc_fake)
    loss_feat = feature_matching_loss(feats_disc_real, feats_disc_fake)
    if w > 1:
        loss_mel, loss_gen, loss_feat = loss_mel / w, loss_gen / w, loss_feat / w
    meta = {"loss_mel": loss_mel, "loss_gen": loss_gen, "loss_feat": loss_feat,
            "per_sample_mel": l1.sum(dim=(1, 2)) * MEL_LOSS_ALPHA}
    if hifi_only:
        total = loss_mel + loss_gen + loss_feat
        meta["loss"] = total
        return total, meta

    o = {k: (v.float() if torch.is_tensor(v) and v.is_floating_point() else v)
         for k, v in outputs.items()}
    loss_kl, per_sample_kl = kl_loss(o["z_p"], o["logs_q"], o["m_p"], o["logs_p"],
                                     o["y_mask"], group)
    loss_duration = torch.sum(o["loss_duration"])
    if group is not None:  # the model's NLL over Σx_mask, made global
        x_sum = o["x_mask"].sum()
        loss_duration = loss_duration * (x_sum / global_sum(x_sum, group))

    loss_pitch = torch.zeros((), device=loss_mel.device)
    if o.get("pitch_pred") is not None:
        mask = o["x_mask"][:, 0]  # (B, T_text)
        diff = (o["pitch_tgt"][:, 0] - o["pitch_pred"][:, 0]) ** 2 * mask
        meta["per_sample_pitch"] = diff.sum(dim=1)
        loss_pitch = diff.sum() / torch.clamp(global_sum(mask.sum(), group), min=1.0)
        loss_pitch = loss_pitch / (diff.shape[0] * w) * PITCH_LOSS_SCALE

    lang_loss = torch.zeros((), device=loss_mel.device)
    if o.get("lang_prediction") is not None:
        lang_loss = language_prediction_loss(o["lang_prediction"], language_ids, spec_lengths,
                                             group)

    total = loss_mel + loss_gen + loss_feat + loss_kl + loss_duration + loss_pitch + lang_loss
    meta.update(loss=total, loss_kl=loss_kl, loss_duration=loss_duration,
                loss_pitch=loss_pitch, lang_pred_loss=lang_loss, per_sample_kl=per_sample_kl)
    return total, meta


def discriminator_loss(scores_real, scores_fake, group=None):
    loss = lsgan_discriminator_loss(scores_real, scores_fake) / group_size(group)
    return loss, {"loss_disc": loss}
