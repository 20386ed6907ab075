"""FastPitch's staged losses in PyTorch.

Counterpart of ``xva_trainer_tpu/models/fastpitch/loss.py`` (reference
loss_function.py:51-168, attn_loss_function.py:20-54; trainer scales
xva_train.py:702-708): stage 1 the aligner's CTC plus the KL binarization
term, stage 2 the log-duration MSE, stage 3 pitch and energy MSE (plus the
mel MSE), stage 4 the mel MSE over the nonzero target.

The CTC is JAX's ``optax.ctc_loss`` on the aligner's log-probabilities with
a blank column of -1 and padded keys at -1e9, averaged over all B rows,
padding rows included. Where an item has an alignment (``mel_len >=
in_len``) ``F.ctc_loss`` gives optax's value; where it has none, optax gives
a large finite value (its ``log_epsilon`` of -1e5 stands for log 0) and
``F.ctc_loss`` gives inf, which would trip the NaN guard where JAX takes the
step. A batch with such an item therefore goes through ``ctc_loss_optax``,
optax's forward recursion in plain torch, for every item.

Under data parallelism each stage's loss takes the data ``group``: the
masked sums divide by the global mask's sum, and the CTC's mean over the
rows is the local mean over the group's size, so that the terms summed over
the group are the global batch's loss. With no group nothing changes.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...parallel.mesh import global_sum, group_size

DUR_SCALE = 0.1
PITCH_SCALE = 0.1
ENERGY_SCALE = 0.1
ATTN_SCALE = 1.0
KL_WARMUP_EPOCHS = 100.0
BLANK_LOGPROB = -1.0
LOG_EPSILON = -1e5  # optax.ctc_loss's stand-in for log 0


def _len_mask(lens, max_len):
    return (torch.arange(max_len, device=lens.device)[None, :] < lens[:, None]).float()


def _ctc_logits(attn_logprob, in_lens):
    """(B, T_mel, T_text + 1): the blank column (-1) first, the keys past
    ``in_len`` at -1e9."""
    logits = F.pad(attn_logprob, (1, 0), value=BLANK_LOGPROB)
    t1 = logits.shape[-1]
    key_valid = torch.arange(t1, device=logits.device)[None, None, :] <= in_lens[:, None, None]
    return torch.where(key_valid, logits, -1e9)


def ctc_loss_optax(logprobs, logit_paddings, label_paddings) -> torch.Tensor:
    """Per-item negative log-likelihood of the labels 1..N (no repeats; blank
    0) as ``optax.ctc_loss_with_forward_probs`` computes it: log 0 as -1e5,
    padded frames carrying their state, the last epsilon transition after
    the last frame. logprobs (B, T, N+1) log-softmaxed; paddings 1.0 where
    padded."""
    B, T, _ = logprobs.shape
    N = label_paddings.shape[1]
    labellens = N - label_paddings.sum(dim=1).to(torch.long)
    emit = logprobs[:, :, 1:]  # (B, T, N): label n is class n + 1
    phi_lp = logprobs[:, :, :1]  # (B, T, 1)
    # no label repeats: repeat is 0 but for the pad column optax appends
    phi = torch.full((B, N + 1), LOG_EPSILON, device=logprobs.device, dtype=logprobs.dtype)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=1)
    em = torch.full((B, N), LOG_EPSILON, device=logprobs.device, dtype=logprobs.dtype)
    no_rep = LOG_EPSILON  # log_epsilon * (1 - repeat), repeat 0
    for t in range(T):
        prev_phi_orig = phi
        prev_phi = torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], em)], dim=1)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + emit[:, t], em + emit[:, t])
        next_phi = prev_phi + phi_lp[:, t]
        next_phi = torch.cat([next_phi[:, :1],
                              torch.logaddexp(next_phi[:, 1:], em + phi_lp[:, t] + no_rep)], dim=1)
        pad = logit_paddings[:, t:t + 1]
        em = pad * em + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], em)], dim=1)
    return -last.gather(1, labellens[:, None])[:, 0]


def attention_ctc_loss(attn_logprob, in_lens, out_lens,
                       all_aligned: Optional[bool] = None, group=None) -> torch.Tensor:
    """The aligner's monotonic CTC, averaged over all B rows.

    attn_logprob (B, T_mel, T_text); the labels of item b are 1..in_lens[b].
    ``all_aligned``: whether every item has ``out_len >= in_len``, known on
    the host (None: read from the lengths, which waits for the device)."""
    B, T_mel, T_text = attn_logprob.shape
    logprobs = F.log_softmax(_ctc_logits(attn_logprob, in_lens), dim=-1)
    if all_aligned is None:
        all_aligned = bool((out_lens >= in_lens).all())
    if all_aligned:
        targets = torch.arange(1, T_text + 1, device=logprobs.device).expand(B, T_text)
        per_item = F.ctc_loss(logprobs.transpose(0, 1), targets, out_lens.long(),
                              in_lens.long(), blank=0, reduction="none", zero_infinity=False)
    else:
        per_item = ctc_loss_optax(logprobs, 1.0 - _len_mask(out_lens, T_mel),
                                  1.0 - _len_mask(in_lens, T_text))
    w = group_size(group)
    return per_item.mean() / w if w > 1 else per_item.mean()


def attention_binarization_loss(attn_hard, attn_soft, eps=1e-12, group=None):
    """-mean log soft-prob under the hard path (attn_loss_function.py:47-54)."""
    sel = torch.log(torch.clamp(attn_soft, min=eps)) * attn_hard
    return -sel.sum() / torch.clamp(global_sum(attn_hard.sum(), group), min=1.0)


def stage1_loss(out, in_lens, out_lens, kl_weight, all_aligned: Optional[bool] = None,
                group=None):
    attn_loss = attention_ctc_loss(out["attn_logprob"], in_lens, out_lens, all_aligned, group)
    bin_loss = attention_binarization_loss(out["attn_hard"], out["attn_soft"], group=group)
    loss = attn_loss * ATTN_SCALE + kl_weight * bin_loss
    return loss, {"loss": loss, "attn_loss": attn_loss, "kl_loss": bin_loss * kl_weight}


def stage2_loss(out, in_lens, group=None):
    dur_mask = _len_mask(in_lens, out["log_dur_pred"].shape[1])
    log_dur_tgt = torch.log(out["durations"].float() + 1.0)
    mse = (out["log_dur_pred"] - log_dur_tgt) ** 2
    dur_loss = (mse * dur_mask).sum() / torch.clamp(global_sum(dur_mask.sum(), group), min=1.0)
    loss = dur_loss * DUR_SCALE
    return loss, {"loss": loss, "duration_predictor_loss": dur_loss}


def stage3_loss(out, mel_tgt, in_lens, group=None):
    """Pitch and energy MSE, plus the mel MSE (the reference logs stage 3's)."""
    mel_loss = _mel_mse(out["mel_out"], mel_tgt, group)
    dur_mask = _len_mask(in_lens, out["pitch_pred"].shape[1])
    denom = torch.clamp(global_sum(dur_mask.sum(), group), min=1.0)
    pitch_loss = ((out["pitch_pred"][..., 0] - out["pitch_tgt"][:, 0, :]) ** 2
                  * dur_mask).sum() / denom
    energy_loss = ((out["energy_pred"] - out["energy_tgt"]) ** 2 * dur_mask).sum() / denom
    loss = mel_loss + pitch_loss * PITCH_SCALE + energy_loss * ENERGY_SCALE
    return loss, {"loss": loss, "mel_loss": mel_loss, "pitch_loss": pitch_loss,
                  "energy_loss": energy_loss}


def stage4_loss(out, mel_tgt, group=None):
    mel_loss = _mel_mse(out["mel_out"], mel_tgt, group)
    return mel_loss, {"loss": mel_loss, "mel_loss": mel_loss}


def _mel_mse(mel_out, mel_tgt, group=None):
    """MSE over the nonzero target (reference loss_function.py:105-112);
    (B, T_mel, n_mel) channels-last."""
    mel_mask = (mel_tgt != 0).float()
    mse = (mel_out - mel_tgt) ** 2 * mel_mask
    return mse.sum() / torch.clamp(global_sum(mel_mask.sum(), group), min=1.0)
