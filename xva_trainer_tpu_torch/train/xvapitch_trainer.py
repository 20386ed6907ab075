"""The v3 (xVAPitch) training step and what feeds it.

Counterpart of ``xva_trainer_tpu/train/xvapitch_trainer.py``: the config
fields the step reads, the early-stop targets, ``preprocess_audio``, the
batch's transfer to the card and its spectrogram, the freeze helpers,
``make_v3_step`` and ``make_v3_loss_eval``. The trainer loop around them
(checkpoints, export) is not ported yet.

The step is the reference's per-micro-step generator pass then
discriminator pass (python/xvapitch/xva_train.py:652-706), in two passes:
G forward → D(fake, real) → G loss → G gradients → D on the detached fakes
→ D loss → D gradients → both optimiser steps. The G adversarial term
therefore sees the pre-update D parameters, and the gradients are those of
the JAX package's fused single-backward step (tests/test_fused_gd.py shows
that the two formulations agree). ``torch.autograd.grad`` takes the G
gradients with respect to the generator's parameters only, so no G-loss
gradient ever reaches the discriminator's. The JAX step's ``fused_gd``
switch chooses how XLA lays out one program; the port has one path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..data.audio_io import load_wav, save_wav
from ..models.xvapitch import VitsDiscriminator, XVAPitch
from ..models.xvapitch import losses as v_losses
from ..ops.fused_stft import mel_spectrogram_fused
from ..ops.loudness import normalize_ebu_r128
from ..ops.stft import DEFAULT_MEL
from . import amp
from .optim import GanOptimizer

POST_DEC = ("posterior_encoder", "waveform_decoder")


@dataclasses.dataclass
class XvaTrainConfig:
    """The fields of the JAX package's ``XvaTrainConfig`` that the step and
    its optimisers read (reference xva_train.py and training_util.py)."""

    batch_size: int = 64     # the largest (768-frame) bucket's batch
    target_bs: int = 400     # reference :1142
    gen_lr: float = 1.75e-4
    disc_lr: float = 2e-4
    lr_gamma: float = 0.999875
    weight_decay: float = 0.01
    optimizer: str = "adamw"  # or "lion" (reference --lion: lr/5, wd×5)
    seed: int = 0
    # train only the posterior encoder and the waveform decoder (reference
    # --hifi_only, xva_train.py:649-679)
    hifi_only: bool = False
    # bf16 compute, fp32 masters (train/amp.py); the reference defaults AMP on
    use_amp: bool = True

    @property
    def gam(self) -> int:
        """Micro-steps accumulated per optimiser update (reference :1142)."""
        return max(1, int(math.ceil(self.target_bs / self.batch_size)))


def xva_target_deltas(num_data_lines: int) -> List[float]:
    """reference get_target_delta (:499-518)."""
    nate_delta, nate_numfiles = 0.0002, 8000
    mult = nate_numfiles / (num_data_lines * 1.25)
    if (mult - 1) < 1:
        td = nate_delta * math.sqrt(mult) / 1.5
    else:
        td = nate_delta * math.sqrt(mult - 1) / 1.5
    return [0.04, td * 0.2]


def make_optimizers(model: nn.Module, disc: nn.Module, cfg: XvaTrainConfig):
    """The generator's and the discriminator's optimisers of ``cfg``."""
    kw = dict(weight_decay=cfg.weight_decay, gamma=cfg.lr_gamma, grad_accum=cfg.gam,
              kind=cfg.optimizer)
    return (GanOptimizer(model.parameters(), cfg.gen_lr, **kw),
            GanOptimizer(disc.parameters(), cfg.disc_lr, **kw))


# ---------------- freezes (reference :725-727) ----------------


def module_mask(model: nn.Module, modules: Sequence[str] = POST_DEC) -> List[bool]:
    """Per parameter (in ``model.parameters()`` order): does it belong to one
    of the top-level ``modules``?"""
    return [name.split(".", 1)[0] in modules for name, _ in model.named_parameters()]


def zero_module_grads(grads: Sequence[Optional[torch.Tensor]], mask: Sequence[bool]):
    """Zero the gradients where ``mask`` is True (the stage-1 / priors
    freeze of the posterior encoder and the decoder)."""
    return [None if m else g for g, m in zip(grads, mask)]


def update_mask(model: nn.Module, *, freeze_post_dec: bool, hifi_only: bool) -> List[bool]:
    """Which parameters the generator's update is applied to. Zeroing the
    gradients alone would leave the decoupled weight decay shrinking a frozen
    module, so the updates of frozen modules are dropped too: under
    ``hifi_only`` everything but the posterior encoder and the decoder, under
    ``freeze_post_dec`` exactly those two."""
    post_dec = module_mask(model)
    if hifi_only:
        return post_dec
    if freeze_post_dec:
        return [not m for m in post_dec]
    return [True] * len(post_dec)


# ---------------- the batch ----------------


def materialize_spec(batch: Dict[str, torch.Tensor], hop: int = 256):
    """(linear (B, 513, frames), waveform (B, 1, frames·hop) float) of a batch.

    A host batch (``XvaBatcher`` without ``device_spec``) ships the cached
    linear spectrogram as ``"linear"`` (B, frames, 513), which passes
    through, transposed. A ``device_spec`` batch ships int16 audio
    (B, frames·hop, 1), dequantised as /32767, and no spectrogram: the fused
    STFT kernel computes its linear magnitude on the device with
    ``center=True`` and frames [0, frames) are kept, as the JAX step's
    ``_materialize_spec`` does."""
    wav = batch["wav"]
    wav = wav.float() * (1.0 / 32767.0) if wav.dtype == torch.int16 else wav.float()
    if "linear" in batch:
        return batch["linear"].transpose(1, 2), wav.transpose(1, 2)
    frames = wav.shape[1] // hop
    _, lin = mel_spectrogram_fused(wav[..., 0], DEFAULT_MEL, center=True, return_linear=True)
    return lin[:, :, :frames], wav.transpose(1, 2)


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A collated numpy batch → tensors on ``device``: the one-card
    counterpart of the JAX package's ``parallel/mesh.py::shard_batch``, and
    like it the ``Prefetcher``'s transform, so it runs on the worker thread.

    ``"ids"`` (names, for the loss sorting) stays behind; int32 index arrays
    become int64. The copies start from pinned memory without blocking, on
    the device's default stream, the stream the training step runs on: the
    step queued after them waits for them, and the caching host allocator
    does not hand a pinned buffer out again before its copy has finished."""
    dev = torch.device(device)
    out = {}
    on_card = dev.type == "cuda"
    with torch.cuda.stream(torch.cuda.default_stream(dev)) if on_card else contextlib.nullcontext():
        for k, v in batch.items():
            if k == "ids":
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            if on_card:
                t = t.pin_memory().to(dev, non_blocking=True)
            out[k] = t.long() if t.dtype == torch.int32 else t
    return out


def preprocess_audio(dataset_path: str, progress=None) -> int:
    """EBU R128 loudness normalisation of ``wavs/`` into
    ``wavs_postprocessed/`` before training (reference xva_train.py
    preprocess_audio:1368-1390, which runs the audio_norm tool). Files
    already there are kept. Returns the number of wavs that have one."""
    wav_dir = os.path.join(dataset_path, "wavs")
    out_dir = os.path.join(dataset_path, "wavs_postprocessed")
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(wav_dir) if f.endswith(".wav"))
    done = 0
    for i, f in enumerate(files):
        dst = os.path.join(out_dir, f)
        if os.path.exists(dst):
            done += 1
            continue
        y, sr = load_wav(os.path.join(wav_dir, f))
        save_wav(dst, normalize_ebu_r128(y, sr), sr)
        done += 1
        if progress:
            progress(i + 1, len(files))
    return done


# ---------------- the step ----------------


def finite_or_zero(grads: Sequence[Optional[torch.Tensor]], loss: torch.Tensor):
    """The NaN guard: the gradients, zeroed in place where ``loss`` is not
    finite. Decided on the device, so the step never waits for the loss."""
    bad = ~torch.isfinite(loss)
    return [None if g is None else g.masked_fill_(bad, 0.0) for g in grads]


def _forward(model: XVAPitch, batch, linear, wav, hifi_only: bool, *, noise, dp_noise, seg_u,
             generator):
    if hifi_only:
        return model.train_hifi_only(linear, batch["slens"], wav, batch["dvec"], noise=noise,
                                     seg_u=seg_u, generator=generator)
    return model.train_step(batch["tokens"], batch["tlens"], linear, batch["slens"],
                            batch["pitch"], batch.get("energy"), wav, batch["dvec"],
                            batch["lang"], noise=noise, dp_noise=dp_noise, seg_u=seg_u,
                            generator=generator)


def make_v3_step(model: XVAPitch, disc: VitsDiscriminator, g_opt: GanOptimizer,
                 d_opt: GanOptimizer, freeze_post_dec: bool, hifi_only: bool = False,
                 use_amp: bool = True) -> Callable[..., Dict[str, torch.Tensor]]:
    """One micro-step: G loss and gradients, D loss and gradients on the
    detached fakes, both optimiser steps (which accumulate ``gam``
    micro-steps). Updates ``model``, ``disc`` and both optimisers in place.

    ``step(batch, generator=None, *, noise=None, dp_noise=None, seg_u=None)``
    returns the losses (fp32 tensors). The posterior's noise, the SDP's
    noise and the segment draw are the given tensors or come from
    ``generator``, which also draws the dropout masks when the model is in
    training mode.

    - NaN guard: a non-finite G (D) loss zeroes the G (D) gradients, and the
      optimiser still steps: its moments and count advance, and the weight
      decay applies, as in the JAX step.
    - Freezes: ``freeze_post_dec`` zeroes the gradients of the posterior
      encoder and the decoder and drops their updates; ``hifi_only`` drops
      the updates of everything else (and overrides ``freeze_post_dec``,
      which would otherwise leave nothing to train).
    - ``use_amp``: bf16 autocast around both models' forwards, the duration
      predictor in fp32, every loss in fp32.
    """
    g_params = list(model.parameters())
    d_params = list(disc.parameters())
    post_dec = module_mask(model)
    g_apply = update_mask(model, freeze_post_dec=freeze_post_dec, hifi_only=hifi_only)
    zero_post_dec = freeze_post_dec and not hifi_only
    hop = model.cfg.hop_length

    def step(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None, *,
             noise=None, dp_noise=None, seg_u=None) -> Dict[str, torch.Tensor]:
        dev = g_params[0].device
        linear, wav = materialize_spec(batch, hop)
        with amp.autocast(dev, use_amp):
            out = _forward(model, batch, linear, wav, hifi_only, noise=noise,
                           dp_noise=dp_noise, seg_u=seg_u, generator=generator)
            s_fake, f_fake, _, f_real = disc(out["model_outputs"], out["waveform_seg"])
        out = amp.to_fp32(out)
        g_loss, meta = v_losses.generator_loss(
            out, amp.to_fp32(s_fake), amp.to_fp32(f_fake), amp.to_fp32(f_real),
            language_ids=batch["lang"], spec_lengths=batch["slens"], hifi_only=hifi_only)
        g_grads = list(torch.autograd.grad(g_loss, g_params, allow_unused=True))

        with amp.autocast(dev, use_amp):
            s_fake_d, _, s_real_d, _ = disc(out["model_outputs"].detach(),
                                            out["waveform_seg"].detach())
        d_loss, _ = v_losses.discriminator_loss(amp.to_fp32(s_real_d), amp.to_fp32(s_fake_d))
        d_grads = list(torch.autograd.grad(d_loss, d_params, allow_unused=True))

        g_grads = finite_or_zero(g_grads, g_loss)
        if zero_post_dec:
            g_grads = zero_module_grads(g_grads, post_dec)
        g_opt.step(g_grads, g_apply)
        d_opt.step(finite_or_zero(d_grads, d_loss))
        meta = {k: v.detach() for k, v in meta.items()}
        meta["loss_disc"] = d_loss.detach()
        return meta

    return step


def make_v3_loss_eval(model: XVAPitch, use_amp: bool = True):
    """No-grad per-sample loss (mel + kl + pitch, the loss-sorting key) of a
    batch, to seed the loss-sorted sampler before training (reference
    init_data_losses, xva_train.py:1248-1316). Dropout follows the model's
    mode. ``eval_losses(batch, generator=None, *, noise, dp_noise, seg_u)``
    → (B,)."""
    hop = model.cfg.hop_length

    @torch.no_grad()
    def eval_losses(batch, generator: Optional[torch.Generator] = None, *, noise=None,
                    dp_noise=None, seg_u=None) -> torch.Tensor:
        dev = next(model.parameters()).device
        linear, wav = materialize_spec(batch, hop)
        with amp.autocast(dev, use_amp):
            out = _forward(model, batch, linear, wav, False, noise=noise, dp_noise=dp_noise,
                           seg_u=seg_u, generator=generator)
        out = amp.to_fp32(out)
        per = v_losses.mel_l1(out["waveform_seg"][:, 0], out["model_outputs"][:, 0])
        per = per.sum(dim=(1, 2)) * v_losses.MEL_LOSS_ALPHA
        _, per_kl = v_losses.kl_loss(out["z_p"], out["logs_q"], out["m_p"], out["logs_p"],
                                     out["y_mask"])
        per = per + per_kl
        if out.get("pitch_pred") is not None:
            diff = (out["pitch_tgt"][:, 0] - out["pitch_pred"][:, 0]) ** 2
            per = per + (diff * out["x_mask"][:, 0]).sum(dim=1)
        return per

    return eval_losses
