"""The v3 (xVAPitch) trainer: its step, the loop around it, checkpoints and
export.

Counterpart of ``xva_trainer_tpu/train/xvapitch_trainer.py``: the config,
the early-stop targets, ``preprocess_audio``, the batch's transfer to the
card and its spectrogram, the freeze helpers, ``make_v3_step``,
``make_v3_loss_eval`` and ``XVAPitchTrainer`` (setup, resume and warm
start, the loss-seeding pass, the finetune/priors batch stream, the loop
with its stage 1 → 2 → end schedule, rolling checkpoints, previews and the
xVASynth export), and ``pre_cache_g2p``, which warms the multilingual text
front end's g2p caches before a cache build.

The step is the reference's per-micro-step generator pass then
discriminator pass (python/xvapitch/xva_train.py:652-706), in two passes:
G forward → D(fake, real) → G loss → G gradients → D on the detached fakes
→ D loss → D gradients → both optimiser steps. The G adversarial term
therefore sees the pre-update D parameters, and the gradients are those of
the JAX package's fused single-backward step (tests/test_fused_gd.py shows
that the two formulations agree). ``torch.autograd.grad`` takes the G
gradients with respect to the generator's parameters only, so no G-loss
gradient ever reaches the discriminator's. The JAX config's ``fused_gd``
switch chooses how XLA lays out one program; the port has one step, so the
field is left out of its config.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from .. import resolve_device
from ..data.audio_io import load_wav, save_wav
from ..data.prefetch import Prefetcher, batch_to_device
from ..data.xva_dataset import XvaBatcher, lang_to_id
from ..models.xvapitch import VitsDiscriminator, XVAPitch, XVAPitchConfig
from ..models.xvapitch import losses as v_losses
from ..ops.fused_stft import mel_spectrogram_fused
from ..ops.loudness import normalize_ebu_r128
from ..ops.stft import DEFAULT_MEL
from ..parallel.distributed import broadcast_from_host0
from ..parallel.draws import shard_draws
from ..parallel.mesh import (Mesh, all_gather_rows, all_reduce_sum, commit_replicated,
                             make_mesh, shard_batch)
from . import amp
from .checkpoints import CheckpointManager, export_xvapitch_v3
from .metrics import GraphsWriter, ThroughputMeter, TrainingLogger, make_tensorboard
from .optim import GanOptimizer

POST_DEC = ("posterior_encoder", "waveform_decoder")


@dataclasses.dataclass
class XvaTrainConfig:
    """The JAX package's ``XvaTrainConfig``, field for field and default for
    default, but ``fused_gd`` (an XLA program layout; the port has one step)."""

    output_dir: str = "out_v3"
    batch_size: int = 64     # the largest (768-frame) bucket's batch
    target_bs: int = 400     # reference :1142
    gen_lr: float = 1.75e-4
    disc_lr: float = 2e-4
    lr_gamma: float = 0.999875
    weight_decay: float = 0.01
    optimizer: str = "adamw"  # or "lion" (reference --lion: lr/5, wd×5)
    save_step: int = 50      # optimiser updates between checkpoints
    finetune_weight: int = 20  # finetune updates per priors update (:314, 882-886)
    do_loss_sorting: bool = True
    # a no-grad pass before training to seed the loss-sorted sampler
    # (reference init_data_losses :1248-1316)
    seed_loss_sorting: bool = True
    seed: int = 0
    patience: int = 3
    # train only the posterior encoder and the waveform decoder (reference
    # --hifi_only, xva_train.py:649-679)
    hifi_only: bool = False
    # bf16 compute, fp32 masters (train/amp.py); the reference defaults AMP on
    use_amp: bool = True
    # ship int16 audio and compute the linear spectrogram on the card
    # (materialize_spec)
    device_spec: bool = True

    @property
    def gam(self) -> int:
        """ceil(target_bs / batch_size), as the JAX config has it. The
        trainer's own ``gam`` divides by the batcher's mean batch instead."""
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


def make_optimizers(model: nn.Module, disc: nn.Module, cfg: XvaTrainConfig, grad_accum: int):
    """The generator's and the discriminator's optimisers of ``cfg``, each
    accumulating ``grad_accum`` micro-steps per update (the trainer's
    ``gam``)."""
    kw = dict(weight_decay=cfg.weight_decay, gamma=cfg.lr_gamma, grad_accum=grad_accum,
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


def pre_cache_g2p(dataset_paths, lang: str = "en",
                  text_base_dir: Optional[str] = None) -> int:
    """Run every metadata line through the language's preprocessor once, so
    that the user's on-disk g2p cache is warm before the cache build
    (reference dataset.py pre_cache_g2p:687-721). The preprocessor's base
    directory is ``text_base_dir``, else ``XVA_TEXT_DIR``; with neither a
    directory, nothing runs. Returns the lines tokenized."""
    from ..data.dataset import read_metadata
    from ..data.text.preprocessing import get_text_preprocessor

    text_base_dir = text_base_dir or os.environ.get("XVA_TEXT_DIR")
    if not text_base_dir or not os.path.isdir(text_base_dir):
        return 0
    tp = get_text_preprocessor(lang, text_base_dir)
    n = 0
    for d in ([dataset_paths] if isinstance(dataset_paths, str) else dataset_paths):
        for it in read_metadata(d):
            tp.text_to_sequence(it.text)
            n += 1
    if tp._g2p_cache_dirty:
        tp.save_g2p_cache()
    return n


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


def data_shard(mesh: Optional[Mesh]):
    """(data group, slice index, slice count) of a mesh; (None, 0, 1) for no
    mesh or a data axis of 1."""
    if mesh is None or mesh.n_data == 1:
        return None, 0, 1
    return mesh.data_group, mesh.data_index, mesh.n_data


def _rows(t: Optional[torch.Tensor], index: int, count: int):
    """Slice ``index`` of ``count`` of a global-batch draw's rows."""
    if t is None or count == 1:
        return t
    b = t.shape[0] // count
    return t[index * b:(index + 1) * b]


def sum_over_data(grads: Sequence[Optional[torch.Tensor]], group) -> None:
    """Sum the gradients over the data group in place, as one flat bucket
    (the Nones, which every rank has alike, stay out)."""
    if group is not None:
        all_reduce_sum([g for g in grads if g is not None], group)


def global_losses(meta: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """``meta`` detached, its scalars summed over the data group in one
    all-reduce (each rank's share of a loss → the global batch's loss); the
    per-sample vectors stay this rank's."""
    meta = {k: v.detach() for k, v in meta.items()}
    if group is not None:
        scalars = {k: v.float().clone() for k, v in meta.items() if v.dim() == 0}
        all_reduce_sum(list(scalars.values()), group)
        meta.update(scalars)
    return meta


def make_v3_step(model: XVAPitch, disc: VitsDiscriminator, g_opt: GanOptimizer,
                 d_opt: GanOptimizer, freeze_post_dec: bool, hifi_only: bool = False,
                 use_amp: bool = True,
                 mesh: Optional[Mesh] = None) -> Callable[..., Dict[str, torch.Tensor]]:
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
    - ``mesh`` with a data axis of W > 1: the batch is this rank's slice of
      the global batch. Every draw is made for the global batch from the
      same generator state on every rank and sliced (given draws are the
      global batch's too), the losses are this rank's shares of the global
      batch's, the gradients are summed over the data group (one flat bucket
      a model) before the NaN guard, and the guard and the returned losses
      read the global losses, so that every rank skips together. The
      per-sample terms stay this rank's. The models are not wrapped in
      ``DistributedDataParallel``: the step takes its gradients with
      ``torch.autograd.grad``, which fires no DDP hook.
    """
    group, index, count = data_shard(mesh)
    g_params = list(model.parameters())
    d_params = list(disc.parameters())
    post_dec = module_mask(model)
    g_apply = update_mask(model, freeze_post_dec=freeze_post_dec, hifi_only=hifi_only)
    zero_post_dec = freeze_post_dec and not hifi_only
    hop = model.cfg.hop_length

    def step(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None, *,
             noise=None, dp_noise=None, seg_u=None) -> Dict[str, torch.Tensor]:
        dev = g_params[0].device
        generator = shard_draws(generator, index, count)
        noise, dp_noise, seg_u = (_rows(t, index, count) for t in (noise, dp_noise, seg_u))
        linear, wav = materialize_spec(batch, hop)
        with amp.autocast(dev, use_amp):
            out = _forward(model, batch, linear, wav, hifi_only, noise=noise,
                           dp_noise=dp_noise, seg_u=seg_u, generator=generator)
            s_fake, f_fake, _, f_real = disc(out["model_outputs"], out["waveform_seg"])
        out = amp.to_fp32(out)
        g_loss, meta = v_losses.generator_loss(
            out, amp.to_fp32(s_fake), amp.to_fp32(f_fake), amp.to_fp32(f_real),
            language_ids=batch["lang"], spec_lengths=batch["slens"], hifi_only=hifi_only,
            group=group)
        g_grads = list(torch.autograd.grad(g_loss, g_params, allow_unused=True))

        with amp.autocast(dev, use_amp):
            s_fake_d, _, s_real_d, _ = disc(out["model_outputs"].detach(),
                                            out["waveform_seg"].detach())
        d_loss, _ = v_losses.discriminator_loss(amp.to_fp32(s_real_d), amp.to_fp32(s_fake_d),
                                                group=group)
        d_grads = list(torch.autograd.grad(d_loss, d_params, allow_unused=True))

        meta["loss_disc"] = d_loss
        meta = global_losses(meta, group)
        sum_over_data(g_grads, group)
        sum_over_data(d_grads, group)
        g_grads = finite_or_zero(g_grads, meta["loss"])
        if zero_post_dec:
            g_grads = zero_module_grads(g_grads, post_dec)
        g_opt.step(g_grads, g_apply)
        d_opt.step(finite_or_zero(d_grads, meta["loss_disc"]))
        return meta

    return step


def make_v3_loss_eval(model: XVAPitch, use_amp: bool = True):
    """No-grad per-sample loss (mel + kl + pitch, the loss-sorting key) of a
    batch, to seed the loss-sorted sampler before training (reference
    init_data_losses, xva_train.py:1248-1316). Dropout follows the model's
    mode. ``eval_losses(batch, generator=None, *, noise, dp_noise, seg_u)``
    → (B,). A data-parallel rank passes its ``ShardDraws`` as the generator
    (``parallel/draws.py``) and gets its own rows."""
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


# ---------------- the trainer ----------------


class XVAPitchTrainer:
    """The v3 fine-tune: ``XVAPitchTrainer(...).setup()`` → ``.train()`` →
    ``.export()``, as the JAX server's v3 flow and ``cli.py train-v3`` drive
    the JAX trainer.

    The schedule is the JAX trainer's (reference xva_train.py):
    - ``gam`` = ceil(target_bs / the batcher's mean batch) micro-steps per
      optimiser update (:1142; the buckets scale the batch);
    - stage 1 and priors batches freeze the posterior encoder and the
      decoder (:725-727); finetune and priors batches alternate,
      ``finetune_weight`` updates to one (:314, 882-886);
    - every ``save_step`` updates: the mean disc loss, the 10-wide window of
      its relative drops against ``xva_target_deltas``, patience, stage
      1 → 2 → end (:782-858), and a checkpoint;
    - the loss-sorted resampling at each epoch's end (:665-668), seeded by
      a no-grad pass before training (:1248-1316).

    The model and discriminator are made here, on ``device``, from
    ``cfg.seed`` (the optimisers and the two steps hold their parameters, as
    the JAX trainer makes its steps here); ``setup`` resumes or warm-starts
    them. Every draw comes from an explicit ``torch.Generator``: the step's,
    seeded ``cfg.seed + 100`` at each ``train()`` call (so a resumed run does
    not replay the draws an unbroken one would have made, as in JAX), the
    seeding pass's (``cfg.seed + 999``) and one per preview sample.

    ``mesh`` (``parallel/mesh.py``; default ``make_mesh()``, the 1 × 1 mesh
    of one process) spreads the batch over its data axis, as the JAX
    trainer's does: the batchers' ``batch_divisor`` is the data axis; every
    rank runs the same batchers from the same seed and takes its slice in
    the prefetcher's transform (``shard_batch``); the step sums the
    gradients over the data group; the loss sorting gathers every rank's
    per-sample losses, so every rank resamples alike; the early stop reads
    the global losses only. Only rank 0 writes checkpoints, logs, graphs,
    TensorBoard, previews and the export; a resume loads on rank 0 and
    reaches the other ranks through ``broadcast_from_host0``. One process
    with no group runs exactly as without a mesh.
    """

    def __init__(
        self,
        batcher: XvaBatcher,
        cfg: XvaTrainConfig,
        model_cfg: XVAPitchConfig = XVAPitchConfig(),
        logger: Optional[TrainingLogger] = None,
        priors_batcher: Optional[XvaBatcher] = None,
        device="cuda",
        mesh: Optional[Mesh] = None,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh or make_mesh()
        self.is_main = self.mesh.is_main
        self.batcher = batcher
        self.priors_batcher = priors_batcher
        self.cfg = cfg
        for b_ in (batcher, priors_batcher):
            if b_ is not None:
                b_.batch_divisor = self.mesh.n_data
                b_.device_spec = cfg.device_spec
        self.logger = logger or TrainingLogger(cfg.output_dir, also_print=self.is_main,
                                               write=self.is_main)
        num_lines = len(batcher._index)
        self.target_deltas = xva_target_deltas(max(num_lines, 1))
        self.graphs = GraphsWriter(cfg.output_dir, (1, 2),
                                   {1: self.target_deltas[0], 2: self.target_deltas[1]},
                                   write=self.is_main)
        self.ckpt = CheckpointManager(cfg.output_dir, prefix="xVAPitch")
        self.meter = ThroughputMeter()
        # the architecture beside the checkpoints, so that inference can
        # rebuild the model of any output directory
        if self.is_main:
            os.makedirs(cfg.output_dir, exist_ok=True)
            with open(os.path.join(cfg.output_dir, "model_config.json"), "w") as f:
                json.dump(dataclasses.asdict(model_cfg), f, indent=2)

        # micro-batches are bucket-sized (XvaBatcher.batch_size_for), so gam
        # divides the target by the epoch plan's mean micro-batch
        try:
            mean_bs = batcher.mean_batch_size()
        except Exception:
            mean_bs = float(cfg.batch_size)
        self.gam = max(1, int(math.ceil(cfg.target_bs / max(mean_bs, 1.0))))

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            self.model = XVAPitch(model_cfg)
            torch.manual_seed(cfg.seed + 9)
            self.disc = VitsDiscriminator()
        self.model.to(self.device).train()
        self.disc.to(self.device).train()
        self.g_opt, self.d_opt = make_optimizers(self.model, self.disc, cfg, self.gam)
        # both steps update the same optimisers: a freeze at the micro-step
        # that completes an update masks that update
        self._steps = {
            freeze: make_v3_step(self.model, self.disc, self.g_opt, self.d_opt, freeze,
                                 hifi_only=cfg.hifi_only, use_amp=cfg.use_amp, mesh=self.mesh)
            for freeze in (False, True)}
        self._set_up = False
        self.stage = 1
        self.training_iters = 0       # optimiser updates
        self.micro_steps = 0
        self.finetune_counter = 0
        self.finetune_it = True
        self.loss_sampling: Dict[str, float] = {}
        self.disc_loss_window: List[float] = []
        self.disc_loss_per_ckpt: List[List[float]] = [[], []]
        self.deltas: List[List[float]] = [[], []]
        self.patience_count = 0
        self.stop_requested = False
        self.paused = False   # warm pause: the models stay on the card
        self.END_OF_TRAINING = False
        self.seed_seconds: Optional[float] = None
        # TensorBoard scalars every 21 updates (reference xva_train.py:757-771)
        self.tb = make_tensorboard(cfg.output_dir) if self.is_main else None

    # ---- set-up, resume, warm start ----

    def setup(self, resume: bool = True, pretrained_ckpt: Optional[str] = None) -> None:
        """Resume from the newest checkpoint of the output directory when
        ``resume`` and there is one: parameters, both optimisers' state and
        the host state, bit for bit. Else warm-start from the reference-layout
        ``.pt`` ``pretrained_ckpt`` when given (``[base]``
        xVAPitch_5820651.pt's role, reference xva_train.py:104-131,250).

        An output directory that holds the JAX package's orbax checkpoints and
        none of the port's is refused: starting from scratch there would
        quietly throw a user's training away."""
        from ..interop.pretrained import load_xvapitch_base

        resumed = False
        if resume:
            found = {"error": None, "state": None, "host": None}
            if self.is_main:
                step = self.ckpt.latest_step()
                if step is None and self.ckpt.foreign_steps():
                    found["error"] = (
                        f"{self.ckpt.output_dir} holds JAX orbax checkpoints "
                        f"{['xVAPitch_%d' % s for s in self.ckpt.foreign_steps()]} and no "
                        "checkpoint of the PyTorch port, which cannot read them; resume "
                        "them with the JAX package, or train in another output directory")
                elif step is not None:
                    _, found["state"], found["host"] = self.ckpt.restore_latest(
                        map_location=self.device)
            found = broadcast_from_host0(found)
            if found["error"]:
                raise RuntimeError(found["error"])
            if found["state"] is not None:
                self.load_checkpoint_state(found["state"], found["host"])
                resumed = True
                self.logger.log(f"[resume] stage {self.stage} iters {self.training_iters}")
        if not resumed and pretrained_ckpt:
            load_xvapitch_base(pretrained_ckpt, self.model, self.disc)
            self.logger.log(f"[warm start] base checkpoint {os.path.basename(pretrained_ckpt)}")
        commit_replicated([self.model, self.disc], self.mesh)
        self._set_up = True

    def host_state(self) -> Dict[str, Any]:
        """The JSON sidecar's host state, with the JAX trainer's keys."""
        return {"stage": self.stage, "training_iters": self.training_iters,
                "disc_loss_per_ckpt": self.disc_loss_per_ckpt, "deltas": self.deltas,
                "patience_count": self.patience_count, "frames_s": self.meter.mean()}

    def checkpoint_state(self) -> Dict[str, Any]:
        """What a checkpoint holds beside the sidecar's host state: both
        models, both optimisers, and the rest of the host state."""
        return {"model": self.model.state_dict(), "disc": self.disc.state_dict(),
                "g_opt": self.g_opt.state_dict(), "d_opt": self.d_opt.state_dict(),
                "trainer": {"micro_steps": self.micro_steps,
                            "finetune_counter": self.finetune_counter,
                            "finetune_it": self.finetune_it,
                            "loss_sampling": dict(self.loss_sampling),
                            "disc_loss_window": list(self.disc_loss_window),
                            "END_OF_TRAINING": self.END_OF_TRAINING}}

    def load_checkpoint_state(self, state: Dict[str, Any], host: Optional[Dict]) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.disc.load_state_dict(state["disc"], strict=True)
        self.g_opt.load_state_dict(state["g_opt"])
        self.d_opt.load_state_dict(state["d_opt"])
        for k, v in state["trainer"].items():
            setattr(self, k, v)
        if host:
            self.stage = host["stage"]
            self.training_iters = host["training_iters"]
            self.disc_loss_per_ckpt = host["disc_loss_per_ckpt"]
            self.deltas = host["deltas"]
            self.patience_count = host["patience_count"]

    # ---- the loss-sorted sampler's seed ----

    def seed_data_losses(self) -> int:
        """One no-grad pass over the finetune set before training, so that
        the first epoch already samples by loss (reference init_data_losses,
        xva_train.py:1248-1316). The per-item losses stay on the card until
        the pass ends. Returns the items seeded."""
        if not self.cfg.do_loss_sorting or self.cfg.hifi_only:
            return 0
        t0 = time.perf_counter()
        eval_fn = make_v3_loss_eval(self.model, use_amp=self.cfg.use_amp)
        _, index, count = data_shard(self.mesh)
        gen = shard_draws(torch.Generator(device=self.device).manual_seed(self.cfg.seed + 999),
                          index, count)
        pending = []
        for batch in self.batcher.epoch(shuffle=False):
            per = eval_fn(shard_batch(self.mesh, batch, self.device), gen)
            per = all_gather_rows(per, self.mesh)
            pending.append((batch["ids"], per[: len(batch["ids"])]))
        count = 0
        if pending:
            values = torch.cat([p for _, p in pending]).float().cpu().tolist()
            names = [n for ids, _ in pending for n in ids]
            for name, v in zip(names, values):
                self.loss_sampling[name] = v
                count += 1
        if self.loss_sampling:
            self.batcher.resample_by_loss(self.loss_sampling)
        self.seed_seconds = time.perf_counter() - t0
        self.logger.log(f"[loss-sorting] seeded {count} items")
        return count

    # ---- the batch stream ----

    def _next_batch(self, iterators, ft_it: bool):
        key = "ft" if (ft_it or self.priors_batcher is None) else "priors"
        if iterators.get(key) is None:
            src = self.batcher if key == "ft" else self.priors_batcher
            iterators[key] = src.epoch()
        try:
            return next(iterators[key]), key == "ft"
        except StopIteration:
            if key == "ft" and self.cfg.do_loss_sorting and self.loss_sampling:
                # this runs on the Prefetcher's thread while the loop adds to
                # loss_sampling at gam boundaries: resample from a snapshot
                # (iterating the live dict could raise "changed size")
                self.batcher.resample_by_loss(dict(self.loss_sampling))
            src = self.batcher if key == "ft" else self.priors_batcher
            iterators[key] = src.epoch()
            return next(iterators[key]), key == "ft"

    def _batch_stream(self):
        """Endless (batch, is_ft): the finetune/priors interleave (reference
        FINETUNE_WEIGHT alternation, xva_train.py:314, 882-886) on counters of
        its own, so that it can run ahead of the loop on the prefetch thread:
        is_ft depends on the micro-step count alone."""
        iterators: Dict[str, Any] = {}
        ft_it = self.finetune_it
        counter = self.finetune_counter
        micro = 0
        while True:
            batch, is_ft = self._next_batch(iterators, ft_it)
            yield batch, is_ft
            micro += 1
            if micro % self.gam == 0:
                counter += 1
                ft_it = True
                if counter >= self.cfg.finetune_weight:
                    ft_it = False
                    counter = 0

    # ---- the loop ----

    def train(self, max_steps: Optional[int] = None) -> Dict:
        """Train until early stop, ``stop_requested`` or ``max_steps``
        optimiser updates in all. Collate and the transfer run on the
        prefetcher's thread; the loop launches steps and reads the losses
        from the card once per update. Returns the stage, the updates, the
        wall seconds and the mean frames a second."""
        if not self._set_up:
            self.setup()
        if self.cfg.do_loss_sorting and self.cfg.seed_loss_sorting and not self.loss_sampling:
            self.seed_data_losses()
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed + 100)
        pending: List = []
        start = time.perf_counter()
        self.meter.start()
        pf = Prefetcher(self._batch_stream(),
                        lambda t: (shard_batch(self.mesh, t[0], self.device), t[0]["ids"],
                                   int(np.sum(t[0]["slens"])), t[1]))
        stream = iter(pf)
        try:
            while not self.stop_requested and not self.END_OF_TRAINING:
                # warm pause (the reference's pause keeps the trainer resident,
                # xva_train.py:569-573)
                while self.paused and not self.stop_requested:
                    time.sleep(0.2)
                if self.stop_requested:
                    break
                dev, ids, frames, is_ft = next(stream)
                freeze = (self.stage == 1) or (not is_ft and self.priors_batcher is not None)
                meta = self._steps[freeze](dev, gen)
                self.micro_steps += 1
                self.meter.add_frames(frames)

                if self.cfg.do_loss_sorting and is_ft and "per_sample_kl" in meta:
                    # stays on the card until the update's boundary: a read
                    # each micro-step would wait for every step
                    per = meta["per_sample_kl"] + meta["per_sample_mel"]
                    if "per_sample_pitch" in meta:
                        per = per + meta["per_sample_pitch"]
                    per = all_gather_rows(per, self.mesh)
                    pending.append((ids, per[: len(ids)]))

                if self.micro_steps % self.gam == 0:
                    if pending:
                        values = torch.cat([p for _, p in pending]).float().cpu().tolist()
                        for name, v in zip((n for p_ids, _ in pending for n in p_ids), values):
                            self.loss_sampling[name] = v
                    pending = []
                    self.training_iters += 1
                    fps = self.meter.step()
                    loss = float(meta["loss"])
                    disc_loss = float(meta["loss_disc"])
                    self.disc_loss_window.append(disc_loss)
                    self.graphs.add_loss(self.stage, self.training_iters, loss)
                    if self.tb and self.training_iters % 21 == 0:
                        # the reference's scalars (xva_train.py:765-771)
                        it = self.training_iters
                        self.tb.add_scalar("loss/loss", loss, it)
                        self.tb.add_scalar("loss/disc", disc_loss, it)
                        for k, tag in (("loss_mel", "loss/mel"), ("loss_kl", "loss/kl"),
                                       ("loss_duration", "loss/duration")):
                            if k in meta:
                                self.tb.add_scalar(tag, float(meta[k]), it)
                        self.tb.add_scalar("meta/frames/s", fps, it)
                    self.logger.set_status(
                        f"Stage: {self.stage} | Steps: {self.training_iters} | "
                        f"Loss: {loss:.4f} | Disc: {disc_loss:.4f} | frames/s {int(fps)}")
                    # the executed schedule's copy of _batch_stream's counters,
                    # which run ahead: they seed the stream of the next train()
                    self.finetune_counter += 1
                    self.finetune_it = True
                    if self.finetune_counter >= self.cfg.finetune_weight:
                        self.finetune_it = False
                        self.finetune_counter = 0

                    if self.training_iters % self.cfg.save_step == 0:
                        self._checkpoint_and_early_stop()

                if max_steps and self.training_iters >= max_steps:
                    break
        finally:
            pf.close()
        self.ckpt.wait()
        return {"stage": self.stage, "training_iters": self.training_iters,
                "wall_s": time.perf_counter() - start, "frames_s": self.meter.mean()}

    def _checkpoint_and_early_stop(self):
        """Every ``save_step`` updates: the mean disc loss since the last
        checkpoint, the window delta, the stage changes (reference
        :782-858), then a checkpoint."""
        si = self.stage - 1
        avg_disc = float(np.mean(self.disc_loss_window)) if self.disc_loss_window else 0.0
        self.disc_loss_window = []
        loss_delta = 0.0
        if self.stage <= 2:
            hist = self.disc_loss_per_ckpt[si]
            if len(hist) >= 1 and hist[-1] != 0:
                self.deltas[si].append((hist[-1] - avg_disc) / hist[-1])
                window = self.deltas[si][-10:]
                loss_delta = float(np.mean(window))
                # raw units, as the chart's target_delta line and the early
                # stop compare them
                self.graphs.add_delta(self.stage, self.training_iters, loss_delta)
            hist.append(avg_disc)

        if loss_delta and loss_delta < self.target_deltas[si]:
            self.patience_count += 1
            if self.patience_count >= self.cfg.patience:
                if self.stage == 1:
                    self.logger.log("Finished Stage 1. Moving on..")
                    self.stage = 2
                    self.patience_count = 0
                elif self.stage == 2:
                    self.logger.log("Finished Stage 2. Stopping training.")
                    self.stage = 3
                    self.END_OF_TRAINING = True
        else:
            self.patience_count = 0

        if self.is_main:
            self.ckpt.save(self.training_iters, self.checkpoint_state(), self.host_state())

    # ---- previews and export ----

    @torch.no_grad()
    def output_samples(self, sentences, d_vector, out_dir: Optional[str] = None,
                       lang_id: Optional[int] = None, max_frames: int = 512) -> List[str]:
        """Preview wavs through the whole model (reference :892-895,
        output_samples :1323-1365): one per sentence, its tokens padded or
        cut to 128, ``y_lengths · hop`` samples written to
        ``viz/<updates>/sample_<i>.wav``. ``lang_id`` defaults to the
        finetune dataset's language (its first cache's). Sample i's noise
        comes from a generator seeded i. Writes nothing, and returns [], on a
        rank other than 0."""
        from ..data.text.xva_processor import XvaTextProcessor

        if not self.is_main:
            return []

        if lang_id is None:
            caches = getattr(self.batcher, "caches", None)
            lang_id = int(getattr(caches[0], "lang_id", 0)) if caches else lang_to_id("en")
        out_dir = out_dir or os.path.join(self.cfg.output_dir, "viz", str(self.training_iters))
        os.makedirs(out_dir, exist_ok=True)
        tp = XvaTextProcessor()
        c = self.model.cfg
        dvec = torch.from_numpy(np.asarray(d_vector, np.float32)).reshape(1, -1).to(self.device)
        lang = torch.tensor([lang_id], device=self.device)
        was_training = self.model.training
        self.model.eval()
        paths = []
        try:
            for i, text in enumerate(sentences):
                ids = tp.text_to_sequence(text)
                tokens = np.pad(ids, (0, max(0, 128 - len(ids))))[:128].astype(np.int64)
                g = torch.Generator().manual_seed(i)
                dp_noise = torch.randn((1, 2, 128), generator=g)
                noise = torch.randn((1, c.latent_size, max_frames), generator=g)
                out = self.model.infer(torch.from_numpy(tokens)[None].to(self.device), dvec,
                                       lang, max_frames=max_frames,
                                       noise=noise.to(self.device),
                                       dp_noise=dp_noise.to(self.device))
                n = int(out["y_lengths"][0]) * c.hop_length
                p = os.path.join(out_dir, f"sample_{i}.wav")
                save_wav(p, out["wav"][0, :n].float().cpu().numpy())
                paths.append(p)
        finally:
            self.model.train(was_training)
        return paths

    def export(self, voice_name: str, lang: str = "en", base_emb=None, other_embs=None,
               out_dir: Optional[str] = None,
               lang_capabilities: Optional[List[str]] = None) -> str:
        """``{voice_name}.pt`` (the reference-layout fp16 state dict with the
        ``disc.*`` subtree) and its metadata ``.json`` in ``out_dir`` (the
        output directory by default). Returns the ``.pt``'s path; None, with
        nothing written, on a rank other than 0."""
        if not self.is_main:
            return None
        out_dir = out_dir or self.cfg.output_dir
        path = os.path.join(out_dir, f"{voice_name}.pt")
        export_xvapitch_v3(self.model, path, voice_name, lang=lang, base_emb=base_emb,
                           other_embs=other_embs, disc=self.disc,
                           lang_capabilities=lang_capabilities)
        return path
