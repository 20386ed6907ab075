"""The v2 HiFi-GAN trainer (the v2 pipeline's stage 5): its GAN step in both
orders, the segment sampler, the loop with warm start, resume, the
per-epoch learning rate and early stop, and the ``.hg.pt`` export.

Counterpart of ``xva_trainer_tpu/train/hifigan_trainer.py`` (reference
python/hifigan/xva_train.py:451-567):

- a step: random 8192-sample segments → their 0-8 kHz mel → the generator →
  the discriminator (LSGAN) and the generator (mel L1 ×45 on the full-band
  mel, the adversarial term and feature matching ×2);
- AdamW, lr 2e-4, betas (0.8, 0.99), weight decay 0.01, the lr ×0.999 each
  epoch (ExponentialLR), kept in the optimiser's state and checkpoint as
  ``optax.inject_hyperparams`` keeps it;
- the epoch loss-delta early stop (target 1e-4, span 25, at least 25
  epochs);
- a warm start from the reference's ``g_``/``do_`` checkpoints, rolling
  checkpoints with resume, and the ``{voice}.hg.pt`` export.

The JAX step is one XLA program with one backward; the port takes two
backward passes, ``torch.autograd.grad`` with respect to the generator's
parameters, then to the discriminator's, so that neither loss leaves a
gradient on the other model. The discriminator's spectral-norm vectors are
module buffers (JAX's ``GanState.d_stats``) and go into the checkpoint.
JAX's ``commit``, ``precompile``, ``load_generator_params`` and mesh are XLA
machinery and have no counterpart: the port runs eagerly on one card.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..data.audio_io import load_wav
from ..data.dataset import read_metadata
from ..data.prefetch import Prefetcher, batch_to_device
from ..models.hifigan.models import (Generator, HifiganConfig, HifiganDiscriminator,
                                     discriminator_loss, feature_matching_loss,
                                     generator_adv_loss)
from ..ops.fused_stft import mel_spectrogram_fused
from ..ops.stft import LOSS_MEL, MelConfig, mel_spectrogram_hifigan
from . import amp
from .checkpoints import CheckpointManager, export_hifigan_v2
from .early_stop import (HIFIGAN_MIN_EPOCHS, HIFIGAN_SPAN, HIFIGAN_TARGET_DELTA,
                         EarlyStopState)
from .metrics import GraphsWriter, ThroughputMeter, TrainingLogger, make_tensorboard
from .optim import GanOptimizer

SEGMENT_SIZE = 8192  # config_v1.json segment_size
MEL_WEIGHT = 45.0    # reference xva_train.py:504 (mel L1 ×45)


@dataclasses.dataclass
class HifiganTrainConfig:
    """The JAX package's ``HifiganTrainConfig``, field for field and default
    for default, but ``steps_per_epoch_hint`` (declared there, read nowhere)."""

    output_dir: str = "out_hifi"
    batch_size: int = 16
    lr: float = 2e-4
    lr_decay: float = 0.999  # per epoch
    adam_betas = (0.8, 0.99)
    seed: int = 0
    # bf16 compute, fp32 masters (train/amp.py); the reference defaults AMP on
    use_amp: bool = True
    # the reference's order: D first, then G against the updated D (one more
    # generator forward a step)
    d_first: bool = False
    # the epoch's size multiplier; None: an epoch is about 1000 items
    # whatever the dataset's size (reference meldataset.py:296-302)
    data_mult: Optional[int] = None


def _hifigan_mel(wav: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """``mel_spectrogram_hifigan``'s function of (B, T) audio that carries no
    gradient, through the fused STFT kernel (its plain version on the CPU)."""
    return mel_spectrogram_fused(wav, cfg, center=False, mag_eps=1e-9)


def make_gan_step(gen: Generator, disc: HifiganDiscriminator, g_opt: GanOptimizer,
                  d_opt: GanOptimizer, mel_cfg: MelConfig = MelConfig(), use_amp: bool = True,
                  d_first: bool = False) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """One adversarial step, ``step(wav_real)`` on (B, 1, SEGMENT_SIZE) audio
    → ``mel_l1``, ``adv``, ``fm``, ``g_loss`` and ``d_loss`` (fp32 device
    tensors); updates both models, both optimisers and the spectral norm's
    ``u`` in place. Two orders:

    - default (``d_first=False``): a G step against the current D, then a D
      step on the generator's fakes, detached (the generator runs once);
    - ``d_first``: the fakes without gradient, the D step, then the G step
      against the updated D and its updated ``u`` (the reference v2 order;
      one more generator forward).

    The G pass calls the discriminator with ``update_sn_stats=False`` (both
    its passes start from the stored ``u``), the D pass with True (the real
    pass stores u', the generated pass iterates from it). The input mel
    (``mel_cfg``) and the real side of the loss mel (``LOSS_MEL``, the full
    band) carry no gradient and go through the fused STFT kernel: 2 launches
    a step. The generated side goes through the differentiable
    ``ops/stft.py``. ``use_amp``: bf16 autocast around both models, the mels
    and losses in fp32."""
    g_params = list(gen.parameters())
    d_params = list(disc.parameters())

    def g_loss_fn(mel_in, wav_real, mel_real):
        dev = wav_real.device
        with amp.autocast(dev, use_amp):
            y_g = gen(mel_in)
        y_g = y_g.float()
        mel_l1 = torch.mean(torch.abs(mel_spectrogram_hifigan(y_g[:, 0], LOSS_MEL) - mel_real))
        with amp.autocast(dev, use_amp):
            _, outs_g, fmaps_r, fmaps_g = disc(wav_real, y_g, update_sn_stats=False)
        outs_g, fmaps_r, fmaps_g = amp.to_fp32((outs_g, fmaps_r, fmaps_g))
        adv = generator_adv_loss(outs_g)
        fm = feature_matching_loss(fmaps_r, fmaps_g)
        return MEL_WEIGHT * mel_l1 + adv + fm, {"mel_l1": mel_l1, "adv": adv, "fm": fm}, y_g

    def d_step(wav_real, y_hat):
        with amp.autocast(wav_real.device, use_amp):
            outs_r, outs_g, _, _ = disc(wav_real, y_hat, update_sn_stats=True)
        d_loss = discriminator_loss(*amp.to_fp32((outs_r, outs_g)))
        d_opt.step(torch.autograd.grad(d_loss, d_params))
        return d_loss

    def step(wav_real: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            mel_in = _hifigan_mel(wav_real[:, 0], mel_cfg)
            mel_real = _hifigan_mel(wav_real[:, 0], LOSS_MEL)
        if d_first:
            with torch.no_grad(), amp.autocast(wav_real.device, use_amp):
                y_hat = gen(mel_in).float()
            d_loss = d_step(wav_real, y_hat)
            g_loss, meta, _ = g_loss_fn(mel_in, wav_real, mel_real)
            g_opt.step(torch.autograd.grad(g_loss, g_params))
        else:
            g_loss, meta, y_g = g_loss_fn(mel_in, wav_real, mel_real)
            g_grads = torch.autograd.grad(g_loss, g_params)
            y_hat = y_g.detach()  # the pre-update generator's fakes
            g_opt.step(g_grads)
            d_loss = d_step(wav_real, y_hat)
        meta = {k: v.detach() for k, v in meta.items()}
        meta["g_loss"] = g_loss.detach()
        meta["d_loss"] = d_loss.detach()
        return meta

    return step


class SegmentSampler:
    """Random fixed-size waveform segments (reference meldataset.py
    MelDataset): the wavs read once, every epoch random 8192-sample crops
    of shape (batch_size, SEGMENT_SIZE, 1), the JAX package's layout.

    The same numpy draws in the same order as the JAX sampler's, so one
    seed gives the same segments in both packages: a permutation a
    ``data_mult``, one ``integers`` a crop, and one ``choice`` when the
    dataset holds less than a batch."""

    def __init__(self, dataset_path: str, batch_size: int, seed: int = 0,
                 sample_rate: int = 22050, data_mult: Optional[int] = None):
        self.items = read_metadata(dataset_path)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.wavs: List[np.ndarray] = []
        for it in self.items:
            y, _ = load_wav(it.wav_path, target_sr=sample_rate)
            if len(y) < SEGMENT_SIZE:
                y = np.pad(y, (0, SEGMENT_SIZE - len(y)))
            self.wavs.append(y.astype(np.float32))
        # an "epoch" is about 1000 items whatever the dataset's size
        # (reference get_dataset_filelist, meldataset.py:296-302): the
        # per-epoch lr decay and the early stop's patience depend on it
        if data_mult is None:
            data_mult = max(1, round(1000 / max(1, len(self.wavs))))
        self.data_mult = int(data_mult)

    def __len__(self):
        return max(1, (len(self.wavs) * self.data_mult) // self.batch_size)

    def _crops(self, idx) -> np.ndarray:
        seg = np.zeros((self.batch_size, SEGMENT_SIZE, 1), np.float32)
        for j, i in enumerate(idx):
            y = self.wavs[i]
            start = self.rng.integers(0, max(1, len(y) - SEGMENT_SIZE + 1))
            seg[j, :, 0] = y[start: start + SEGMENT_SIZE]
        return seg

    def epoch(self):
        order = np.concatenate(
            [self.rng.permutation(len(self.wavs)) for _ in range(self.data_mult)])
        for s in range(0, len(order) - self.batch_size + 1, self.batch_size):
            yield self._crops(order[s: s + self.batch_size])
        if len(order) < self.batch_size:  # a tiny dataset still yields one batch
            yield self._crops(self.rng.choice(len(self.wavs), self.batch_size))


class HifiganTrainer:
    """The stage-5 loop: ``HifiganTrainer(dataset_path, cfg)`` →
    ``.setup(...)`` → ``.train(...)`` → ``.export(name)``, as the JAX
    package's v2 pipeline drives the JAX trainer.

    The generator and the full ``HifiganDiscriminator`` are made here, on
    ``device``, from ``cfg.seed``; ``setup`` resumes or warm-starts them."""

    def __init__(self, dataset_path: str, cfg: HifiganTrainConfig,
                 gen_cfg: HifiganConfig = HifiganConfig(),
                 logger: Optional[TrainingLogger] = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            self.gen = Generator(gen_cfg)
            self.disc = HifiganDiscriminator()
        self.gen.to(self.device).train()
        self.disc.to(self.device).train()
        self.logger = logger or TrainingLogger(cfg.output_dir)
        self.sampler = SegmentSampler(dataset_path, cfg.batch_size, cfg.seed,
                                      data_mult=cfg.data_mult)
        # the reference's AdamW without a weight_decay argument: torch's
        # default 0.01 (:298-299); the lr in fp32, as inject_hyperparams holds it
        lr = float(np.float32(cfg.lr))
        self.g_opt = GanOptimizer(self.gen.parameters(), lr, betas=cfg.adam_betas,
                                  weight_decay=0.01, gamma=1.0)
        self.d_opt = GanOptimizer(self.disc.parameters(), lr, betas=cfg.adam_betas,
                                  weight_decay=0.01, gamma=1.0)
        self._step_fn = make_gan_step(self.gen, self.disc, self.g_opt, self.d_opt, MelConfig(),
                                      use_amp=cfg.use_amp, d_first=cfg.d_first)
        self.early = EarlyStopState(target_delta=HIFIGAN_TARGET_DELTA, span=HIFIGAN_SPAN,
                                    min_epochs=HIFIGAN_MIN_EPOCHS)
        self.graphs = GraphsWriter(cfg.output_dir, (5,), {5: HIFIGAN_TARGET_DELTA})
        self.ckpt = CheckpointManager(cfg.output_dir, prefix="HiFiGAN")
        self.meter = ThroughputMeter()
        self.epoch = 0
        self._max_iters: Optional[int] = None
        self.total_iter = 0
        self.stop_requested = False
        self.paused = False   # warm pause: the models and their state stay on the card
        self._set_up = False
        self.tb = make_tensorboard(cfg.output_dir)

    def setup(self, resume: bool = True, pretrained_g: Optional[str] = None,
              pretrained_do: Optional[str] = None) -> None:
        """Resume from the newest checkpoint of the output directory when
        ``resume`` and there is one (both models with the spectral norm's
        buffers, both optimisers, the step, ``epoch`` and the early stop, bit
        for bit); else warm-start from the reference's ``g_`` and ``do_``
        checkpoints when given ("never from scratch", reference
        hifigan/xva_train.py:276-296), taking ``epoch`` = the file's + 1 and
        the step from its ``steps``."""
        from ..interop.pretrained import load_hifigan_discriminators, load_hifigan_generator

        step = self.ckpt.latest_step()
        if resume and step is None and self.ckpt.foreign_steps():
            raise RuntimeError(
                f"{self.ckpt.output_dir} holds JAX orbax checkpoints "
                f"{['HiFiGAN_%d' % s for s in self.ckpt.foreign_steps()]} and no checkpoint "
                "of the PyTorch port, which cannot read them; resume them with the JAX "
                "package, or train in another output directory")
        if resume and step is not None:
            _, state, host = self.ckpt.restore_latest(map_location=self.device)
            self.load_checkpoint_state(state, host)
            self.total_iter = int(step)
            self.logger.log(f"[resume] HiFi-GAN iter {self.total_iter}")
        elif pretrained_g:
            load_hifigan_generator(pretrained_g, self.gen)
            if pretrained_do:
                meta = load_hifigan_discriminators(pretrained_do, self.disc)
                self.epoch = int(meta.get("epoch", -1)) + 1
                self.total_iter = int(meta.get("steps", 0))
            self.logger.log(f"[warm start] pretrained g_={os.path.basename(pretrained_g)}"
                            + (f" do_={os.path.basename(pretrained_do)}"
                               if pretrained_do else ""))
        self._set_up = True

    def checkpoint_state(self) -> Dict[str, Any]:
        return {"gen": self.gen.state_dict(), "disc": self.disc.state_dict(),
                "g_opt": self.g_opt.state_dict(), "d_opt": self.d_opt.state_dict()}

    def load_checkpoint_state(self, state: Dict[str, Any], host: Optional[Dict]) -> None:
        self.gen.load_state_dict(state["gen"], strict=True)
        self.disc.load_state_dict(state["disc"], strict=True)
        self.g_opt.load_state_dict(state["g_opt"])
        self.d_opt.load_state_dict(state["d_opt"])
        if host:
            self.epoch = host.get("epoch", 0)
            if "early" in host:
                self.early = EarlyStopState.from_dict(host["early"])

    def _to_device(self, seg: np.ndarray) -> torch.Tensor:
        """On the prefetch thread: a (B, SEGMENT_SIZE, 1) crop → (B, 1,
        SEGMENT_SIZE) on the card."""
        return batch_to_device({"wav": seg.transpose(0, 2, 1)}, self.device)["wav"]

    def run_epoch(self) -> List[float]:
        """One epoch of steps: the crops and their transfer on the prefetch
        thread, each step's mel L1 read one step late, so that no step waits
        for the host. Returns the mel L1s."""
        losses: List[float] = []
        pending = None
        bs = self.cfg.batch_size
        pf = Prefetcher(self.sampler.epoch(), self._to_device)
        try:
            self.meter.start()
            for wav in pf:
                while self.paused and not self.stop_requested:
                    time.sleep(0.2)
                if self.stop_requested:
                    break
                if self._max_iters and self.total_iter >= self._max_iters:
                    break
                meta = self._step_fn(wav)
                self.total_iter += 1
                if pending is not None:
                    mel_l1 = float(pending)
                    losses.append(mel_l1)
                    fps = self.meter.step()
                    self.logger.set_status(
                        f"Stage: 5 | Epoch: {self.epoch} | Iter: {self.total_iter - 1} | "
                        f"mel L1: {mel_l1:.5f} | its/s: {fps / (bs * 32):.2f}")
                pending = meta["mel_l1"]
                self.meter.add_frames(bs * (SEGMENT_SIZE // 256))
            if pending is not None:
                losses.append(float(pending))
        finally:
            pf.close()
        return losses

    def _set_lr(self, lr: float) -> None:
        self.g_opt.lr = self.d_opt.lr = float(np.float32(lr))

    def finish_epoch(self, losses) -> bool:
        """The epoch's bookkeeping: the learning rate lr·γ^epoch (reference
        :306-307), ``graphs.json``, the early stop and a checkpoint. True
        when the early stop is met."""
        self.epoch += 1
        self._set_lr(self.cfg.lr * self.cfg.lr_decay ** self.epoch)
        if not losses:
            return False
        avg = float(np.mean(losses))
        self.graphs.add_loss(5, self.total_iter, avg)
        if self.tb:
            self.tb.add_scalar("loss/mel_l1", avg, self.total_iter)
            self.tb.add_scalar("meta/frames/s", self.meter.mean(), self.total_iter)
        done = self.early.push_epoch(avg)
        if self.early.last_delta_avg is not None:
            self.graphs.add_delta(5, self.total_iter, self.early.last_delta_avg)
        self.ckpt.save(self.total_iter, self.checkpoint_state(),
                       {"epoch": self.epoch, "early": self.early.to_dict()})
        self.logger.log(f"Stage: 5 | Epoch: {self.epoch} | mel L1: {avg:.5f}"
                        + (f" | Delta: {self.early.last_delta_avg:.5f}"
                           if self.early.last_delta_avg is not None else ""))
        return done

    def train(self, max_epochs: int = 10 ** 6, max_iters: Optional[int] = None) -> Dict:
        """Run epochs until the early stop, ``stop_requested``, or a budget."""
        if not self._set_up:
            self.setup()
        self._max_iters = max_iters
        start = time.perf_counter()
        for _ in range(max_epochs):
            losses = self.run_epoch()
            if self.finish_epoch(losses) or self.stop_requested:
                break
            if max_iters and self.total_iter >= max_iters:
                break
        self.ckpt.wait()
        return {"epoch": self.epoch, "total_iter": self.total_iter,
                "wall_s": time.perf_counter() - start}

    def export(self, voice_name: str, out_dir: Optional[str] = None) -> str:
        """``{voice_name}.hg.pt`` in ``out_dir`` (the output directory by
        default): {'generator': the fp32 reference-layout state dict}, as the
        reference writes it (:600-601), so xVASynth's HiFi-GAN loader reads
        it. Returns its path."""
        path = os.path.join(out_dir or self.cfg.output_dir, f"{voice_name}.hg.pt")
        export_hifigan_v2(self.gen, path)
        return path
