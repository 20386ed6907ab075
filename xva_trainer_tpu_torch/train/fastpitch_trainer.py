"""The v2 FastPitch trainer: the stage steps, the four-stage schedule,
duration extraction, checkpoints, previews and the xVASynth v2 export.

Counterpart of ``xva_trainer_tpu/train/fastpitch_trainer.py`` (reference
python/fastpitch1_1/xva_train.py):

- four stages, 1 the aligner, 2 the durations, 3 pitch and energy, 4 the
  mel, each freezing its modules (:589-672) and ending on the loss-delta
  early stop (:915-976);
- LAMB, lr 0.1 with the Noam warm-up of 1000 updates (:697-705,
  :1252-1261), accumulating ceil(target_bs / batch_size) micro-steps an
  update (:407), its whole state re-initialised at each stage hand-off;
- durations extracted once after stage 1 (:1120-1168), which stages 2-4
  then read instead of running the aligner and MAS in every step;
- rolling checkpoints (window 2) with resume, the NaN-loss skip
  (:825-832), frames a second, ``training.log`` and ``graphs.json``.

The JAX trainer's compile warming (``precompile_stage``,
``precompile_align``, ``first_dispatch_event``) and its abstract states are
XLA machinery and have no counterpart: the port runs eagerly. The stage
step takes a data-parallel mesh (``make_stage_step(mesh=...)``); the
trainer itself runs on one card (its mesh is the next slice's work). Its
checkpoints are the port's own files; an output directory
that holds the JAX package's orbax checkpoints and none of the port's is
refused, not started over.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..data.dataset import BucketBatcher, FeatureCache
from ..data.prefetch import Prefetcher, batch_to_device
from ..models.fastpitch import FastPitch, FastPitchConfig
from ..models.fastpitch import loss as fp_loss
from ..ops.attn_prior import beta_binomial_attn_prior
from ..parallel.draws import shard_draws
from . import amp
from .checkpoints import CheckpointManager, export_fastpitch_v2
from .early_stop import EarlyStopState, fastpitch_min_epochs, fastpitch_target_delta
from .metrics import GraphsWriter, ThroughputMeter, TrainingLogger, make_tensorboard
from .optim import LambOptimizer, fastpitch_stage_mask
from .xvapitch_trainer import data_shard, finite_or_zero, global_losses, sum_over_data


@dataclasses.dataclass
class FastPitchTrainConfig:
    """The JAX package's ``FastPitchTrainConfig``, field for field and default
    for default."""

    output_dir: str = "out"
    batch_size: int = 32
    target_bs: int = 256  # the effective batch, through accumulation (reference :407)
    base_lr: float = 0.1
    weight_decay: float = 1e-6
    warmup_steps: int = 1000
    epochs_per_checkpoint: int = 1
    force_stage: int = 0  # 0 = from stage 1
    seed: int = 0
    kl_warmup_epochs: float = 100.0
    # bf16 compute, fp32 masters (train/amp.py); the reference defaults AMP on
    use_amp: bool = True
    # make the beta-binomial prior on the device from the lengths
    # (ops/attn_prior.py) instead of collating it on the host
    device_prior: bool = True

    @property
    def grad_accum(self) -> int:
        return max(1, int(np.ceil(self.target_bs / self.batch_size)))


def batch_keys_for(stage: int, use_gt: bool, device_prior: bool):
    """The collated batch's keys a stage's step reads (the transfer's
    filter); None for all of them."""
    if stage == 1:
        keys = {"tokens", "in_lens", "mel", "mel_lens", "prior"}
    elif stage == 2 and use_gt:
        keys = {"tokens", "in_lens", "durs"}
    else:
        keys = None
    if device_prior:
        if keys is None:
            keys = {"tokens", "in_lens", "mel", "mel_lens", "pitch", "energy", "durs"}
        keys = keys - {"prior"}
    return keys


def _cast_up(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The fp16 host feed back to fp32, before any math."""
    return {k: (v.float() if torch.is_tensor(v) and v.dtype == torch.float16 else v)
            for k, v in batch.items()}


def _prior(batch, device_prior: bool):
    if not device_prior and "prior" in batch:
        return batch["prior"]
    return beta_binomial_attn_prior(batch["in_lens"], batch["mel_lens"],
                                    t_x=batch["tokens"].shape[1], t_y=batch["mel"].shape[1])


def make_align_step(model: FastPitch, device_prior: bool) -> Callable:
    """The aligner's forward for ``extract_durations``: ``align(batch)`` → the
    (B, T_text) durations of a batch on the device (one MAS launch)."""

    @torch.no_grad()
    def align(batch):
        batch = _cast_up(batch)
        out = model.stage1(batch["tokens"], batch["in_lens"], batch["mel"], batch["mel_lens"],
                           _prior(batch, device_prior))
        return out["durations"]

    return align


def make_stage_step(model: FastPitch, stage: int, opt: LambOptimizer, use_gt_durs: bool = False,
                    use_amp: bool = True, device_prior: bool = False, mesh=None) -> Callable:
    """One micro-step of ``stage``: ``step(batch, kl_weight, generator)`` →
    the losses (device tensors) with ``skipped_nan``. Updates ``model`` and
    ``opt`` in place.

    - ``use_gt_durs``: stages 2-4 read the batch's ``"durs"`` instead of
      running the aligner and MAS (when the batch has them).
    - ``use_amp``: bf16 autocast around the forward, every loss in fp32.
    - ``device_prior``: the prior made on the device from the lengths.
    - The NaN skip: a non-finite loss zeroes the gradients, and the
      micro-step still counts toward the accumulation, as in JAX.
    - A batch may carry ``"all_aligned"`` (a host bool: every item has at
      least as many frames as tokens), which spares the stage-1 CTC a read
      of the lengths from the device.
    - ``mesh`` (``parallel/mesh.py``) with a data axis of W > 1: the batch is
      this rank's slice of the global batch; the dropout masks are drawn for
      the global batch and sliced, the loss is this rank's share of the
      global batch's, the gradients are summed over the data group (one flat
      bucket), and the NaN skip and the returned losses read the global
      loss, as in ``make_v3_step``. A model cut by ``parallel/tp.py::
      shard_params`` over the mesh's model axis runs its FFNs tensor-parallel
      inside the forward; the LAMB trust ratio reads whole-tensor norms.
    """
    group, index, count = data_shard(mesh)
    params = list(model.parameters())

    def forward(batch, generator):
        tokens, in_lens = batch["tokens"], batch["in_lens"]
        if stage == 1:
            return model.stage1(tokens, in_lens, batch["mel"], batch["mel_lens"],
                                _prior(batch, device_prior))
        gt = use_gt_durs and "durs" in batch
        if stage == 2:
            if gt:
                return model.stage2_from_durs(tokens, in_lens, batch["durs"],
                                              generator=generator)
            return model.stage2(tokens, in_lens, batch["mel"], batch["mel_lens"],
                                _prior(batch, device_prior), generator=generator)
        kw = (dict(durs_gt=batch["durs"], run_aligner=False) if gt
              else dict(attn_prior=_prior(batch, device_prior)))
        return model.full(tokens, in_lens, batch["mel"], batch["mel_lens"], batch["pitch"],
                          batch["energy"], generator=generator, **kw)

    def step(batch: Dict[str, Any], kl_weight: float = 0.0,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        batch = _cast_up(batch)
        dev = params[0].device
        generator = shard_draws(generator, index, count)
        with amp.autocast(dev, use_amp):
            out = forward(batch, generator)
        out = amp.to_fp32(out)
        if stage == 1:
            loss, meta = fp_loss.stage1_loss(out, batch["in_lens"], batch["mel_lens"],
                                             kl_weight, batch.get("all_aligned"), group=group)
        elif stage == 2:
            loss, meta = fp_loss.stage2_loss(out, batch["in_lens"], group=group)
        elif stage == 3:
            loss, meta = fp_loss.stage3_loss(out, batch["mel"], batch["in_lens"], group=group)
        else:
            loss, meta = fp_loss.stage4_loss(out, batch["mel"], group=group)
        grads = list(torch.autograd.grad(loss, params, allow_unused=True))
        meta = global_losses(meta, group)
        sum_over_data(grads, group)
        opt.step(finite_or_zero(grads, meta["loss"]))
        meta["skipped_nan"] = (~torch.isfinite(meta["loss"])).float()
        return meta

    return step


class FastPitchTrainer:
    """The four-stage schedule around the steps: ``FastPitchTrainer(cache,
    cfg)`` → ``.setup(batcher)`` → ``.train(batcher, batcher_factory=...)`` →
    ``.export(name)``, as the JAX package's v2 pipeline drives the JAX
    trainer.

    The model is made here, on ``device``, from ``cfg.seed`` (``setup``
    resumes or warm-starts it). Dropout masks come from a generator seeded
    ``cfg.seed + 1`` at each ``train()`` call. One ``LambOptimizer`` holds
    the state; a stage change sets its freeze mask and ``reset_opt_state``
    re-initialises it."""

    def __init__(self, cache: FeatureCache, cfg: FastPitchTrainConfig,
                 model_cfg: FastPitchConfig = FastPitchConfig(),
                 logger: Optional[TrainingLogger] = None, device="cuda"):
        self.device = resolve_device(device)
        self.cache = cache
        self.cfg = cfg
        self.model_cfg = model_cfg
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            self.model = FastPitch(model_cfg)
        self.model.to(self.device).train()
        self.logger = logger or TrainingLogger(cfg.output_dir)
        self.num_lines = len(cache.items)
        self.target_deltas = {s: fastpitch_target_delta(s, self.num_lines) for s in (1, 2, 3, 4)}
        self.graphs = GraphsWriter(cfg.output_dir, (1, 2, 3, 4), self.target_deltas)
        self.ckpt = CheckpointManager(cfg.output_dir, prefix="FastPitch")
        self.meter = ThroughputMeter()
        self.stage = cfg.force_stage or 1
        self.opt = LambOptimizer(self.model.parameters(), cfg.base_lr, cfg.weight_decay,
                                 cfg.warmup_steps, grad_accum=cfg.grad_accum)
        # (stage, use_gt_durs) → the step, over the one optimiser
        self._stage_memo: Dict = {}
        self._align_fn = None
        self._set_up = False
        self.epoch = 0
        self.total_iter = 0
        self.stop_requested = False
        self.paused = False   # warm pause: the model and its state stay on the card
        self.tb = make_tensorboard(cfg.output_dir)
        self._stage_objects()

    # ---- stages ----

    def _get_stage_step(self, stage: int, use_gt: bool) -> Callable:
        key = (stage, use_gt)
        if key not in self._stage_memo:
            self._stage_memo[key] = make_stage_step(
                self.model, stage, self.opt, use_gt_durs=use_gt, use_amp=self.cfg.use_amp,
                device_prior=self.cfg.device_prior)
        return self._stage_memo[key]

    def _stage_objects(self):
        self.early = EarlyStopState(target_delta=self.target_deltas[self.stage],
                                    min_epochs=fastpitch_min_epochs(self.stage))
        use_gt = self.stage >= 2 and self.cache.has_durations()
        self.opt.train_mask = fastpitch_stage_mask(self.model, self.stage)
        self._step_fn = self._get_stage_step(self.stage, use_gt)
        self._batch_keys = batch_keys_for(self.stage, use_gt, self.cfg.device_prior)

    def _get_align_fn(self):
        if self._align_fn is None:
            self._align_fn = make_align_step(self.model, self.cfg.device_prior)
        return self._align_fn

    def reset_opt_state(self):
        """Re-initialise the optimiser for the current stage: the moments, the
        accumulator and the schedule's count (the warm-up starts again)."""
        self.opt.reset()

    # ---- set-up, resume, warm start ----

    def setup(self, batcher: Optional[BucketBatcher] = None, resume: bool = True,
              pretrained_ckpt: Optional[str] = None) -> None:
        """Resume from the newest checkpoint of the output directory when
        ``resume`` and there is one (the model, the optimiser and the host
        state, bit for bit); else warm-start from the reference FastPitch
        ``.pt`` ``pretrained_ckpt`` (the v2 base model's role, reference
        fastpitch1_1/xva_train.py:1054-1079), taking its ``training_stage``.
        ``batcher`` is the JAX signature's (JAX shapes its parameters from a
        batch; the port's model is made in ``__init__``)."""
        from ..interop.fastpitch_map import load_fastpitch_checkpoint

        step = self.ckpt.latest_step()
        if resume and step is None and self.ckpt.foreign_steps():
            raise RuntimeError(
                f"{self.ckpt.output_dir} holds JAX orbax checkpoints "
                f"{['FastPitch_%d' % s for s in self.ckpt.foreign_steps()]} and no checkpoint "
                "of the PyTorch port, which cannot read them; resume them with the JAX "
                "package, or train in another output directory")
        if pretrained_ckpt and step is None:
            meta = load_fastpitch_checkpoint(pretrained_ckpt, self.model)
            if "training_stage" in meta:
                self.stage = int(meta["training_stage"])
                self._stage_objects()
            self.logger.log(f"[warm start] {os.path.basename(pretrained_ckpt)} "
                            f"(stage {self.stage})")
        self.reset_opt_state()
        if resume and step is not None:
            _, state, host = self.ckpt.restore_latest(map_location=self.device)
            self.load_checkpoint_state(state, host)
            self.total_iter = int(step)
            self.logger.log(f"[resume] stage {self.stage} iter {self.total_iter}")
        self._set_up = True

    def host_state(self) -> Dict[str, Any]:
        """The JSON sidecar's host state, with the JAX trainer's keys."""
        return {"stage": self.stage, "epoch": self.epoch, "early": self.early.to_dict(),
                "frames_s": self.meter.mean()}

    def checkpoint_state(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(), "opt": self.opt.state_dict()}

    def load_checkpoint_state(self, state: Dict[str, Any], host: Optional[Dict]) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        if host:
            self.stage = host.get("stage", self.stage)
            self.epoch = host.get("epoch", 0)
            self._stage_objects()
            if "early" in host:
                self.early = EarlyStopState.from_dict(host["early"])
        self.opt.load_state_dict(state["opt"])

    def save_checkpoint(self):
        self.ckpt.save(self.total_iter, self.checkpoint_state(), self.host_state())

    # ---- durations ----

    def extract_durations(self, batcher: BucketBatcher) -> int:
        """After stage 1: the aligner once over the dataset, each item's
        durations written to the cache's ``durs/`` (reference
        extract_durations :1120-1168), so that stages 2-4 skip the aligner
        and MAS. Returns the items written."""
        align = self._get_align_fn()
        count = 0
        for batch in batcher.epoch(shuffle=False):
            durs = align(batch_to_device(batch, self.device)).cpu().numpy()
            for i, item_id in enumerate(batch["ids"]):
                self.cache.save_durations(item_id, durs[i, : int(batch["in_lens"][i])])
                count += 1
        batcher.use_durs = True
        self.logger.log(f"[durations] extracted for {count} items")
        return count

    # ---- training ----

    def kl_weight(self) -> float:
        """Stage 1's binarization warm-up (reference :792-798)."""
        if self.stage != 1:
            return 0.0
        return min(self.epoch / self.cfg.kl_warmup_epochs, 1.0)

    def _prep(self, b):
        """On the prefetch thread: the stage's keys to the card, the frames,
        and whether every item has an alignment (for the stage-1 CTC)."""
        keys = self._batch_keys
        sel = b if keys is None else {k: v for k, v in b.items() if k in keys}
        dev = batch_to_device(sel, self.device)
        dev["all_aligned"] = bool(np.all(b["mel_lens"] >= b["in_lens"]))
        return dev, int(np.sum(b["mel_lens"]))

    def run_epoch(self, batcher: BucketBatcher, generator: torch.Generator):
        """One pass over ``batcher``: collate and the transfer on the
        prefetch thread, each micro-step's loss read one step late. Returns
        (the losses, the generator)."""
        epoch_losses = []
        pending = None
        pf = Prefetcher(batcher.epoch(), self._prep)
        try:
            self.meter.start()
            for dev_batch, frames in pf:
                while self.paused and not self.stop_requested:
                    time.sleep(0.2)
                if self.stop_requested:
                    break
                meta = self._step_fn(dev_batch, self.kl_weight(), generator)
                self.total_iter += 1
                if pending is not None:
                    loss = float(pending)
                    epoch_losses.append(loss)
                    fps = self.meter.step()
                    self.logger.set_status(
                        f"Stage: {self.stage} | Epoch: {self.epoch} | "
                        f"Iter: {self.total_iter - 1} | Loss: {loss:.5f} | "
                        f"frames/s: {int(fps)}")
                pending = meta["loss"]
                self.meter.add_frames(frames)
            if pending is not None:
                epoch_losses.append(float(pending))
        finally:
            pf.close()
        return epoch_losses, generator

    def finish_epoch(self, epoch_losses) -> bool:
        """The epoch's bookkeeping; True when stage 4 just finished. An
        earlier stage that finishes hands off to the next, whose optimiser
        state starts afresh."""
        self.epoch += 1
        if not epoch_losses:
            return False
        avg = float(np.mean(epoch_losses))
        self.graphs.add_loss(self.stage, self.total_iter, avg)
        if self.tb:
            self.tb.add_scalar(f"loss/stage{self.stage}", avg, self.total_iter)
            self.tb.add_scalar("meta/frames/s", self.meter.mean(), self.total_iter)
        done = self.early.push_epoch(avg)
        if self.early.last_delta_avg is not None:
            self.graphs.add_delta(self.stage, self.total_iter, self.early.last_delta_avg)
        if self.epoch % self.cfg.epochs_per_checkpoint == 0 or done:
            self.save_checkpoint()
        line = (f"Stage: {self.stage} | Epoch: {self.epoch} | Loss: {avg:.5f} | "
                f"Target: {self.early.target_delta:.5f}")
        if self.early.last_delta_avg is not None:
            line += f" | Delta: {self.early.last_delta_avg:.5f}"
        if self.early.patience_count:
            line += f" | Hit: {self.early.patience_count}/{self.early.patience}"
        self.logger.log(line)
        if done:
            self.logger.log(f"[Trainer] Stage {self.stage} finished")
            if self.stage < 4:
                self.stage += 1
                self._stage_objects()
                self.reset_opt_state()
                return False
            return True  # stage 4 done: the HiFi-GAN stage follows
        return False

    def train(self, batcher: BucketBatcher, max_epochs: int = 10 ** 6,
              max_iters: Optional[int] = None, batcher_factory=None) -> Dict:
        """Run epochs until stage 4 finishes, ``stop_requested``, or a
        budget. ``batcher_factory(stage)`` gives the batcher of a new stage
        (the reference's per-stage batch sizes, xva_train.py:387-404); once
        durations are extracted it serves them (``use_durs``)."""
        generator = torch.Generator(device=self.device).manual_seed(self.cfg.seed + 1)
        if not self._set_up:
            self.setup(batcher)
        start = time.perf_counter()
        for _ in range(max_epochs):
            prev_stage = self.stage
            losses, generator = self.run_epoch(batcher, generator)
            all_done = self.finish_epoch(losses)
            if prev_stage == 1 and self.stage == 2:
                self.extract_durations(batcher)
                self._stage_objects()  # the step that reads the durations
            if self.stage != prev_stage and batcher_factory is not None:
                batcher = batcher_factory(self.stage)
                # a new batcher must go on serving the durations, or the
                # step would fall back to the aligner and MAS every step
                if self.stage >= 2 and self.cache.has_durations():
                    batcher.use_durs = True
            if all_done or self.stop_requested:
                break
            if max_iters and self.total_iter >= max_iters:
                break
        self.ckpt.wait()
        return {"stage": self.stage, "epoch": self.epoch, "total_iter": self.total_iter,
                "wall_s": time.perf_counter() - start, "frames_s": self.meter.mean()}

    # ---- export and previews ----

    def export(self, voice_name: str, out_dir: Optional[str] = None) -> str:
        """``{voice_name}.pt`` (the fp16 reference-layout state dict with the
        dataset's pitch statistics) and its ``.json`` in ``out_dir`` (the
        output directory by default). Returns the ``.pt``'s path."""
        out_dir = out_dir or self.cfg.output_dir
        path = os.path.join(out_dir, f"{voice_name}.pt")
        try:
            st = self.cache.pitch_stats()
            pitch_stats = (float(st.get("mean", 0.0)), float(st.get("std", 1.0)))
        except Exception:  # noqa: BLE001 — no statistics: the export's defaults, as JAX
            pitch_stats = None
        export_fastpitch_v2(self.model, path, voice_name, pitch_stats=pitch_stats)
        return path

    @torch.no_grad()
    def output_samples(self, sentences, out_dir: Optional[str] = None,
                       mel_max_len: int = 512):
        """Preview wavs from predicted mels through Griffin-Lim (16 rounds;
        reference output_samples, xva_train.py:1323-1365): the tokens padded
        or cut to 128, ``viz/<iter>/sample_<i>.wav``; sample i's initial
        phases seeded i."""
        from ..data.audio_io import save_wav
        from ..data.text.processor import TextProcessor
        from ..ops.griffin_lim import mel_to_wav

        out_dir = out_dir or os.path.join(self.cfg.output_dir, "viz", str(self.total_iter))
        os.makedirs(out_dir, exist_ok=True)
        tp = TextProcessor()
        was_training = self.model.training
        self.model.eval()
        paths = []
        try:
            for i, text in enumerate(sentences):
                ids = tp.encode(text)
                tokens = np.pad(ids, (0, max(0, 128 - len(ids))))[:128].astype(np.int64)
                out = self.model.infer(torch.from_numpy(tokens)[None].to(self.device),
                                       mel_max_len=mel_max_len)
                n = int(out["dec_lens"][0])
                wav = mel_to_wav(out["mel_out"][0][:, :n].float(), n_iter=16, seed=i)
                p = os.path.join(out_dir, f"sample_{i}.wav")
                save_wav(p, wav.cpu().numpy())
                paths.append(p)
        finally:
            self.model.train(was_training)
        return paths
