"""The v2 pipeline: FastPitch stages 1-4, then the HiFi-GAN stage 5, then
both exports, with the OOM batch-size retreat; its configuration and
per-stage batch sizes; and the v2 text → mel → waveform inference.

Counterpart of ``xva_trainer_tpu/train/pipeline.py`` (reference: the stage
hand-off "move to hifi", python/fastpitch1_1/xva_train.py:160-162; the
inference wrapper FastPitch1_1.infer, :1172-1233). The JAX pipeline's
compile warming (``precompile``: the HiFi-GAN trainer built and compiled on
a background thread while FastPitch trains) has no counterpart: the port
runs eagerly, and builds the HiFi-GAN trainer once, at the hand-off, after
FastPitch's export.
"""
from __future__ import annotations

import dataclasses
import gc
import os
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..data.audio_io import save_wav
from ..data.dataset import BucketBatcher, FeatureCache
from ..data.text.processor import TextProcessor
from ..models.fastpitch import FastPitchConfig
from ..models.hifigan.models import HifiganConfig
from .fastpitch_trainer import FastPitchTrainConfig, FastPitchTrainer
from .hifigan_trainer import HifiganTrainConfig, HifiganTrainer
from .metrics import TrainingLogger


@dataclasses.dataclass
class PipelineConfig:
    """The JAX package's ``PipelineConfig``, field for field, but
    ``precompile`` (XLA compile warming; the port runs eagerly)."""

    dataset_path: str = ""
    output_path: str = "out"
    batch_size: int = 32
    target_bs: int = 256
    max_fp_epochs: int = 10 ** 6
    max_hifi_epochs: int = 10 ** 6
    voice_name: str = "voice"
    use_amp: bool = True
    force_stage: int = 0          # 0 = auto; 1-4 FastPitch, 5 = HiFi-GAN only
    epochs_per_checkpoint: int = 1  # the reference's bkp_every_x


STAGE_BS_MULT = {1: 1.5, 2: 12.0, 3: 3.5, 4: 4.0}


def stage_batch_size(base: int, stage: int, max_file_len_sec: float, n_devices: int = 1,
                     divisor: int = 1) -> int:
    """Per-stage batch size (reference fastpitch1_1/xva_train.py:387-404):
    the stage multiplier ×1.5/12/3.5/4, × device count, × (10 / the longest
    clip's seconds), rounded down to a multiple of ``divisor``."""
    mult = STAGE_BS_MULT.get(stage, 1.0)
    file_mult = 10.0 / max(max_file_len_sec, 1e-6)
    bs = max(1, int(base * mult * n_devices * file_mult))
    d = max(1, divisor)
    return max(d, (bs // d) * d)


def _is_oom(err: Exception) -> bool:
    """A device out-of-memory error: XLA's RESOURCE_EXHAUSTED, or any error
    whose message says "out of memory" (``torch.cuda.OutOfMemoryError``'s
    does)."""
    s = str(err)
    return "RESOURCE_EXHAUSTED" in s or "out of memory" in s.lower()


def train_v2_pipeline(cfg: PipelineConfig, model_cfg: FastPitchConfig = FastPitchConfig(),
                      gen_cfg: HifiganConfig = HifiganConfig(), max_iters: Optional[int] = None,
                      _attempt: int = 0, on_trainer=None, device="cuda") -> Dict:
    """The reference's stage 1 → 5 schedule as one call, with the OOM
    retreat (reference handleTrainer:131-145): on a device OOM the
    pipeline starts again with the batch size less 3, from the checkpoints
    on disk, up to 8 times and while the batch is above 3.
    ``on_trainer(trainer)`` is called as each stage's trainer comes alive,
    so that a caller can reach its pause and stop flags. Returns each
    trainer's result and ``exports``, the paths of both exports (FastPitch's
    is left out under ``force_stage`` 5)."""
    try:
        return _train_v2_pipeline(cfg, model_cfg, gen_cfg, max_iters, on_trainer, device)
    except Exception as e:  # noqa: BLE001 — re-raised unless it is an OOM to retreat from
        if not (_is_oom(e) and cfg.batch_size > 3 and _attempt < 8):
            raise
    # out of the handler, the traceback and its frames (which hold the
    # failed attempt's trainers) are gone: free their memory before retrying
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return train_v2_pipeline(dataclasses.replace(cfg, batch_size=cfg.batch_size - 3),
                             model_cfg, gen_cfg, max_iters, _attempt + 1, on_trainer, device)


def _train_v2_pipeline(cfg: PipelineConfig, model_cfg, gen_cfg, max_iters, on_trainer,
                       device) -> Dict:
    dev = resolve_device(device)
    logger = TrainingLogger(cfg.output_path)
    cache = FeatureCache(cfg.dataset_path, TextProcessor().encode, device=dev)
    cache.build()
    max_len_sec = cache.max_file_len_sec()
    fp_cfg = FastPitchTrainConfig(
        output_dir=cfg.output_path, batch_size=cfg.batch_size, target_bs=cfg.target_bs,
        use_amp=cfg.use_amp, force_stage=min(cfg.force_stage, 4),
        epochs_per_checkpoint=cfg.epochs_per_checkpoint)
    fp = FastPitchTrainer(cache, fp_cfg, model_cfg, logger=logger, device=dev)
    if on_trainer:
        on_trainer(fp)

    # the ARPAbet mix at p = 0.3 when a CMUdict is there (reference xva_train.py:307)
    arpabet_tp = None
    cmu = os.environ.get("XVA_CMUDICT") or os.path.join(cfg.dataset_path, "cmudict.txt")
    if os.path.exists(cmu):
        arpabet_tp = TextProcessor(p_arpabet=0.3, cmudict_path=cmu)

    def batcher_for(stage: int) -> BucketBatcher:
        bs = stage_batch_size(cfg.batch_size, stage, max_len_sec)
        # the device prior (the default) needs no host prior; nor does stage 2
        # on extracted durations
        with_prior = (not fp_cfg.device_prior
                      and not (stage == 2 and cache.has_durations()))
        b = BucketBatcher(cache, batch_size=bs, with_prior=with_prior,
                          device_prior=fp_cfg.device_prior)
        b.arpabet_encoder = arpabet_tp
        b.use_durs = cache.has_durations()  # extracted durations survive batcher swaps
        return b

    if cfg.force_stage == 5:
        # straight to the vocoder (reference force_stage, javascript/train.js:711-747)
        fp_result, fp_path = {"skipped": True}, None
        logger.log("[pipeline] force_stage=5: skipping FastPitch stages 1-4")
    else:
        batcher = batcher_for(fp.stage)
        fp.setup(batcher)
        fp_result = fp.train(batcher, max_epochs=cfg.max_fp_epochs, max_iters=max_iters,
                             batcher_factory=batcher_for)
        fp_path = fp.export(cfg.voice_name)
        logger.log(f"[pipeline] FastPitch done: {fp_result} → {fp_path}")

    hifi_cfg = HifiganTrainConfig(output_dir=os.path.join(cfg.output_path, "hifi"),
                                  batch_size=min(16, cfg.batch_size), use_amp=cfg.use_amp)
    # as in the JAX pipeline, no pretrained g_/do_: the vocoder trains from
    # its seeded initial weights (or resumes from its checkpoints)
    hifi = HifiganTrainer(cfg.dataset_path, hifi_cfg, gen_cfg, logger=logger, device=dev)
    hifi.setup()
    if on_trainer:
        on_trainer(hifi)
    hifi_result = hifi.train(max_epochs=cfg.max_hifi_epochs, max_iters=max_iters)
    hg_path = hifi.export(cfg.voice_name, cfg.output_path)
    logger.log(f"[pipeline] HiFi-GAN done: {hifi_result} → {hg_path}")
    return {"fastpitch": fp_result, "hifigan": hifi_result,
            "exports": [p for p in (fp_path, hg_path) if p]}


class V2InferenceModel:
    """text → FastPitch mel → HiFi-GAN waveform (reference /exportWav flow,
    server.py:313-330 → FastPitch1_1.infer, fastpitch1_1/xva_train.py:1172-1233).

    ``fastpitch`` and ``generator`` are the port's ``FastPitch`` and v2
    ``Generator`` on one device; they run in eval mode, in fp32."""

    def __init__(self, fastpitch: torch.nn.Module, generator: torch.nn.Module,
                 mel_max_len: int = 1024):
        self.model = fastpitch.eval()
        self.gen = generator.eval()
        self.tp = TextProcessor()
        self.mel_max_len = mel_max_len
        self.hop = generator.cfg.hop

    @torch.no_grad()
    def infer(self, tokens: torch.Tensor):
        """(waveform (B, T·hop), dec_lens (B,)) of (B, T_text) tokens."""
        out = self.model.infer(tokens, mel_max_len=self.mel_max_len)
        return self.gen(out["mel_out"])[:, 0], out["dec_lens"]

    def tts(self, text: str, pad_to: Optional[int] = 256) -> np.ndarray:
        """The waveform of ``text``: its tokens padded or cut to ``pad_to``,
        hop × the predicted frames kept."""
        ids = self.tp.encode(text)
        if pad_to:
            ids = np.pad(ids, (0, max(0, pad_to - len(ids))))[:pad_to]
        dev = next(self.model.parameters()).device
        tokens = torch.from_numpy(np.asarray(ids, np.int64))[None].to(dev)
        wav, dec_lens = self.infer(tokens)
        n = int(dec_lens[0]) * self.hop
        return wav[0, :n].float().cpu().numpy()

    def export_wav(self, text: str, out_path: str) -> str:
        save_wav(out_path, self.tts(text))
        return out_path
