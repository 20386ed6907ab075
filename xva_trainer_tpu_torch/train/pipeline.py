"""The v2 pipeline's configuration, the per-stage batch sizes, and the v2
text → mel → waveform inference.

Counterpart of part of ``xva_trainer_tpu/train/pipeline.py`` (reference:
the stage hand-off "move to hifi", python/fastpitch1_1/xva_train.py:160-162;
the inference wrapper FastPitch1_1.infer, :1172-1233). ``train_v2_pipeline``
(FastPitch stages 1-4, then the HiFi-GAN stage, with its OOM retreat) waits
for the HiFi-GAN trainer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..data.audio_io import save_wav
from ..data.text.processor import TextProcessor


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
