"""Loss-delta early-stopping state machine (host logic), for the FastPitch
and HiFi-GAN trainers.

The port's copy of ``xva_trainer_tpu/train/early_stop.py`` (reference
python/fastpitch1_1/xva_train.py:915-976, python/hifigan/xva_train.py:607-649):

- the per-epoch average loss appended to a history list;
- relative deltas d_i = (L_{i-1} - L_i) / L_{i-1};
- a rolling mean over the last ``span`` deltas (20 FastPitch, 25 HiFi-GAN);
- once at least ``min_epochs`` deltas exist (FastPitch stage 2 requires 20,
  HiFi-GAN 25, else 1) and the rolling mean <= ``target_delta``, a patience
  counter increments; ``patience`` (3) consecutive hits end the stage; any
  miss resets the counter.

The per-stage target deltas depend on the dataset's size
(fastpitch1_1/xva_train.py:589-672).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class EarlyStopState:
    target_delta: float
    patience: int = 3
    span: int = 20
    min_epochs: int = 1
    avg_loss_per_epoch: List[float] = dataclasses.field(default_factory=list)
    patience_count: int = 0
    finished: bool = False
    last_delta_avg: Optional[float] = None

    def push_epoch(self, avg_loss: float) -> bool:
        """Record an epoch's average loss; returns True when the stage is done."""
        self.avg_loss_per_epoch.append(float(avg_loss))
        deltas = []
        hist = self.avg_loss_per_epoch
        for i in range(1, len(hist)):
            prev = hist[i - 1]
            deltas.append((prev - hist[i]) / prev if prev != 0 else 0.0)
        if len(deltas) >= 2:
            window = deltas if len(deltas) < self.span else deltas[-self.span :]
            self.last_delta_avg = sum(window) / len(window)
        if (
            self.last_delta_avg is not None
            and len(deltas) >= max(1, self.min_epochs)
            and self.last_delta_avg <= self.target_delta
        ):
            self.patience_count += 1
            if self.patience_count >= self.patience:
                self.finished = True
        else:
            self.patience_count = 0
        return self.finished

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


def fastpitch_target_delta(stage: int, num_data_lines: int) -> float:
    """reference python/fastpitch1_1/xva_train.py:589-672 (incl. its quirks:
    the duplicated >4000 branch means the 5e-5 stage-1 arm is dead code)."""
    n = num_data_lines
    if stage == 1:
        if n > 4000:
            td = 2e-5
        elif n > 2000:
            td = 15e-5
        elif n > 500:
            td = 4e-4
        else:
            td = 0.0
        if n < 500:
            td = 4e-4
        return td
    if stage == 2:
        td = 5e-4
        if n > 4000:
            td = 5e-5
        elif n > 2000:
            td = 1e-4
        if n < 500:
            td = 4e-3
        return td * 1.5
    if stage == 3:
        td = 6e-4
        if n > 4000:
            td = 5e-5
        elif n > 2000:
            td = 1e-4
        if n < 500:
            td = 2e-3 if n < 250 else 1e-3
        return td * 2.5
    if stage == 4:
        td = 25e-5
        if n > 4000:
            td = 35e-6
        elif n > 2000:
            td = 1e-4
        if n < 500:
            td = 15e-4 if n < 250 else 45e-5
        return td * 1.5 * 2
    raise ValueError(f"stage {stage}")


def fastpitch_min_epochs(stage: int) -> int:
    """finish_epoch requires 20 epochs of deltas in stage 2, else 1
    (reference xva_train.py:952)."""
    return 20 if stage == 2 else 1


HIFIGAN_TARGET_DELTA = 1e-4  # reference python/hifigan/xva_train.py:268
HIFIGAN_SPAN = 25
HIFIGAN_MIN_EPOCHS = 25
