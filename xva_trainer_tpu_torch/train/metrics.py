"""Training observability: training.log, graphs.json, frames a second and
TensorBoard scalars.

The port's copy of ``xva_trainer_tpu/train/metrics.py`` (standard library
only): the same files, byte for byte, for the same calls. The reference UI
tails a per-dataset ``training.log`` (rewritten whole with a live status
line — print_and_log, python/xvapitch/xva_train.py:260-273) and charts
``graphs.json`` per-stage loss/loss-delta series with target_delta
(init_logs :464-496, writes :777-802).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional


class TrainingLogger:
    """print_and_log-compatible: full log + a mutable last status line."""

    def __init__(self, output_dir: str, also_print: bool = True, write: bool = True):
        """``write=False`` keeps the log in memory only (a data-parallel
        rank other than 0)."""
        self.output_dir = output_dir
        self.write = write
        if write:
            os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "training.log")
        self.lines: List[str] = []
        if write and os.path.exists(self.path):
            with open(self.path, encoding="utf-8") as f:
                self.lines = f.read().split("\n")
        self.status: str = ""
        self.also_print = also_print

    def log(self, line: str) -> None:
        self.lines.append(line)
        if self.also_print:
            print(line, flush=True)
        self._flush()

    def set_status(self, line: str) -> None:
        self.status = line
        self._flush()

    def _flush(self) -> None:
        if not self.write:
            return
        with open(self.path, "w", encoding="utf-8") as f:
            f.write("\n".join(self.lines + ([self.status] if self.status else [])))


class GraphsWriter:
    """graphs.json: {"stages": {stage: {loss: [[iter, v]...],
    loss_delta: [[iter, v]...], target_delta: t}}}."""

    def __init__(self, output_dir: str, stages, target_deltas: Dict[int, float],
                 write: bool = True):
        self.path = os.path.join(output_dir, "graphs.json")
        self.write = write
        if write:
            os.makedirs(output_dir, exist_ok=True)
        if write and os.path.exists(self.path):
            with open(self.path) as f:
                self.data = json.load(f)
        else:
            self.data = {"stages": {}}
        for s in stages:
            self.data["stages"].setdefault(
                str(s),
                {"loss": [], "loss_delta": [],
                 "target_delta": target_deltas.get(s, 0.0)},
            )

    def add_loss(self, stage: int, it: int, loss: float) -> None:
        self.data["stages"][str(stage)]["loss"].append([it, float(loss)])
        self._flush()

    def add_delta(self, stage: int, it: int, delta: float) -> None:
        self.data["stages"][str(stage)]["loss_delta"].append([it, float(delta)])
        self._flush()

    def _flush(self) -> None:
        if not self.write:
            return
        with open(self.path, "w") as f:
            json.dump(self.data, f)


class ThroughputMeter:
    """frames/s per optimizer step (reference xva_train.py:645,751-753)."""

    def __init__(self):
        self.t0: Optional[float] = None
        self.frames = 0
        self.history: List[float] = []

    def start(self):
        self.t0 = time.perf_counter()
        self.frames = 0

    def add_frames(self, n: int):
        self.frames += int(n)

    def step(self) -> float:
        now = time.perf_counter()
        fps = self.frames / max(now - (self.t0 or now), 1e-9)
        self.history.append(fps)
        self.t0 = now
        self.frames = 0
        return fps

    def mean(self) -> float:
        return sum(self.history) / len(self.history) if self.history else 0.0


def make_tensorboard(output_dir: str):
    """The TensorBoard scalar writer of ``tb_writer.py`` under
    ``<output_dir>/tb`` (reference setup_training_modules :1238 used torch's
    SummaryWriter; this writes the same event-file format), or None when the
    directory cannot be made."""
    try:
        from .tb_writer import ScalarWriter

        return ScalarWriter(os.path.join(output_dir, "tb"), flush_secs=30)
    except Exception:
        return None
