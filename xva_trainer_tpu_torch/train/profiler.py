"""Profiling / tracing on ``torch.profiler``.

Counterpart of ``xva_trainer_tpu/train/profiler.py``:

- ``trace(dir)``: context manager capturing a trace of the enclosed steps.
- ``trace_start`` / ``trace_stop``: the same capture as a stateful pair, for
  the ``/profileStart`` and ``/profileStop`` server endpoints (an async
  owner that cannot hold a context manager). A second start is refused, a
  stop with nothing running is refused, and the marker clears on a failed
  stop.
- ``StepTimer``: per-step wall timing + frames/s aggregation matching the
  reference metric (Σ mel_lengths / optimizer-step time).

The activities follow the device the caller names, not what the host
happens to have: CPU and CUDA on ``cuda`` (a host without a card then
refuses the start), CPU alone on ``cpu``. A trace is written at its stop by
``torch.profiler.tensorboard_trace_handler`` as
``<dir>/<worker>.<time>.pt.trace.json``, which TensorBoard's profile plugin
and chrome://tracing read. The JAX package's ``start_profiler_server`` (a
live xprof endpoint that nothing in the app calls) has no torch
counterpart.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch

from .. import resolve_device


def _profile(log_dir: str, device) -> "torch.profiler.profile":
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    kw = {}
    try:  # the server's work runs on worker threads: record every thread's ops
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):  # a torch without the option: the caller's thread
        pass
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir), **kw)


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    os.makedirs(log_dir, exist_ok=True)
    with _profile(log_dir, device):
        yield


# ---- stateful start/stop pair ----
_active: Optional[tuple] = None  # (log_dir, profile)


def trace_start(log_dir: str, device="cuda") -> Dict:
    """Begin a trace; {'ok': bool, 'dir'/'error': ...}."""
    global _active
    if _active is not None:
        return {"ok": False, "error": "trace already running", "dir": _active[0]}
    os.makedirs(log_dir, exist_ok=True)
    try:
        prof = _profile(log_dir, device)
        prof.start()
    except Exception as e:  # no card for a cuda trace, a profiler already on, etc.
        return {"ok": False, "error": str(e)}
    _active = (log_dir, prof)
    return {"ok": True, "dir": log_dir}


def trace_stop() -> Dict:
    """End the active trace and write it. The active marker clears even when
    the stop raises: the trace is dead either way, and a sticky marker would
    wedge profiling until the process restarts."""
    global _active
    if _active is None:
        return {"ok": False, "error": "no trace running"}
    (d, prof), _active = _active, None
    try:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()  # the card's work so far lands in the trace
        prof.stop()
    except Exception as e:
        return {"ok": False, "error": str(e), "dir": d}
    return {"ok": True, "dir": d}


class StepTimer:
    def __init__(self):
        self.records: List[Dict] = []
        self._t0: Optional[float] = None
        self._frames = 0

    def start(self, frames: int = 0):
        self._t0 = time.perf_counter()
        self._frames = frames

    def stop(self, **extra) -> Dict:
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        rec = {
            "step_time_s": dt,
            "frames": self._frames,
            "frames_per_s": self._frames / dt if dt > 0 else 0.0,
            **extra,
        }
        self.records.append(rec)
        return rec

    def summary(self) -> Dict:
        if not self.records:
            return {}
        import numpy as np

        times = np.array([r["step_time_s"] for r in self.records])
        fps = np.array([r["frames_per_s"] for r in self.records])
        return {
            "steps": len(self.records),
            "mean_step_s": float(times.mean()),
            "p50_step_s": float(np.percentile(times, 50)),
            "p95_step_s": float(np.percentile(times, 95)),
            "mean_frames_per_s": float(fps.mean()),
        }
