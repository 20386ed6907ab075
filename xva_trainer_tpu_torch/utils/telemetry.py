"""System resource telemetry: the ``/resourceUsage`` payload.

The port's copy of ``xva_trainer_tpu/utils/telemetry.py``. The reference UI
charts GPU/CPU/RAM/disk via node-nvidia-smi + node-disk-info (reference
package.json:17-26); here:

- host CPU utilization from /proc/stat deltas,
- host RAM from /proc/meminfo,
- disk usage of a watched path (shutil.disk_usage),
- the card's memory from ``torch.cuda.mem_get_info`` (used = total - free,
  every process on the card) and ``torch.cuda.memory_allocated`` (this
  process's tensors), read only once this process has a CUDA context.

Pure stdlib + torch; sampled on demand by the /resourceUsage endpoint.
"""
from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Dict, Optional

_last_cpu: Optional[tuple] = None
_cpu_lock = threading.Lock()


def _read_proc_stat() -> Optional[tuple]:
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()
        vals = [float(v) for v in parts[1:9]]
        idle = vals[3] + vals[4]  # idle + iowait
        total = sum(vals)
        return idle, total
    except (OSError, IndexError, ValueError):
        return None


def cpu_percent() -> float:
    """Utilization since the previous call (first call returns 0)."""
    global _last_cpu
    now = _read_proc_stat()
    if now is None:
        return 0.0
    with _cpu_lock:
        prev, _last_cpu = _last_cpu, now
    if prev is None:
        return 0.0
    didle = now[0] - prev[0]
    dtotal = now[1] - prev[1]
    if dtotal <= 0:
        return 0.0
    return max(0.0, min(100.0, 100.0 * (1.0 - didle / dtotal)))


def ram_usage() -> Dict[str, float]:
    total = avail = 0.0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = float(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    avail = float(line.split()[1]) * 1024
    except OSError:
        pass
    used = max(0.0, total - avail)
    return {"total_gb": total / 2**30, "used_gb": used / 2**30,
            "percent": 100.0 * used / total if total else 0.0}


def disk_usage(path: str = "/") -> Dict[str, float]:
    try:
        u = shutil.disk_usage(path)
        return {"total_gb": u.total / 2**30, "used_gb": u.used / 2**30,
                "percent": 100.0 * u.used / u.total if u.total else 0.0}
    except OSError:
        return {"total_gb": 0.0, "used_gb": 0.0, "percent": 0.0}


def device_memory() -> Dict[str, float]:
    """The card's memory in use / total (zeros before CUDA is initialized).

    Reads only an ALREADY-initialized CUDA context: this runs inside the
    /resourceUsage HTTP handler under 3 s UI polling, and a poll must never
    be what creates a context (hundreds of MB of card memory, seconds of
    start-up) in a server that has not touched the card yet. Before the
    first trainer or request uses CUDA this reports zeros."""
    try:
        import torch

        if not torch.cuda.is_initialized():
            return {"platform": "uninitialized", "used_gb": 0.0,
                    "total_gb": 0.0, "percent": 0.0}
        free, total = torch.cuda.mem_get_info()
        used = float(total - free)
        return {
            "platform": "cuda",
            "used_gb": used / 2**30,
            "total_gb": total / 2**30,
            "percent": 100.0 * used / total if total else 0.0,
            "allocated_gb": torch.cuda.memory_allocated() / 2**30,
        }
    except Exception:
        return {"platform": "unknown", "used_gb": 0.0, "total_gb": 0.0,
                "percent": 0.0}


def snapshot(disk_path: str = "/") -> Dict:
    """One sample of every channel (the /resourceUsage payload)."""
    return {
        "time": time.time(),
        "cpu_percent": cpu_percent(),
        "ram": ram_usage(),
        "disk": disk_usage(disk_path),
        "device": device_memory(),
        "pid_rss_gb": _self_rss_gb(),
    }


def _self_rss_gb() -> float:
    try:
        with open(f"/proc/{os.getpid()}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) * 1024 / 2**30
    except OSError:
        pass
    return 0.0
