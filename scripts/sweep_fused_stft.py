"""Time the fused STFT kernel at other tile sizes on one NVIDIA GPU.

    python3 scripts/sweep_fused_stft.py

The kernel's tile is fixed in ``xva_trainer_tpu_torch/csrc/fused_stft.cu``:
frames a block (``TM``), warps a block (``WARPS``) and blocks an SM asked of
the register allocator (``MIN_BLOCKS``). For each tile of ``VARIANTS`` this
script writes a copy of that source with the three constants replaced into
``build/sweep_fused_stft/``, builds every copy at once with nvcc, holds each
build to the plain version on ``chip_smoke.py``'s kernel cell (8 x 230 400
samples, 897 frames each, linear output on) and times it there and at the
voice-conversion clip (173 frames, ``center=True``): the builds in turns,
forward then back, device time by CUDA graph replay with the L2 cache
evicted before every launch (``chip_smoke.device_ms``). Prints one JSON line
a build (ptxas' registers and spills, mean ms at each shape) and, last, the
card's name and power limit. Needs one CUDA device; the package's own build
and wrapper are not touched.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SOURCE = REPO / "xva_trainer_tpu_torch" / "csrc" / "fused_stft.cu"
OUT = REPO / "build" / "sweep_fused_stft"
VARIANTS = [(8, 8, 4), (16, 8, 2), (16, 16, 1), (16, 16, 2)]  # (TM, WARPS, MIN_BLOCKS)
ROUNDS = 2


def build(variant) -> tuple[ctypes.CDLL, str]:
    """Compile the source with the tile ``variant``; returns the library and
    nvcc's output."""
    from xva_trainer_tpu_torch.ops._cuda import NVCC_FLAGS

    src = SOURCE.read_text()
    for name, value in zip(("TM", "WARPS", "MIN_BLOCKS"), variant):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"{SOURCE} holds no single 'constexpr int {name}'")
    stem = "fused_stft_" + "_".join(map(str, variant))
    (OUT / f"{stem}.cu").write_text(src)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(OUT / f"{stem}.so"),
                           str(OUT / f"{stem}.cu")],
                          capture_output=True, text=True, timeout=900, check=False)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"build of {variant} failed:\n{log}")
    lib = ctypes.CDLL(str(OUT / f"{stem}.so"))
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    lib.fused_stft_forward.argtypes = [p, i64, i64, i64, p, p, p, p, p, p, p,
                                       i32, i32, i32, i32, f32, f32, p]
    lib.fused_stft_forward.restype = ctypes.c_int
    return lib, log


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_fused_stft: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from xva_trainer_tpu_torch.ops import fused_stft as fs
    from xva_trainer_tpu_torch.ops.stft import DEFAULT_MEL as cfg
    from xva_trainer_tpu_torch.ops.stft import num_frames_for, pad_for_center

    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build, VARIANTS)))

    dev = torch.device("cuda")
    tables = [torch.from_numpy(c).to(dev) for c in fs.kernel_consts(cfg)]
    waves, _, padded = cs.kernel_cell()
    shapes = {}
    for s, y, center in (("bucket", torch.from_numpy(padded).to(dev), None),
                         ("voice_convert", torch.from_numpy(waves[0]).to(dev), True)):
        nf = num_frames_for(y.shape[-1], cfg, center)
        yp = pad_for_center(y, cfg, center)
        yp = yp.reshape(-1, yp.shape[-1]).contiguous()
        ref = fs.mel_spectrogram_fused_reference(yp, cfg, center=None, return_linear=True)
        out = (torch.empty_like(ref[0]), torch.empty_like(ref[1]))
        shapes[s] = (yp, nf, ref, out)

    def run(lib, yp, nf, out):
        win, twp, tw1024, melw, span = tables
        rc = lib.fused_stft_forward(
            yp.data_ptr(), yp.shape[0], yp.shape[1], yp.shape[1], win.data_ptr(),
            twp.data_ptr(), tw1024.data_ptr(), melw.data_ptr(), span.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), nf, cfg.hop_length, cfg.n_mels, melw.numel(),
            0.0, float(cfg.clip_val), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fused_stft launch failed: CUDA error {rc}")

    flush = torch.zeros(64 * 2 ** 20 // 4, device=dev)
    times = {v: {s: [] for s in shapes} for v in VARIANTS}
    errs = {v: 0.0 for v in VARIANTS}
    for rnd in range(ROUNDS):
        for v in VARIANTS if rnd % 2 == 0 else VARIANTS[::-1]:
            lib = built[v][0]
            for s, (yp, nf, ref, out) in shapes.items():
                if rnd == 0:
                    run(lib, yp, nf, out)
                    errs[v] = max(errs[v], *((o - r).abs().max().item() for o, r in zip(out, ref)))
                times[v][s].append(cs.device_ms(lambda: run(lib, yp, nf, out), flush))
    for v in VARIANTS:
        print(json.dumps({
            "frames_per_block": v[0], "warps": v[1], "min_blocks": v[2], "max_abs_err": errs[v],
            "ptxas": [ln.strip() for ln in built[v][1].splitlines()
                      if "registers" in ln or "spill" in ln],
            **{f"{s}_ms": sum(t) / len(t) for s, t in times[v].items()},
            "runs": times[v]}), flush=True)
    print(cs.gpu_line(), flush=True)
    bad = [v for v in VARIANTS if errs[v] >= cs.TOL]
    if bad:
        print(f"sweep_fused_stft: {bad} disagree with the plain version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
