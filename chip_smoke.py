"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``xva_trainer_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version at the main path's shapes,
then drives the v3 serving path through the entry points a user calls, at
the full width of the shipped "big" xVAPitch (weights from a seed). Phases,
one JSON line each:

1. ``device``: the card, as torch and ``nvidia-smi`` name it;
2. ``kernels``: every hand-written kernel, built from source;
3. ``fused_stft``: the kernel against its plain version (Tacotron, HiFi-GAN
   and pre-padded framing, with and without the linear output, a clip under
   128 frames, an alternating signal whose energy sits in the Nyquist bin,
   silence, and a bucket of 8 clips of 2-10 s), each side's error against a
   float64 ``torch.fft.rfft`` reference, the kernel's time at the bucket and
   at the voice-conversion clip beside the plain version's and the
   ``torch.stft`` chain's (a library yardstick), each as the call's time
   seen from the host (``ms``, ``cuda_ms``) and as device time
   (``device_ms``), and its bound;
4. ``featurize``: ``featurize_batch(mode="linear")`` on that bucket, twice
   (the first call in the process, then warm), held against the CPU, with
   the host/device split of each call's wall time;
5. ``synthesize``: the model saved as a ``.pt`` and served by ``export_wav``
   for 3 requests of different texts after a warm-up request, and one more
   request under the profiler;
6. ``voice_convert``: one featurized clip through ``voice_convert``, twice,
   held against the CPU;
7. ``model_gpu_vs_cpu``: one short request through the model on the card and
   on the CPU.

Phases 4-6 are the main path: the launch counts are set to 0 just before it
and read just after it. Every comparison runs with TF32 off. Then come the
line of kernels, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before those
lines. Needs one CUDA device; imports no JAX.
"""
from __future__ import annotations

import functools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
from scipy.io import wavfile

H100_FP32_FLOPS = 67e12      # FP32 outside the tensor cores, H100 SXM data sheet
H100_HBM_BYTES_S = 3.35e12   # HBM3, H100 SXM data sheet
TOL = 1e-3                   # the repo's mean-L1 parity bar
SR = 22050
HOP = 256
REPO = os.path.dirname(os.path.abspath(__file__))
TEXTS = ["This is what my voice sounds like.",
         "The quick brown fox jumps over the lazy dog, twice.",
         "On the 3rd of May, 1999, we paid $4.50 for coffee."]


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, flush: torch.Tensor | None = None) -> float:
    """Mean time of ``fn`` in ms from CUDA events around each call, the
    host's time to issue it included (the L2 cache is flushed before each
    call by zeroing ``flush`` when given)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def device_ms(fn, flush: torch.Tensor, iters: int = 20) -> float:
    """Mean device time of one call of ``fn`` in ms, with the L2 cache cold:
    ``iters`` calls, each after a read of ``flush`` (more than the L2 holds,
    so the cache is left holding clean lines of it), are captured in one
    CUDA graph, and the graph's replay time less that of a graph of the reads
    alone is divided by ``iters``. The host's time to issue the calls is
    left out."""
    fn()  # builds, plans and caches outside the capture
    torch.cuda.synchronize()

    def replay_ms(body) -> float:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                body()
        return cuda_ms(g.replay, iters=5)

    return (replay_ms(lambda: (flush.sum(), fn())) - replay_ms(flush.sum)) / iters


def voiced_clip(rng: np.random.Generator, seconds: float) -> np.ndarray:
    """Speech-like clip: a gliding harmonic tone with pauses and breath
    noise, cut to a hop multiple."""
    n = int(seconds * SR) // HOP * HOP
    t = np.arange(n) / SR
    f0 = rng.uniform(90, 240) * (1 + 0.15 * np.sin(2 * np.pi * rng.uniform(0.3, 2) * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    y = sum(np.sin(k * phase) / k for k in range(1, 12))
    gate = (np.sin(2 * np.pi * rng.uniform(0.5, 1.5) * t) > -0.6).astype(np.float64)
    y = 0.25 * y * gate + 0.01 * rng.standard_normal(n)
    return np.clip(y, -1, 1).astype(np.float32)


def kernel_cell():
    """The kernel cell: 8 speech-like clips of 2-10 s, the same clips in one
    (8, T) array, and the bucket ``featurize_batch`` builds of them (each clip
    reflect-padded by n_fft/2 in a slot of 229 376 + 1024 samples)."""
    n_fft = 1024
    rng = np.random.default_rng(0)
    waves = [voiced_clip(rng, s) for s in np.linspace(2.0, 10.0, 8)]
    chunk = 32768
    t_slot = -(-max(len(w) for w in waves) // chunk) * chunk
    raw = np.zeros((len(waves), t_slot), np.float32)
    padded = np.zeros((len(waves), t_slot + n_fft), np.float32)  # featurize_batch's buffer
    for i, w in enumerate(waves):
        raw[i, :len(w)] = w
        padded[i, :len(w) + n_fft] = np.pad(w, (n_fft // 2,) * 2, mode="reflect")
    return waves, raw, padded


def rfft_reference(y: torch.Tensor, cfg, center, mag_eps: float):
    """(log-mel, linear) of ``mel_spectrogram_fused``'s function in float64
    by ``torch.fft.rfft``: what tells which side is off where the kernel and
    the plain version (an FP32 DFT product) disagree."""
    from xva_trainer_tpu_torch.ops.mel import mel_filterbank
    from xva_trainer_tpu_torch.ops.stft import (frame_signal, hann_window, num_frames_for,
                                                pad_for_center)

    nf = num_frames_for(y.shape[-1], cfg, center)
    yp = pad_for_center(y.double(), cfg, center)
    yp = yp.reshape(-1, yp.shape[-1])
    need = (nf - 1) * cfg.hop_length + cfg.n_fft
    yp = torch.nn.functional.pad(yp, (0, max(0, need - yp.shape[-1])))
    w = torch.from_numpy(hann_window(cfg.win_length, cfg.n_fft, np.float64)).to(y.device)
    spec = torch.fft.rfft(frame_signal(yp, cfg.n_fft, cfg.hop_length, nf) * w, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + mag_eps)
    fb = torch.from_numpy(mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin,
                                         cfg.fmax).astype(np.float64)).to(y.device)
    mel = torch.log(torch.clamp(mag @ fb.T, min=cfg.clip_val)).transpose(1, 2)
    mag = mag.transpose(1, 2)
    return (mel[0], mag[0]) if y.dim() == 1 else (mel, mag)


def profiled(fn):
    """Run ``fn`` once under ``torch.profiler``. Returns its result and the
    wall ms, the device busy ms (the union of kernel intervals), the host
    share of the wall time and the kernel count. A profiler that does not
    start is reported, not failed; a failure of ``fn`` fails the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, {"wall_ms": (time.perf_counter() - t0) * 1e3,
                     "device": f"not measured (the profiler did not start: {e})"}
    try:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        prof.stop()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return out, {"wall_ms": wall_ms, "device": "not measured (the trace holds no kernel)"}
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    return out, {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
                 "host_share": 1.0 - busy_us / 1e3 / wall_ms, "kernels": len(spans)}


def seeded_model(cfg, seed: int):
    """An XVAPitch with weights from seeded generators: the modules' own
    initialisation under ``torch.manual_seed``, and the parameters that start
    at zero (the duration predictor's spline projections and affine flows,
    LayerNorm shifts) drawn from N(0, 0.1), so that durations depend on the
    text and every weight is used."""
    from xva_trainer_tpu_torch.models.xvapitch import XVAPitch

    torch.manual_seed(seed)
    model = XVAPitch(cfg).eval()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return model


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from xva_trainer_tpu_torch.models.xvapitch import XVAPitchConfig
    from xva_trainer_tpu_torch.ops import _cuda
    from xva_trainer_tpu_torch.ops import fused_stft as fs
    from xva_trainer_tpu_torch.ops.features import featurize_batch
    from xva_trainer_tpu_torch.ops.stft import DEFAULT_MEL, mel_basis
    from xva_trainer_tpu_torch.serve import (export_wav, load_xvapitch, synthesize_v3,
                                             text_tokens, voice_convert)

    dev = torch.device("cuda")
    smi = gpu_line()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 2. kernels ----
    t0 = time.perf_counter()
    logs = {name: _cuda.build(name) for name in _cuda.KERNELS}
    emit("kernels", kernels=list(_cuda.KERNELS), build_seconds=time.perf_counter() - t0,
         ptxas={k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
                for k, v in logs.items()})

    # ---- 3. fused_stft: the kernel against its plain version ----
    cfg = DEFAULT_MEL
    waves, raw, padded = kernel_cell()
    raw_d, bucket = torch.from_numpy(raw).to(dev), torch.from_numpy(padded).to(dev)
    short = torch.from_numpy(waves[0][:100 * HOP]).to(dev)  # (T,), 101 frames
    nyquist = torch.from_numpy(0.5 * (-1.0) ** np.arange(32 * HOP)).float().to(dev)
    silence = torch.zeros((2, 32 * HOP), device=dev)
    cases, max_err, mean_err = [], 0.0, 0.0
    for name, y, center, eps in (("tacotron", raw_d, True, 0.0),
                                 ("hifigan", raw_d, False, 1e-9),
                                 ("prepadded", bucket, None, 0.0),
                                 ("short", short, True, 0.0),
                                 ("nyquist", nyquist, True, 0.0),
                                 ("silence", silence, True, 0.0)):
        f64 = rfft_reference(y, cfg, center, eps)
        for lin in (True, False):
            kw = dict(center=center, mag_eps=eps, return_linear=lin)
            out = fs.mel_spectrogram_fused(y, cfg, **kw)
            ref = fs.mel_spectrogram_fused_reference(y, cfg, **kw)
            torch.cuda.synchronize()
            for part, o, r, r64 in zip(("mel", "linear"),
                                       *((out, ref) if lin else ([out], [ref])), f64):
                d = (o - r).abs()
                mx, mean = d.max().item(), d.mean().item()
                max_err, mean_err = max(max_err, mx), max(mean_err, mean)
                cases.append({"case": name, "output": part, "linear_on": lin,
                              "shape": list(o.shape), "mean_abs_err": mean, "max_abs_err": mx,
                              "kernel_max_abs_err_vs_f64": (o.double() - r64).abs().max().item(),
                              "plain_max_abs_err_vs_f64": (r.double() - r64).abs().max().item()})
                # the max bar too: a wrong bin or frame tile hides in the mean
                check(mean < TOL and mx < TOL and bool(torch.isfinite(o).all())
                      and o.shape == r.shape,
                      f"fused_stft {name} {kw} {part}: mean {mean} max {mx}")
    # The bound counts what the function needs: the input read once and both
    # outputs written once; per frame, the window, a real FFT (2.5 N log2 N),
    # the magnitudes (4 per bin), 2 per nonzero mel weight, the clamp and log.
    # kernel_gflop counts the kernel's own arithmetic instead, per frame: the
    # window (1024), three radix-8 passes of 64 butterflies (56 each) with 7
    # complex twiddle products (6 each) in the last two, 21 per bin to turn
    # the 512-point complex FFT into bins and magnitudes (4 for the Nyquist
    # bin), and the sparse mel product.
    fb = mel_basis(cfg, dev)
    mel_nnz = int((fb != 0).sum())
    n = cfg.n_fft

    def bound(B, T, F):
        flops = B * F * (n + 2.5 * n * np.log2(n) + 4 * cfg.n_freqs + 2 * mel_nnz
                         + 2 * cfg.n_mels)
        nbytes = 4 * (B * T + B * F * (cfg.n_mels + cfg.n_freqs))
        t_ops, t_bytes = flops / H100_FP32_FLOPS * 1e3, nbytes / H100_HBM_BYTES_S * 1e3
        return flops, nbytes, max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

    B, T = bucket.shape
    F = 1 + (T - n) // cfg.hop_length
    flops, nbytes, bound_ms, bound_by = bound(B, T, F)
    kernel_flops = B * F * (n + 3 * 64 * 56 + 2 * 64 * 7 * 6 + 512 * 21 + 4 + 2 * mel_nnz
                            + 2 * cfg.n_mels)
    flush = torch.zeros(64 * 2 ** 20 // 4, device=dev)  # more than the 50 MB L2
    window = torch.hann_window(cfg.win_length, periodic=True, device=dev)

    def library(y, center):  # the torch.stft → magnitude → mel matmul → log chain
        spec = torch.stft(y, cfg.n_fft, cfg.hop_length, window=window, center=center,
                          pad_mode="reflect", return_complex=True).abs()
        return torch.log(torch.clamp(fb @ spec, min=cfg.clip_val)), spec

    fns = {"ms": lambda y, c: fs.mel_spectrogram_fused(y, cfg, center=c, return_linear=True),
           "plain_ms": lambda y, c: fs.mel_spectrogram_fused_reference(y, cfg, center=c,
                                                                       return_linear=True),
           "library_ms": library}
    vc_clip = torch.from_numpy(waves[0]).to(dev)  # voice conversion's clip: (T,), 173 frames
    # "ms": the call as the host sees it, timed as in earlier runs (CUDA
    # events around the call, after zeroing the flush buffer); "device_ms":
    # device time by graph replay, after a read of the flush buffer
    timing = {}
    for shape, y, center in (("bucket", bucket, None), ("voice_convert", vc_clip, True)):
        runs = {key: [] for k in fns for key in (k, k.replace("ms", "device_ms"))}
        for order in (list(fns), list(fns)[::-1]):  # in turns, forward then back
            for k in order:
                call = functools.partial(fns[k], y, center)
                runs[k].append(cuda_ms(call, flush=flush))
                runs[k.replace("ms", "device_ms")].append(device_ms(call, flush))
        timing[shape] = {k: sum(v) / len(v) for k, v in runs.items()}
        timing[shape]["runs"] = runs
    vc_frames = 1 + vc_clip.shape[0] // cfg.hop_length
    _, vc_bytes, vc_bound_ms, _ = bound(1, vc_clip.shape[0], vc_frames)
    timing["voice_convert"].update(frames=vc_frames, bound_ms=vc_bound_ms)
    for t, b_ms, b_bytes in ((timing["bucket"], bound_ms, nbytes),
                             (timing["voice_convert"], vc_bound_ms, vc_bytes)):
        for key in ("ms", "device_ms"):
            t[f"bound_share_of_{key}"] = b_ms / t[key]
            t[f"gb_per_s_of_{key}"] = b_bytes / t[key] / 1e6
    # a yardstick of the card's write rate: PyTorch's own fill of as many
    # bytes as the bucket's linear output, and of 8 times as many, which
    # tells the rate from a launch's fixed cost
    tb = timing["bucket"]
    for key, times in (("linear_fill", 1), ("linear_fill_8x", 8)):
        buf = torch.empty((times * B, cfg.n_freqs, F), device=dev)
        tb[f"{key}_ms"] = device_ms(functools.partial(buf.fill_, 0.0), flush)
        tb[f"{key}_gb_per_s"] = 4 * buf.numel() / tb[f"{key}_ms"] / 1e6
    emit("fused_stft", bucket=[B, T], frames=F, cases=cases, max_abs_err=max_err,
         mean_abs_err=mean_err, timing=timing, library="torch.stft + abs + mel matmul + log",
         gflop=flops / 1e9, mel_nnz=mel_nnz, mbytes=nbytes / 1e6, bound_ms=bound_ms,
         bound_by=bound_by, kernel_gflop=kernel_flops / 1e9,
         kernel_ops_ms=kernel_flops / H100_FP32_FLOPS * 1e3, gpu=smi)

    # ---- the main path: 4. featurize → 5. synthesize → 6. voice_convert ----
    _cuda.reset_launch_counts()
    # the first call in the process, then the same call again
    feats, cold = profiled(lambda: featurize_batch(waves, mode="linear", device="cuda"))
    _, warm = profiled(lambda: featurize_batch(waves, mode="linear", device="cuda"))
    launches_per_call = _cuda.LAUNCHES["fused_stft"] / 2
    ref_feats = featurize_batch(waves, mode="linear", device="cpu")
    spec_err = max(float(np.abs(a["linear"] - b["linear"]).mean())
                   for a, b in zip(feats, ref_feats))
    va = np.concatenate([a["pitch"] > 0 for a in feats])
    vb = np.concatenate([b["pitch"] > 0 for b in ref_feats])
    both = va & vb
    pa = np.concatenate([a["pitch"] for a in feats])[both]
    pb = np.concatenate([b["pitch"] for b in ref_feats])[both]
    f0_rel = float(np.max(np.abs(pa - pb) / pb)) if both.any() else 0.0
    shapes = [list(f["linear"].shape) for f in feats]
    emit("featurize", clips=len(waves), seconds=[len(w) / SR for w in waves], shapes=shapes,
         cold=cold, warm=warm, launches_per_call=launches_per_call, spec_mean_abs_err=spec_err,
         voicing_agreement=float((va == vb).mean()), voiced_frames=int(va.sum()),
         f0_max_rel_err=f0_rel)
    check(spec_err < TOL and all(s == [513, len(w) // HOP] for s, w in zip(shapes, waves))
          and all(np.isfinite(f["linear"]).all() for f in feats),
          f"featurize: spec err {spec_err} or shapes {shapes}")

    cfg_m = XVAPitchConfig()
    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ckpt = os.path.join(work, "voice.pt")
    # the xVASynth export format: a flat reference-named fp16 state dict
    torch.save({k: v.half() for k, v in seeded_model(cfg_m, 0).state_dict().items()}, ckpt)
    emb = np.random.default_rng(2).standard_normal(512).astype(np.float32)
    emb /= np.linalg.norm(emb)
    t0 = time.perf_counter()
    export_wav({"xvap_ckpt": ckpt, "out_path": os.path.join(work, "warm.wav"), "emb": emb,
                "text": "Warm up."}, cfg=cfg_m, device="cuda")
    torch.cuda.synchronize()
    load_and_warm_s = time.perf_counter() - t0
    requests = []
    for i, text in enumerate(TEXTS):
        out = os.path.join(work, f"r{i}.wav")
        t0 = time.perf_counter()
        export_wav({"xvap_ckpt": ckpt, "out_path": out, "text": text, "emb": emb.tolist(),
                    "lang": "en"}, cfg=cfg_m, device="cuda")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        sr, pcm = wavfile.read(out)
        audio_s = len(pcm) / sr
        requests.append({"text": text, "seconds": sec, "audio_seconds": audio_s,
                         "real_time_factor": sec / audio_s if audio_s else None,
                         "samples": len(pcm), "peak": int(np.abs(pcm).max()) if len(pcm) else 0})
        check(sr == SR and len(pcm) > 0 and len(pcm) % HOP == 0 and np.abs(pcm).max() > 0,
              f"synthesize: request {i} wrote {len(pcm)} samples at {sr} Hz")
    model = load_xvapitch(ckpt, cfg_m, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    _, prof = profiled(lambda: synthesize_v3(model, TEXTS[1], emb, "en"))
    emit("synthesize", config="XVAPitchConfig() (big, latent 256), seeded weights",
         params=n_params, load_and_warm_up_seconds=load_and_warm_s, requests=requests,
         profiled_request=prof)

    src = np.random.default_rng(3).standard_normal(512).astype(np.float32)
    clip = waves[0]
    vc_s = []
    for _ in range(2):  # the first call at this length, then the same call again
        t0 = time.perf_counter()
        vc = voice_convert(model, clip, src, emb)
        torch.cuda.synchronize()
        vc_s.append(time.perf_counter() - t0)
    launches = dict(_cuda.LAUNCHES)  # the end of the main path
    model_cpu = load_xvapitch(ckpt, cfg_m, device="cpu")
    vc_cpu = voice_convert(model_cpu, clip, src, emb)
    vc_err, vc_ref = float(np.abs(vc - vc_cpu).mean()), float(np.abs(vc_cpu).mean())
    emit("voice_convert", clip_seconds=len(clip) / SR, frames=len(clip) // HOP + 1,
         samples=len(vc), seconds_cold=vc_s[0], seconds_warm=vc_s[1], mean_abs_err_vs_cpu=vc_err,
         max_abs_err_vs_cpu=float(np.abs(vc - vc_cpu).max()), cpu_mean_abs=vc_ref)
    # absolute and relative to the waveform's size, as the CPU tests hold it
    check(np.isfinite(vc).all() and len(vc) == (len(clip) // HOP + 1) * HOP and vc_err < TOL
          and vc_err < TOL * vc_ref,
          f"voice_convert: {len(vc)} samples, mean err vs CPU {vc_err}, CPU mean |wav| {vc_ref}")

    # ---- 7. model_gpu_vs_cpu: one short request, the full model on both ----
    tokens = torch.from_numpy(text_tokens("Hello there.", "en"))[None]
    g = torch.Generator().manual_seed(5)
    dp_noise = torch.randn((1, 2, tokens.shape[1]), generator=g)
    noise = torch.randn((1, cfg_m.latent_size, 64), generator=g)
    dvec, lang = torch.from_numpy(emb)[None], torch.tensor([5])
    outs = {}
    for name, m, d in (("gpu", model, dev), ("cpu", model_cpu, torch.device("cpu"))):
        o = m.infer(tokens.to(d), dvec.to(d), lang.to(d), max_frames=64,
                    noise=noise.to(d), dp_noise=dp_noise.to(d))
        outs[name] = {k: v.cpu() for k, v in o.items()}
    a, b = outs["gpu"], outs["cpu"]
    same_durations = torch.equal(a["durations"], b["durations"])
    diff = float((a["wav"] - b["wav"]).abs().max())
    mean_diff, ref_mean = float((a["wav"] - b["wav"]).abs().mean()), float(b["wav"].abs().mean())
    frames = int(a["y_lengths"][0])
    emit("model_gpu_vs_cpu", frames=frames, same_durations=same_durations,
         max_abs_diff=diff, mean_abs_diff=mean_diff, cpu_mean_abs=ref_mean,
         logw_max_abs_diff=float((a["logw"] - b["logw"]).abs().max()))
    check(same_durations and frames <= 64 and diff < TOL and mean_diff < TOL * ref_mean
          and bool(torch.isfinite(a["wav"]).all()),
          f"model_gpu_vs_cpu: durations equal {same_durations}, max abs diff {diff}, "
          f"mean abs diff {mean_diff}, CPU mean |wav| {ref_mean}")
    shutil.rmtree(work, ignore_errors=True)

    kernels = [{
        "name": "fused_stft", "route": "cuda",
        "source": "xva_trainer_tpu_torch/csrc/fused_stft.cu",
        "replaces": "xva_trainer_tpu/ops/pallas_stft.py:127",
        "launches": launches["fused_stft"], "max_abs_err": max_err, "ms": tb["ms"],
        "plain_ms": tb["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": tb["library_ms"], "device_ms": tb["device_ms"],
        "plain_device_ms": tb["plain_device_ms"], "library_device_ms": tb["library_device_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    missing = [k["name"] for k in kernels if k["launches"] < 1]
    check(not missing, f"the main path launched no {missing}")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # report and fail: no result line
        import traceback

        traceback.print_exc()
        print(f"chip_smoke failed: {e}", file=sys.stderr)
        sys.exit(1)
