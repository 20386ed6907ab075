"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``xva_trainer_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version at the main paths' shapes,
then drives the v3 serving path, the v3 data path, the v3 trainer loop, the
v3 fine-tune with priors in other languages, the v2 FastPitch fine-tune
with its preview and v2 inference, the v2 HiFi-GAN stage and the v2
pipeline to both exports, the task server with a v3 and a v2 job, the 13
dataset tools over the server's websocket, and the v3 training step
through the entry points a user calls, at the full width of the shipped
"big" xVAPitch, of the speaker encoder, of ``FastPitchConfig()`` and of ``HifiganConfig()`` with
``HifiganDiscriminator()`` (weights from a seed). Phases, one JSON line
each:

1. ``device``: the card, as torch and ``nvidia-smi`` name it;
2. ``kernels``: every hand-written kernel, built from source;
3. ``fused_stft``: the kernel against its plain version (Tacotron, HiFi-GAN
   and pre-padded framing, with and without the linear output, a clip under
   128 frames, an alternating signal whose energy sits in the Nyquist bin,
   silence, a bucket of 8 clips of 2-10 s, and the HiFi-GAN loss mel's full
   band, ``LOSS_MEL``), each side's error against a
   float64 ``torch.fft.rfft`` reference, the kernel's time at the bucket and
   at the voice-conversion clip beside the plain version's and the
   ``torch.stft`` chain's (a library yardstick), each as the call's time
   seen from the host (``ms``, ``cuda_ms``) and as device time
   (``device_ms``), and its bound; the same three at the train step's own
   shapes (``materialize_spec``'s 64 x 196 608 samples with the linear
   output, the mel loss's 64 x 8 192, mel only) and at the HiFi-GAN step's
   (16 x 8 192, mel only, under ``MelConfig()`` and ``LOSS_MEL``), the
   kernel held to its plain version at each of these four shapes too;
4. ``featurize``: ``featurize_batch(mode="linear")`` on that bucket, twice
   (the first call in the process, then warm), held against the CPU, with
   the host/device split of each call's wall time;
5. ``synthesize``: the model saved as a reference-layout ``.pt`` and served
   by ``export_wav`` (which converts the layout)
   for 3 requests of different texts after a warm-up request, and one more
   request under the profiler;
6. ``voice_convert``: one featurized clip through ``voice_convert``, twice,
   held against the CPU;
7. ``model_gpu_vs_cpu``: one short request through the model on the card and
   on the CPU;
8. ``mas``: the MAS kernel against its plain version, paths identical, in
   16 cases (``mas_case``), each in the four value/mask type pairs; its
   time at the trainer's largest bucket (B = 64, 192 tokens x 768 frames,
   ragged) beside the plain version's, at the four v3 buckets, each with
   its bound at the items' own lengths and the full tensors', and at the
   five v2 buckets at FastPitch's stage-1 batch of 46, bf16 values;
9. ``train_gpu_vs_cpu``: one fp32 step (AMP and TF32 off, SGD on both
   models) of the full-width model and discriminator at B = 2 on the
   64 x 256 bucket, from the same weights, batch and draws, on the card and
   on the CPU, and on each again with PyTorch's native convolutions: losses
   within 1e-3 relative; each card step's updates within the bar of
   ``update_mismatch`` (1e-3 of each update's max abs, plus float floors) of
   the nearer CPU step's, times the CPU noise scale: how far the CPU's two
   convolution implementations miss that bar against each other (a few
   decoder biases do), measured on the CPU alone. Every parameter past the
   bar itself is listed;
10. ``train_amp_vs_fp32``: the same step under bf16 AMP, its loss within 5%
   of the fp32 step's;
11. ``train_freeze``: one AdamW step with ``freeze_post_dec`` and one with
   ``hifi_only``: frozen parameters bit-identical;
12. ``train_step``: the trainer's step as it runs (AMP, the AdamW pair with
   its 7-step accumulation, dropout on, draws from a CUDA generator) at
   B = 64 on the 192 x 768 bucket, or the largest batch that fits: 2 warm-up
   and 3 timed steps, frames a second, peak memory, the host's share of one
   profiled step, every loss component, and each kernel's launches a step;
13. ``data`` (run after phase 7, before phase 9): the v3 data path from a
   seeded dataset on disk (256 voiced clips, 64 in each v3 bucket, English
   text) to the training step: ``preprocess_audio`` →
   ``extract_speaker_embeddings`` → ``XvaFeatureCache.build`` (the fused
   STFT kernel, one launch a group of 8 clips, under the profiler) →
   ``get_dataset_embedding`` → ``XvaBatcher`` (``device_spec``) → one epoch
   through a ``Prefetcher`` with ``batch_to_device`` → one AMP step a
   bucket's batch (128, 128, 96 and 64 items) at full width. Then cached
   items against the CPU, speaker embeddings against the CPU, and a host
   spectrogram batch against the ``device_spec`` one. Each stage's wall
   time, the build's rates, split and host share, collate and wait times,
   each step's time and peak memory;
14. ``train_loop`` (after phase 13, on its dataset, cache and embeddings):
   ``XVAPitchTrainer`` at full width with the default config but a
   checkpoint every update (AdamW, AMP, target batch 400, ``gam`` from the
   batcher's mean batch), warm-started from phase 5's reference-layout
   ``.pt`` (effective weights held to the file's); ``train(max_steps=3)``
   with the loss-seeding pass; a second trainer resumed from the directory,
   bit-identical to the first, taking a 4th update; the window of
   checkpoints (2, 3, then 3, 4); the export, loaded strictly and served by
   ``export_wav``; two previews; one more update under the profiler. Each
   micro-step's ms by bucket, each update's seconds with and without its
   checkpoint write, the meter's frames a second, the prefetch wait, each
   checkpoint's seconds and bytes, the resume's and the export's, peak
   memory (``train_loop_phase``);
15. ``cache_build_shapes``: the fused STFT kernel, its plain version and
   the ``torch.stft`` chain at the cache build's six slot lengths (8 clips,
   33 792 to 197 632 samples, pre-padded, linear on), summed over the
   build's 32 groups;
16. ``multilingual`` (after phase 14, before phase 15): a French fine-tune
   with Italian and Romanian priors through the multilingual text front end
   (``XVA_TEXT_DIR`` an empty directory, so the port's shipped tiers), each
   dataset tokenized in its own language: ``preprocess_audio`` →
   ``pre_cache_g2p`` → speaker embeddings → three cache builds →
   ``XVAPitchTrainer`` with a priors batcher weighted by language, warm
   started from phase 5's ``.pt``: finetune, finetune and priors updates
   in stage 1, then finetune and priors in stage 2 → the export → a French
   ``export_wav`` request (``multilingual_phase``);
17. ``fastpitch`` (after phase 16, on the ``data`` phase's wavs and 64
   longer ones): the v2 path as the JAX package's v2 pipeline runs
   FastPitch, at full width: the v2 ``FeatureCache`` build → a batcher a
   stage (``stage_batch_size``, the ARPAbet mix) → ``FastPitchTrainer``
   warm-started from a seeded base ``.pt`` → stages 1-4, two epochs each,
   each ended by its own hand-off (durations extracted after stage 1) → a
   bit-identical resume and one more epoch → the export → Griffin-Lim
   previews → three ``V2InferenceModel`` requests with a seeded v2 HiFi-GAN
   generator; before it, an fp32 stage-1 and stage-3 step on the card
   against the CPU (``fastpitch_phase``);
18. ``hifigan`` (after phase 17, on its dataset): the GAN step at full
   width in both orders on the card against a float64 step on the card
   and the CPU (fp32) and under AMP,
   a warm start from seeded reference-layout ``g_``/``do_`` files, then
   ``train_v2_pipeline`` from a copy of the dataset (the v2 cache build,
   two FastPitch epochs, the export, two HiFi-GAN epochs at B = 16, the
   ``.hg.pt`` export), a bit-identical resume and one more epoch, three v2
   requests on the two exports, and a profiled pass (``hifigan_phase``).
   ``cache_build_shapes`` (phase 15) also times the v2 build's slots;
19. ``server`` (after phase 18, on the ``data`` phase's clips and phase 18's
   copy of the v2 dataset): the port's task server (``AppServer``,
   ``serve_with_http``) on two localhost ports, driven over HTTP and its
   websocket as the UI drives it: a full-width v3 fine-tune through every
   stage with a warm start, a v2 job queued behind it, pause and resume,
   ``stop`` of the v2 job after its first HiFi-GAN epoch, the v3 job resumed
   to the queue's ``tasks_next``, ``/exportWav`` from the server's restored
   checkpoint (equal to ``synthesize_v3`` on the trainer's model) and from
   the exported ``.pt``, ``/exportVoice``, ``/resourceUsage``, a profiled
   request and ``/stopServer`` (``server_phase``);
20. ``tools`` (after phase 19, on the ``data`` phase's clips): the 13
   dataset tools of the port, each a ``runTask`` over the server's
   websocket as the UI's tools panel sends it, with the server on the card:
   the eight audio tools on the 256 clips (64 as 44.1 kHz stereo wavs, 32
   as FLAC), a 10-minute recording with its ``.srt`` and 16 PCM ``.wem``
   (and Vorbis ones where libvorbisenc is present); ``cluster_speakers``
   (k-means and affinity propagation), ``speaker_search``,
   ``speaker_cluster_search`` and ``diarization`` of two 3-minute
   recordings (3 and 5 speakers, auto-k) and the DER harness's own two,
   with the server's speaker encoder
   on the card; ``wer_evaluation``; a recording uploaded with noise removal
   on; then a profiled ``speaker_search``; held to the CPU (embeddings,
   partitions, the search order, diarization turns) and to the DER
   harness's bars (``tools_phase``).

Phases 4-6 are the serving path, phase 13's path the data path, phase 14's
seeding pass and four updates the loop path, phase 16's path from
``preprocess_audio`` to the French request the multilingual path, phase
17's path from the cache build to the last v2 request the fastpitch path,
phase 18's from ``train_v2_pipeline`` to its last v2 request the hifigan
path, phase 19's from its first ``startTraining`` to ``/stopServer`` the
server path, phase 20's from its first ``runTask`` to the uploaded
recording the tools path (which launches neither kernel: no tool computes
an STFT mel or an alignment), and phase 12's timed steps the training
path: the launch counts are set to 0 just before each and read just after
it. Every comparison runs with TF32 off.
Then come the line of kernels, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before those
lines. Needs one CUDA device; imports no JAX.
"""
from __future__ import annotations

import base64
import functools
import gzip
import hashlib
import json
import math
import os
import queue
import re
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from scipy.io import wavfile

H100_FP32_FLOPS = 67e12      # FP32 outside the tensor cores, H100 SXM data sheet
H100_HBM_BYTES_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_BOOST_HZ = 1.98e9       # H100 SXM maximum SM clock
FP32_OP_CYCLES = 4           # latency of one dependent fp32 add or max
TOL = 1e-3                   # the repo's mean-L1 parity bar
SR = 22050
HOP = 256
REPO = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()  # each phase line gives the seconds since the script started
TEXTS = ["This is what my voice sounds like.",
         "The quick brown fox jumps over the lazy dog, twice.",
         "On the 3rd of May, 1999, we paid $4.50 for coffee."]


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw, "elapsed_s": time.perf_counter() - T0}), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


class WsClient:
    """A small RFC 6455 client on a stdlib socket: the opening handshake
    (its ``Sec-WebSocket-Accept`` checked), masked text frames out, frames
    in (a ping answered with a pong). ``start_reader`` moves the receiving
    to a thread that puts ``(time, text)`` on ``events``."""

    GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

    def __init__(self, port: int, host: str = "localhost", timeout: float = 60.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((f"GET / HTTP/1.1\r\nHost: {host}:{port}\r\nUpgrade: websocket\r\n"
                           "Connection: Upgrade\r\nSec-WebSocket-Version: 13\r\n"
                           f"Sec-WebSocket-Key: {key}\r\n\r\n").encode())
        head = b""
        while b"\r\n\r\n" not in head:
            chunk = self.sock.recv(1)
            if not chunk:
                raise ConnectionError("websocket handshake: connection closed")
            head += chunk
        lines = head.decode("latin-1").split("\r\n")
        want = base64.b64encode(hashlib.sha1((key + self.GUID).encode()).digest()).decode()
        accept = [ln.split(":", 1)[1].strip() for ln in lines
                  if ln.lower().startswith("sec-websocket-accept:")]
        if not lines[0].startswith("HTTP/1.1 101") or accept != [want]:
            raise ConnectionError(f"websocket handshake refused: {lines}")
        self.events: "queue.Queue" = queue.Queue()
        self._reader = None
        self._send_lock = threading.Lock()

    def _read(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("websocket: connection closed")
            buf += chunk
        return buf

    def send_frame(self, opcode: int, payload: bytes, masked: bool = True, fin: bool = True):
        n = len(payload)
        head = bytes([(0x80 if fin else 0) | opcode])
        bit = 0x80 if masked else 0
        if n < 126:
            head += bytes([bit | n])
        elif n < 2 ** 16:
            head += bytes([bit | 126]) + struct.pack("!H", n)
        else:
            head += bytes([bit | 127]) + struct.pack("!Q", n)
        if masked:
            mask = os.urandom(4)
            key = (mask * (n // 4 + 1))[:n]
            payload = mask + (int.from_bytes(payload, "big") ^ int.from_bytes(key, "big")
                              ).to_bytes(n, "big") if n else mask
        with self._send_lock:
            self.sock.sendall(head + payload)

    def send(self, text: str) -> None:
        self.send_frame(0x1, text.encode("utf-8"))

    def send_json(self, **msg) -> None:
        self.send(json.dumps(msg))

    def recv_frame(self):
        """(opcode, payload) of the next frame; the server's are unmasked."""
        b0, b1 = self._read(2)
        n = b1 & 0x7F
        if n == 126:
            (n,) = struct.unpack("!H", self._read(2))
        elif n == 127:
            (n,) = struct.unpack("!Q", self._read(8))
        if b1 & 0x80:
            raise ConnectionError("websocket: the server masked a frame")
        return b0 & 0x0F, self._read(n)

    def recv(self) -> str:
        """The next text message (a ping is answered; a close raises)."""
        while True:
            op, payload = self.recv_frame()
            if op == 0x9:
                self.send_frame(0xA, payload)
            elif op == 0x8:
                raise ConnectionError(f"websocket closed by the server: {payload[:2].hex()}")
            elif op == 0x1:
                return payload.decode("utf-8")

    def start_reader(self) -> None:
        def run():
            try:
                while True:
                    msg = self.recv()
                    self.events.put((time.perf_counter(), msg))
            except (ConnectionError, OSError):
                pass

        self.sock.settimeout(None)
        self._reader = threading.Thread(target=run, daemon=True)
        self._reader.start()

    def close(self) -> None:
        try:
            self.send_frame(0x8, struct.pack("!H", 1000))
        except OSError:
            pass
        self.sock.close()
        if self._reader is not None:
            self._reader.join(timeout=10)


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


def profiled(fn, named=()):
    """Run ``fn`` once under ``torch.profiler``. Returns its result and the
    wall ms, the device busy ms (the union of kernel intervals), the host
    share of the wall time, the kernel count, the eight kernels that took
    the most device time ([name, ms, launches]) and, for each substring in
    ``named``, the device ms and launches of the kernels whose name holds it.
    A profiler that does not start is reported, not failed; a failure of
    ``fn`` fails the run."""
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
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    if not spans:
        return out, {"wall_ms": wall_ms, "device": "not measured (the trace holds no kernel)"}
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name = {}
    for e in events:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    picked = {s: [sum(t for k, (t, _) in by_name.items() if s in k) / 1e3,
                  sum(n for k, (_, n) in by_name.items() if s in k)] for s in named}
    return out, {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
                 "host_share": 1.0 - busy_us / 1e3 / wall_ms, "kernels": len(spans),
                 "top_kernels": [[k[:90], t / 1e3, n] for k, (t, n) in top],
                 "named_kernels": picked}


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


WORDS = ("the quick brown fox jumps over a lazy dog while seven bright voices sing of "
         "rain and quiet rivers under old stone bridges near the harbour at dawn").split()


def train_batch(rng: np.random.Generator, n: int, text_len: int, mel_len: int, dev):
    """A v3 training batch shaped like ``XvaBatcher(device_spec=True)``'s,
    made by the port's own path: seeded voiced clips of ragged lengths (the
    first of ``mel_len`` frames), their pitch from ``featurize_batch``
    (normalised as the feature cache stores it), tokens of seeded English
    text by ``v3_text_to_ids`` (about one token per 4 frames), padded to the
    bucket's ``text_len`` tokens and ``mel_len`` frames; int16 audio."""
    from xva_trainer_tpu_torch.data.text import v3_text_to_ids
    from xva_trainer_tpu_torch.data.xva_dataset import lang_to_id, normalize_pitch
    from xva_trainer_tpu_torch.ops.features import featurize_batch

    frames = rng.integers(mel_len // 2, mel_len + 1, n)
    frames[0] = mel_len
    waves = [voiced_clip(rng, (f * HOP + 0.5) / SR) for f in frames]
    feats = featurize_batch(waves, mode="linear", device=dev)
    to_ids = v3_text_to_ids("en")
    tokens = np.zeros((n, text_len), np.int64)
    tlens = np.zeros(n, np.int64)
    pitch = np.zeros((n, 1, mel_len), np.float32)
    energy = np.zeros((n, mel_len), np.float32)
    wav = np.zeros((n, mel_len * HOP, 1), np.int16)
    for i, (f, w, ft) in enumerate(zip(frames, waves, feats)):
        words = rng.choice(WORDS, size=max(2, int(f) // 16))
        ids = to_ids(" ".join(words))[:text_len]
        tokens[i, :len(ids)], tlens[i] = ids, len(ids)
        pitch[i, 0, :f] = normalize_pitch(ft["pitch"])
        energy[i, :f] = ft["energy"]
        wav[i, :len(w), 0] = np.round(np.clip(w, -1, 1) * 32767.0).astype(np.int16)
    dvec = rng.standard_normal((n, 512)).astype(np.float32)
    dvec /= np.linalg.norm(dvec, axis=1, keepdims=True)
    batch = {"tokens": tokens, "tlens": tlens, "slens": frames.astype(np.int64),
             "pitch": pitch, "energy": energy, "wav": wav, "dvec": dvec,
             "lang": np.full(n, lang_to_id("en"), np.int64)}
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def seeded_disc(seed: int):
    from xva_trainer_tpu_torch.models.xvapitch import VitsDiscriminator

    torch.manual_seed(seed)
    return VitsDiscriminator()


def step_draws(batch, cfg, generator: torch.Generator, dev):
    """The step's posterior noise, SDP noise and segment draw, from a CPU
    generator, on ``dev``: the same draws on every device."""
    B, T_text = batch["tokens"].shape
    T_spec = batch["pitch"].shape[-1]
    return {"noise": torch.randn((B, cfg.latent_size, T_spec), generator=generator).to(dev),
            "dp_noise": torch.randn((B, 2, T_text), generator=generator).to(dev),
            "seg_u": torch.rand((B,), generator=generator).to(dev)}


class Sgd:
    """Plain SGD in the port's optimiser interface: the update is -lr times
    the gradient, so a step's updates compare its gradients."""

    def __init__(self, params, lr: float = 1e-3):
        self.params, self.lr = list(params), lr

    @torch.no_grad()
    def step(self, grads, apply_mask=None):
        for i, (p, g) in enumerate(zip(self.params, grads)):
            if g is not None and (apply_mask is None or apply_mask[i]):
                p.add_(g, alpha=-self.lr)
        return True


def state_of(*modules):
    return [{k: v.detach().float().cpu().clone() for k, v in m.state_dict().items()}
            for m in modules]


def update_mismatch(old, new_refs, new, scale: float = 1.0):
    """The worst parameters, by the ratio of the distance from ``new``'s
    update to the nearest of the ``new_refs``' updates (max abs) to the bar:
    1e-3 of the first reference update's max abs, plus 1e-6 of the largest
    first reference update (the float noise of a gradient that is zero in
    exact arithmetic, as an attention key's bias has) and 2 ulp of the
    parameter's largest value (the finest difference new - old resolves in
    fp32), all times ``scale``. Returns the five worst as [ratio, key, err,
    max |reference update|], and every parameter whose ratio exceeds 1."""
    rows = update_rows(old, new_refs, new, scale)
    return rows[:5], [row for row in rows if row[0] > 1.0]


def update_rows(old, new_refs, new, scale: float = 1.0):
    """``update_mismatch``'s [ratio, key, err, max |reference update|] for
    every parameter, the worst first."""
    refs = [{k: r[k] - old[k] for k in old} for r in new_refs]
    floor = 1e-6 * max(float(r.abs().max()) for r in refs[0].values())
    ulp2 = 2 * float(np.finfo(np.float32).eps)
    rows = []
    for k, r in refs[0].items():
        tol = scale * (1e-3 * float(r.abs().max()) + floor + ulp2 * float(old[k].abs().max()))
        err = min(float((new[k] - old[k] - ref[k]).abs().max()) for ref in refs)
        rows.append([err / tol if tol else (0.0 if err == 0 else float("inf")), k, err,
                     float(r.abs().max())])
    rows.sort(reverse=True)
    return rows


MAS_CASES = {  # name: (B, t_x, t_y)
    "trainer": (64, 192, 768), "one_token": (4, 1, 50), "square": (3, 64, 64),
    "more_tokens": (3, 40, 20), "extreme": (2, 12, 900), "bf16": (64, 192, 768),
    "long_text": (2, 1100, 1500), "start_minus_inf": (8, 192, 768),
    "minus_inf_column": (8, 192, 768), "nan_under_mask": (8, 192, 768),
    "fractional_mask": (8, 192, 768), "non_rectangular_mask": (8, 192, 768),
    "odd_frames": (4, 50, 333), "fastpitch": (16, 256, 896), "long_frames": (2, 40, 7000),
    "fastpitch_stage1": (46, 256, 896)}
MAS_PAIRS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)]
# cases in which every active frame holds one nonzero path entry
MAS_ONE_PER_FRAME = ("trainer", "one_token", "square", "more_tokens", "extreme", "bf16",
                     "long_text", "fractional_mask", "odd_frames", "fastpitch", "fastpitch_stage1",
                     "long_frames")
# the v3 batcher's buckets (XvaBatcher.batch_size_for, MAX_BUCKET_SCALE = 2):
# (B, t_x, t_y, the previous bucket's t_y)
MAS_BUCKETS = [(128, 64, 256, 128), (128, 96, 384, 256), (96, 128, 512, 384),
               (64, 192, 768, 512)]
# the v2 buckets (DEFAULT_BUCKETS) at FastPitch's stage-1 batch, as MAS_BUCKETS
MAS_V2_BUCKETS = [(46, 64, 256, 43), (46, 96, 384, 256), (46, 128, 512, 384),
                  (46, 192, 768, 512), (46, 256, 896, 768)]


def mas_case(name: str, dev, value_dtype=None, mask_dtype=torch.float32, seed: int = 0):
    """(value, mask) of one MAS case: the trainer's largest bucket with
    ragged lengths, one token, a square, more tokens than frames, extreme
    magnitudes (3e6·N(0,1) - 2e6 over 900 frames), bf16 values, more than
    256 tokens (several DP warps, 8-frame tiles, the direction bits in
    scratch); -inf at (0, 0) (the backtrack walks below x = 0), a -inf column
    at frame 0, NaN under the mask, a fractional mask, zeros inside the
    lengths; an odd t_y (bf16 rows staged without cp.async); FastPitch's
    256 x 896, and at its stage-1 batch of 46; 7 000 frames of 40 tokens (the
    bits in scratch, one warp). The
    value is bf16 for "bf16" unless ``value_dtype`` says otherwise. The same
    cases as tests/test_torch_kernels_cuda.py."""
    rng = np.random.default_rng(seed)
    B, tx, ty = MAS_CASES[name]
    value = rng.standard_normal((B, tx, ty))
    if name == "extreme":
        value = value * 3e6 - 2e6
    x_len = rng.integers(max(1, tx // 8), tx + 1, B)
    y_len = rng.integers(max(1, ty // 4), ty + 1, B)
    x_len[0], y_len[0] = tx, ty
    if name == "more_tokens":
        x_len = np.maximum(x_len, y_len + 1).clip(max=tx)
    mask = ((np.arange(tx)[None, :, None] < x_len[:, None, None])
            & (np.arange(ty)[None, None, :] < y_len[:, None, None])).astype(np.float64)
    if name == "start_minus_inf":
        value[:, 0, 0] = -np.inf
    elif name == "minus_inf_column":
        value[:, :, 0] = -np.inf
    elif name == "fractional_mask":
        mask *= rng.uniform(0.2, 1.0, mask.shape)
    elif name in ("nan_under_mask", "non_rectangular_mask"):
        for b in range(B):
            xs = rng.integers(1, max(2, x_len[b]), 4)
            ys = rng.integers(1, max(2, y_len[b]), 4)
            if name == "nan_under_mask":
                value[b, xs, ys] = np.nan
            else:
                mask[b, xs, ys] = 0
        if name == "nan_under_mask":
            value[1, 0, 0] = np.nan
    if value_dtype is None:
        value_dtype = torch.bfloat16 if name == "bf16" else torch.float32
    return (torch.from_numpy(value.astype(np.float32)).to(dev, value_dtype),
            torch.from_numpy(mask.astype(np.float32)).to(dev, mask_dtype))


def mas_bucket(B: int, tx: int, ty: int, prev_ty: int, dev, seed: int):
    """(value, mask) fp32 at one v3 bucket: y_len uniform in (prev_ty, ty],
    x_len in [tx/4, tx], item 0 full."""
    rng = np.random.default_rng(seed)
    x_len = rng.integers(tx // 4, tx + 1, B)
    y_len = rng.integers(prev_ty + 1, ty + 1, B)
    x_len[0], y_len[0] = tx, ty
    mask = ((np.arange(tx)[None, :, None] < x_len[:, None, None])
            & (np.arange(ty)[None, None, :] < y_len[:, None, None]))
    return (torch.from_numpy(rng.standard_normal((B, tx, ty)).astype(np.float32)).to(dev),
            torch.from_numpy(mask.astype(np.float32)).to(dev))


def mas_bound(value: torch.Tensor, mask: torch.Tensor) -> dict:
    """The least time for MAS on these inputs. Bytes: what the function needs
    at the items' own lengths, value and mask in [0, x_len) x [0, y_len),
    the whole path written once, and the mask's row 0 and column 0 (the
    lengths); beside it the full tensors' bytes (value, mask, path). The
    chain: the longest item's y_len dependent steps of an add and a max."""
    from xva_trainer_tpu_torch.ops import mas

    B, tx, ty = value.shape
    x_len, y_len = (t.long().cpu() for t in mas.mask_lengths(mask))
    vb, mb = value.element_size(), mask.element_size()
    needed = int((x_len * y_len).sum()) * (vb + mb) + B * tx * ty * vb + B * (tx + ty) * mb
    full = B * tx * ty * (vb + mb + vb)
    bytes_ms, full_ms = needed / H100_HBM_BYTES_S * 1e3, full / H100_HBM_BYTES_S * 1e3
    chain_ms = int(y_len.max()) * 2 * FP32_OP_CYCLES / H100_BOOST_HZ * 1e3
    return {"mbytes": needed / 1e6, "bytes_bound_ms": bytes_ms, "full_mbytes": full / 1e6,
            "full_bytes_bound_ms": max(full_ms, chain_ms), "chain_bound_ms": chain_ms,
            "bound_ms": max(bytes_ms, chain_ms),
            "bound_by": "bytes" if bytes_ms >= chain_ms else "operations"}


def train_phases(cfg, dev):
    """Phases 9-12: the training step at full width. Returns the launch
    counts of the timed steps (the training path) and the phase's record."""
    from xva_trainer_tpu_torch.ops import _cuda
    from xva_trainer_tpu_torch.train.optim import GanOptimizer
    from xva_trainer_tpu_torch.train.xvapitch_trainer import (POST_DEC, XvaTrainConfig,
                                                              make_optimizers, make_v3_step)

    cpu = torch.device("cpu")
    rng = np.random.default_rng(7)
    small = train_batch(rng, 2, 64, 256, dev)  # the smallest bucket, B = 2
    draws = step_draws(small, cfg, torch.Generator().manual_seed(8), dev)
    # the same seeded weights twice, in eval mode (dropout off)
    g_cpu, d_cpu = seeded_model(cfg, 10), seeded_disc(11).eval()
    g_gpu, d_gpu = seeded_model(cfg, 10).to(dev), seeded_disc(11).eval().to(dev)
    old = state_of(g_cpu, d_cpu)
    n_g, n_d = (sum(p.numel() for p in m.parameters()) for m in (g_cpu, d_cpu))

    # ---- 9. one fp32 step on the card and on the CPU; and on each again with
    # its other convolution implementation (cuDNN off on the card, oneDNN off
    # on the CPU) ----
    metas, news, secs = {}, {}, {}
    for name, dv in (("gpu", dev), ("gpu_native_conv", dev), ("cpu", cpu),
                     ("cpu_native_conv", cpu)):
        native = name.endswith("native_conv")
        g, d = (g_gpu, d_gpu) if name == "gpu" else (g_cpu, d_cpu) if name == "cpu" else \
            (seeded_model(cfg, 10).to(dv), seeded_disc(11).eval().to(dv))
        torch.backends.cudnn.enabled = not (native and dv.type == "cuda")
        torch.backends.mkldnn.enabled = not (native and dv.type == "cpu")
        step = make_v3_step(g, d, Sgd(g.parameters()), Sgd(d.parameters()),
                            freeze_post_dec=False, use_amp=False)
        t0 = time.perf_counter()
        meta = step({k: v.to(dv) for k, v in small.items()},
                    **{k: v.to(dv) for k, v in draws.items()})
        if dv.type == "cuda":
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        metas[name] = {k: v.float().cpu() for k, v in meta.items()}
        news[name] = state_of(g, d)
    torch.backends.cudnn.enabled = torch.backends.mkldnn.enabled = True
    loss_rel = {k: float((metas["gpu"][k] - metas["cpu"][k]).abs().max()
                         / max(float(metas["cpu"][k].abs().max()), 1e-30))
                for k in metas["cpu"]}
    # The bar of 1e-3 of each update's max abs is finer than the float noise
    # of the worst-conditioned sums (a bias gradient summed over B·T samples
    # that cancel): the CPU's two convolution implementations already miss it
    # against each other. The noise scale is that miss, measured on the CPU
    # alone, so that nothing the card computes can widen its own bar; each
    # card run is held to the nearer of the two CPU updates at that scale.
    cpu_vs_cpu = [update_mismatch(o, [r], n) for o, r, n in
                  zip(old, news["cpu"], news["cpu_native_conv"])]
    scale = max([1.0] + [w[0][0] for w, _ in cpu_vs_cpu])
    held, over_bar = {}, {}
    for run in ("gpu", "gpu_native_conv"):
        held[run] = [update_mismatch(o, [r, r2], n, scale) for o, r, r2, n in
                     zip(old, news["cpu"], news["cpu_native_conv"], news[run])]
        # every parameter past the bar itself, against the oneDNN CPU step
        over_bar[run] = [update_mismatch(o, [r], n)[1] for o, r, n in
                         zip(old, news["cpu"], news[run])]
    pair = lambda rows: {"generator": rows[0], "discriminator": rows[1]}  # noqa: E731
    emit("train_gpu_vs_cpu", bucket=[2, 64, 256], params={"generator": n_g, "discriminator": n_d},
         losses={k: float(v.sum()) for k, v in metas["cpu"].items() if v.dim() == 0},
         loss_rel_err=loss_rel, max_loss_rel_err=max(loss_rel.values()),
         cpu_noise_scale=scale,
         cpu_onednn_vs_native=pair([w for w, _ in cpu_vs_cpu]),
         update_mismatch_at_scale={run: pair([w for w, _ in rows]) for run, rows in held.items()},
         over_bar_vs_cpu={run: pair(rows) for run, rows in over_bar.items()},
         seconds=secs, optimizer="SGD lr 1e-3", amp=False, tf32=False)
    worst = max(w[0][0] for rows in held.values() for w, _ in rows)
    check(max(loss_rel.values()) < 1e-3 and worst <= 1.0,
          f"train_gpu_vs_cpu: loss rel err {max(loss_rel.values())}, worst update ratio {worst} "
          f"at the CPU noise scale {scale}")

    # ---- 10. AMP against fp32, from the same state ----
    g_gpu.load_state_dict(old[0])
    d_gpu.load_state_dict(old[1])
    step = make_v3_step(g_gpu, d_gpu, Sgd(g_gpu.parameters()), Sgd(d_gpu.parameters()),
                        freeze_post_dec=False, use_amp=True)
    amp_meta = {k: float(v.float().sum()) for k, v in step(small, **draws).items()}
    fp32_loss = float(metas["gpu"]["loss"])
    amp_rel = abs(amp_meta["loss"] - fp32_loss) / abs(fp32_loss)
    emit("train_amp_vs_fp32", fp32_loss=fp32_loss, amp_loss=amp_meta["loss"], rel=amp_rel,
         amp_losses=amp_meta)
    check(np.isfinite(amp_meta["loss"]) and amp_rel < 0.05
          and all(p.dtype == torch.float32 for p in g_gpu.parameters()),
          f"train_amp_vs_fp32: AMP loss {amp_meta['loss']} vs fp32 {fp32_loss}")

    # ---- 11. the freezes, with the AdamW pair ----
    freeze = {}
    for name, kw in (("freeze_post_dec", {"freeze_post_dec": True}),
                     ("hifi_only", {"freeze_post_dec": False, "hifi_only": True})):
        g_gpu.load_state_dict(old[0])
        d_gpu.load_state_dict(old[1])
        step = make_v3_step(g_gpu, d_gpu, GanOptimizer(g_gpu.parameters(), 1.75e-4),
                            GanOptimizer(d_gpu.parameters(), 2e-4), use_amp=True, **kw)
        meta = step(small, **draws)
        new = state_of(g_gpu)[0]
        moved = {k.split(".")[0] for k in new if not torch.equal(new[k], old[0][k])}
        still = {k.split(".")[0] for k in new if torch.equal(new[k], old[0][k])}
        freeze[name] = {"moved": sorted(moved), "unchanged": sorted(still),
                        "loss": float(meta["loss"]), "loss_disc": float(meta["loss_disc"])}
        frozen_ok = (not moved & set(POST_DEC)) if name == "freeze_post_dec" \
            else moved == set(POST_DEC)
        check(frozen_ok and bool(torch.isfinite(meta["loss"])),
              f"train_freeze {name}: moved {sorted(moved)}")
    emit("train_freeze", **freeze)
    del g_cpu, d_cpu, step

    # ---- 12. the trainer's step, timed: the training path ----
    tcfg = XvaTrainConfig()
    batch_size, fits, tried = tcfg.batch_size, None, []
    while fits is None:
        g_gpu.load_state_dict(old[0])
        d_gpu.load_state_dict(old[1])
        g_gpu.train()
        d_gpu.train()
        g_opt, d_opt = make_optimizers(g_gpu, d_gpu, tcfg, tcfg.gam)
        step = make_v3_step(g_gpu, d_gpu, g_opt, d_opt, freeze_post_dec=False,
                            use_amp=tcfg.use_amp)
        gen = torch.Generator(device=dev).manual_seed(tcfg.seed)
        big = train_batch(np.random.default_rng(9), batch_size, 192, 768, dev)
        try:
            for _ in range(2):  # warm-up
                step(big, gen)
            torch.cuda.synchronize()
            fits = batch_size
        except torch.cuda.OutOfMemoryError as e:  # say so, and halve the batch
            tried.append({"batch": batch_size, "error": str(e).splitlines()[0]})
            del big, step, g_opt, d_opt
            torch.cuda.empty_cache()
            check(batch_size > 1, "train_step: not even B = 1 fits")
            batch_size //= 2
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    times, metas = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        meta = step(big, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metas.append({k: v.float().cpu().tolist() for k, v in meta.items()})
    launches = dict(_cuda.LAUNCHES)  # the end of the training path
    peak = torch.cuda.max_memory_allocated()
    _, prof = profiled(lambda: step(big, gen))
    frames = int(big["slens"].sum())
    med = float(np.median(times))
    finite = all(np.isfinite(np.asarray(v, np.float64)).all() for m in metas for v in m.values())
    record = {"batch": fits, "bucket": [192, 768], "b64_fits": fits == tcfg.batch_size,
              "tried": tried, "timed_steps": len(times), "step_ms": [t * 1e3 for t in times],
              "step_ms_median": med * 1e3, "step_ms_min": min(times) * 1e3,
              "step_ms_max": max(times) * 1e3, "mel_frames": frames,
              "mel_frames_per_s": frames / med, "peak_memory_gb": peak / 1e9,
              "gam": tcfg.gam, "optimizer_updates_in_timed_steps": g_opt.count,
              "launches": launches, "launches_per_step": {k: v / len(times)
                                                          for k, v in launches.items()},
              "profiled_step": prof, "losses": metas[-1], "all_losses_finite": finite,
              "amp": tcfg.use_amp, "tf32": False, "dropout": "on (training mode)"}
    emit("train_step", **record)
    check(finite, "train_step: a loss component is not finite")
    return launches, record


V3_BUCKETS = [(64, 256), (96, 384), (128, 512), (192, 768)]  # (text_len, mel_len)
CLIPS_PER_BUCKET = 64


def write_v3_dataset(path: str, rng: np.random.Generator, lang: str = "en",
                     per_bucket: int = CLIPS_PER_BUCKET, words=None) -> list:
    """A seeded fine-tune dataset in the layout users give the trainer:
    ``wavs/*.wav`` (16-bit, 22 050 Hz) and ``metadata.csv``. ``per_bucket``
    voiced clips in each v3 bucket's frame range at hop 256 (44-256,
    257-384, 385-512 and 513-768 frames: (0.5, 2.97], (2.97, 4.46],
    (4.46, 5.94] and (5.94, 8.9] s), each with text whose ``lang`` v3 tokens
    fit its bucket's text length: ``words(rng, n)`` gives its n words
    (English from ``WORDS`` by default), cut from the end until they fit.
    Returns [(name, frames, text)]."""
    from xva_trainer_tpu_torch.data.audio_io import save_wav
    from xva_trainer_tpu_torch.data.text import v3_text_to_ids

    to_ids = v3_text_to_ids(lang)
    words = words or (lambda r, n: list(r.choice(WORDS, size=n)))
    os.makedirs(os.path.join(path, "wavs"))
    items, prev = [], 43
    for text_len, mel_len in V3_BUCKETS:
        for frames in rng.integers(prev + 1, mel_len + 1, per_bucket):
            name = f"clip{len(items):03d}"
            save_wav(os.path.join(path, "wavs", name + ".wav"),
                     voiced_clip(rng, (frames * HOP + 0.5) / SR))
            ws = words(rng, max(2, int(frames) // 18))
            while len(to_ids(" ".join(ws))) > text_len:
                ws.pop()
            items.append((name, int(frames), " ".join(ws)))
        prev = mel_len
    with open(os.path.join(path, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("".join(f"{n}.wav|{t}\n" for n, _, t in items))
    return items


LOG_FLOOR = 0.1  # the magnitude above which the log values' max is held


def cache_vs_cpu(cache, ds: str, picks: list) -> dict:
    """Cached items against the port's plain path on the CPU, from the files:
    each pick's postprocessed wav decoded and featurized again by
    ``featurize_batch(device="cpu")`` (the fused kernel's plain version), its
    text tokenized again. Returns the comparison and checks the bars: the
    log-compressed linear spectrogram within 1e-3 mean abs, and within 1e-3
    max abs on the bins whose float64 magnitude is at least LOG_FLOOR; the
    linear magnitude within 1e-3 max abs; energy within 1e-3 of its max
    abs; pitch voiced alike on more than 95% of frames and within 2% in Hz
    on 95% of the frames both call voiced; tokens, wav and lang_id equal.

    The fp32 rounding of a bin is absolute (about 2e-5 at these clips'
    level), so its log error is about 2e-5/|X|: at most 2e-4 above the
    floor, and toward the 1e-5 clamp it grows whatever computes it. So the
    plain version's own max error of the log values against a float64 FFT
    is printed too, over all bins and above the floor."""
    from xva_trainer_tpu_torch.data.audio_io import load_wav
    from xva_trainer_tpu_torch.data.text import v3_text_to_ids
    from xva_trainer_tpu_torch.data.xva_dataset import (XVASPEECH_PITCH_MEAN,
                                                        XVASPEECH_PITCH_STD, lang_to_id)
    from xva_trainer_tpu_torch.ops.features import featurize_batch
    from xva_trainer_tpu_torch.ops.stft import DEFAULT_MEL

    to_ids = v3_text_to_ids("en")
    by_id = {it.item_id: it for it in cache.items}
    waves = []
    for name, _, _ in picks:
        y, _ = load_wav(os.path.join(ds, "wavs_postprocessed", name + ".wav"), target_sr=SR)
        waves.append(y[: len(y) // HOP * HOP])
    ref = featurize_batch(waves, mode="linear", device="cpu")
    rows = []
    for (name, frames, text), y, r in zip(picks, waves, ref):
        d = cache.load_item(by_id[name])
        la = np.log(np.maximum(d["linear"], 1e-5))
        lb = np.log(np.maximum(r["linear"], 1e-5))
        _, f64 = rfft_reference(torch.from_numpy(y), DEFAULT_MEL, True, 0.0)
        m64 = f64.numpy()[:, : len(y) // HOP]
        l64 = np.log(np.maximum(m64, 1e-5))
        strong = m64 >= LOG_FLOOR
        pa = d["pitch"]
        pb = np.where(r["pitch"] > 0, (r["pitch"] - XVASPEECH_PITCH_MEAN) / XVASPEECH_PITCH_STD,
                      0.0).astype(np.float32)
        va, vb = pa != 0, pb != 0
        both = va & vb
        hz_a = pa[both] * XVASPEECH_PITCH_STD + XVASPEECH_PITCH_MEAN
        hz_b = pb[both] * XVASPEECH_PITCH_STD + XVASPEECH_PITCH_MEAN
        rows.append({
            "item": name, "frames": frames, "shape": list(d["linear"].shape),
            "log_linear_mean_abs_err": float(np.abs(la - lb).mean()),
            "log_linear_max_abs_err": float(np.abs(la - lb).max()),
            "plain_vs_f64_log_linear_max_abs_err": float(np.abs(lb - l64).max()),
            "log_linear_above_floor_max_abs_err": float(np.abs(la - lb)[strong].max()),
            "plain_vs_f64_log_linear_above_floor_max_abs_err":
                float(np.abs(lb - l64)[strong].max()),
            "share_of_bins_above_floor": float(strong.mean()),
            "linear_max_abs_err": float(np.abs(d["linear"] - r["linear"]).max()),
            "energy_max_rel_err": float(np.abs(d["energy"] - r["energy"]).max()
                                        / np.abs(r["energy"]).max()),
            "voicing_agreement": float((va == vb).mean()), "voiced_frames": int(both.sum()),
            "f0_p95_rel_err": float(np.percentile(np.abs(hz_a - hz_b) / hz_b, 95))
            if both.any() else 0.0,
            "tokens_equal": bool(np.array_equal(d["tokens"], np.asarray(to_ids(text), np.int32))),
            "wav_equal": bool(np.array_equal(d["wav"], y)),
            "lang_id_equal": int(np.asarray(d["lang_id"]).reshape(-1)[0]) == lang_to_id("en")})
    worst = {k: max(r[k] for r in rows) for k in rows[0] if k.endswith("_err")}
    worst["voicing_agreement"] = min(r["voicing_agreement"] for r in rows)
    worst["share_of_bins_above_floor"] = min(r["share_of_bins_above_floor"] for r in rows)
    check(all(r["shape"] == [513, r["frames"]] and r["tokens_equal"] and r["wav_equal"]
              and r["lang_id_equal"] and r["voiced_frames"] > 0 for r in rows)
          and worst["log_linear_mean_abs_err"] < TOL and worst["linear_max_abs_err"] < TOL
          and worst["log_linear_above_floor_max_abs_err"] < TOL
          and worst["energy_max_rel_err"] < TOL and worst["voicing_agreement"] > 0.95
          and worst["f0_p95_rel_err"] < 0.02,
          f"data: cached items against the CPU: {worst}, {rows}")
    return {"items": rows, "worst": worst}


QUANT_SLACK = 1e-4  # both sides' fp32 rounding: 5x the kernel's max against its plain version


def device_spec_vs_host(host: dict, dspec: dict, dev) -> dict:
    """``materialize_spec``'s spectrogram of a ``device_spec`` batch against
    the cached one that a host batch of the same items passes through, on the
    frames below ``slens - 1`` (the JAX package's
    ``tests/test_device_spec.py::test_device_spec_matches_host_linear``).

    The two differ by their audio alone, and not by noise: the cached wav is
    the file's k/32768, the ``device_spec`` batch's round(k·32767/32768)/32767
    (``collate`` and ``materialize_spec``, as in the JAX package), so a bin
    moves by up to about |X|/32767. A bin of frame f moves by at most
    sum_n w[n]·|Δy[f·hop + n]| (w the window, Δy the difference of the two
    audios), a bound computed here from the batch itself. The bars: the mean
    abs difference under TOL, and no bin more than QUANT_SLACK over its
    frame's bound. Two wrong spectrograms are read against the same bars and
    must miss them: the ``device_spec`` one two frames off (what
    ``center=False`` gives) and one of the audio rounded to bf16."""
    from xva_trainer_tpu_torch.ops.stft import frame_signal, hann_window, pad_reflect
    from xva_trainer_tpu_torch.train.xvapitch_trainer import materialize_spec

    lin_h, wav_h = materialize_spec(host)
    lin_d, wav_d = materialize_spec(dspec)
    frames = lin_h.shape[-1]
    keep = torch.arange(frames, device=dev)[None, :] < (host["slens"][:, None] - 1)
    win = torch.from_numpy(hann_window(1024, 1024)).to(dev)
    dy = (wav_h - wav_d)[:, 0].abs()
    bound = (frame_signal(pad_reflect(dy, 512), 1024, HOP, frames) * win).sum(-1)  # (B, F)

    def read(lin):
        d = (lin - lin_h).abs()
        over = (d - bound[:, None, :]).transpose(1, 2)[keep]
        d = d.transpose(1, 2)[keep]
        r = {"mean_abs_err": float(d.mean()), "max_abs_err": float(d.max()),
             "max_over_bound": float(over.max())}
        r["passes"] = r["mean_abs_err"] < TOL and r["max_over_bound"] < QUANT_SLACK
        return r

    shifted = torch.cat([lin_d[..., 2:], lin_d[..., -2:]], -1)
    bf16, _ = materialize_spec({"wav": wav_d.transpose(1, 2).bfloat16()})
    return {"batch": list(lin_h.shape), "frames_compared": int(keep.sum()),
            "host_linear_max": float(lin_h.max()),
            "host_linear_max_over_32767": float(lin_h.max()) / 32767,
            "bound_max": float(bound.max()), "slack": QUANT_SLACK, **read(lin_d),
            "controls": {"two_frames_off": read(shifted), "bf16_audio": read(bf16)}}


def data_phase(cfg, dev, smi: str, work: str):
    """Phase 13, ``data``: the v3 data path, from a dataset on disk to the
    training step, through the entry points in the order the JAX server's
    v3 flow runs them (``app/server.py``): ``preprocess_audio`` →
    ``extract_speaker_embeddings`` (the encoder at full width, seeded) →
    ``XvaFeatureCache.build`` → ``get_dataset_embedding`` → ``XvaBatcher``
    (``device_spec``) → one epoch through a ``Prefetcher`` with
    ``batch_to_device`` → one AMP ``make_v3_step`` step a batch, one batch a
    bucket, at full width with the VITS discriminator. The launch counts are
    set to 0 before the path and read after its last step. Then the checks
    that read the card again: cached items against the CPU, speaker
    embeddings against the CPU, a host-spectrogram batch against the
    ``device_spec`` one. The dataset, its cache and speaker embeddings stay
    in ``work`` for the ``train_loop`` phase. Returns the path's launch
    counts, the record and {"dataset", "cache", "emb"}."""
    from xva_trainer_tpu_torch.data.audio_io import load_wav, resample
    from xva_trainer_tpu_torch.data.prefetch import Prefetcher
    from xva_trainer_tpu_torch.data.text import v3_text_to_ids
    from xva_trainer_tpu_torch.data.xva_dataset import (XvaBatcher, XvaFeatureCache,
                                                        extract_speaker_embeddings,
                                                        get_dataset_embedding)
    from xva_trainer_tpu_torch.models.speaker_encoder import SpeakerEncoder
    from xva_trainer_tpu_torch.ops import _cuda
    from xva_trainer_tpu_torch.train.xvapitch_trainer import (XvaTrainConfig, batch_to_device,
                                                              make_optimizers, make_v3_step,
                                                              preprocess_audio)

    ds = os.path.join(work, "en_voice")
    t0 = time.perf_counter()
    specs = write_v3_dataset(ds, np.random.default_rng(30))
    audio_s = sum(f for _, f, _ in specs) * HOP / SR
    stages = {"write_dataset (set-up)": time.perf_counter() - t0}
    tcfg = XvaTrainConfig()
    model = seeded_model(cfg, 10).to(dev).train()
    disc = seeded_disc(11).to(dev).train()
    # the config's gam, ceil(400 / 64) = 7 (the loop's comes from its batcher)
    g_opt, d_opt = make_optimizers(model, disc, tcfg, tcfg.gam)
    step = make_v3_step(model, disc, g_opt, d_opt, freeze_post_dec=False,
                        use_amp=tcfg.use_amp)
    gen = torch.Generator(device=dev).manual_seed(tcfg.seed)

    t0 = time.perf_counter()
    enc = SpeakerEncoder(seed=0, device=dev)
    torch.cuda.synchronize()
    stages["speaker_encoder_build (set-up)"] = time.perf_counter() - t0

    # ---- the data path ----
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    n_pre = preprocess_audio(ds)
    stages["preprocess_audio"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_emb = extract_speaker_embeddings(ds, enc, use_postprocessed=True)
    torch.cuda.synchronize()
    stages["extract_speaker_embeddings"] = time.perf_counter() - t0
    check(n_pre == n_emb == len(specs),
          f"data: {n_pre} postprocessed wavs and {n_emb} speaker embeddings of "
          f"{len(specs)} items (an item was skipped)")
    cache = XvaFeatureCache(ds, v3_text_to_ids("en"), lang="en", device=dev)
    before = _cuda.LAUNCHES["fused_stft"]
    _, build_prof = profiled(cache.build, named=("fused_stft_kernel",))
    build_launches = _cuda.LAUNCHES["fused_stft"] - before
    build_s = build_prof["wall_ms"] / 1e3
    stages["cache_build"] = build_s
    with open(os.path.join(cache.cache_dir, ".mel_variant"), encoding="utf8") as f:
        variant = f.read()
    cached = [it for it in cache.items if cache.load_item(it) is not None]
    healed = os.path.exists(os.path.join(cache.cache_dir, "corrupt_wavs.txt"))
    # one DECODE_CHUNK; featurize groups of <= 8 clips by length, each in a
    # (clips, slot + n_fft) buffer with slots a multiple of 32 768 samples
    lens = sorted(f * HOP for _, f, _ in specs)
    group_shapes = [(len(g), -(-max(g) // 32768) * 32768 + 1024)
                    for g in (lens[i: i + 8] for i in range(0, len(lens), 8))]
    groups = len(group_shapes)
    check(len(cache.items) == len(cached) == len(specs) and not healed
          and variant == "pallas" and build_launches == groups,
          f"data: {len(cached)} of {len(specs)} items cached, healed {healed}, variant "
          f"{variant}, {build_launches} fused_stft launches for {groups} groups")
    t0 = time.perf_counter()
    emb = get_dataset_embedding(ds, enc)
    stages["get_dataset_embedding"] = time.perf_counter() - t0
    check(emb["main"].shape == (512,) and emb["others"].shape == (9, 512)
          and np.isfinite(emb["main"]).all() and np.isfinite(emb["others"]).all(),
          f"data: dataset embedding {emb['main'].shape}, others {emb['others'].shape}")
    batcher = XvaBatcher([cache], batch_size=tcfg.batch_size, d_vector=emb["main"])
    batcher.device_spec = True

    collate_ms, transfer_ms = [], []

    def timed_epoch():
        batches = batcher.epoch()
        while True:
            t = time.perf_counter()
            b = next(batches, None)
            if b is None:
                return
            collate_ms.append((time.perf_counter() - t) * 1e3)
            yield b

    def transfer(b):
        t = time.perf_counter()
        out = batch_to_device(b, dev), b["ids"]
        transfer_ms.append((time.perf_counter() - t) * 1e3)
        return out

    steps = []
    t_epoch = time.perf_counter()
    pf = Prefetcher(timed_epoch(), transfer)
    try:
        stream = iter(pf)
        while True:
            t = time.perf_counter()
            nxt = next(stream, None)
            if nxt is None:
                break
            waited = time.perf_counter() - t
            batch, ids = nxt
            counts = dict(_cuda.LAUNCHES)
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            meta = step(batch, gen)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            losses = {k: v.float().cpu().tolist() for k, v in meta.items()}
            launched = {k: _cuda.LAUNCHES[k] - counts[k] for k in counts}
            finite = all(np.isfinite(np.asarray(v, np.float64)).all()
                         for v in losses.values())
            steps.append({"bucket": [int(batch["tokens"].shape[1]),
                                     int(batch["pitch"].shape[-1])],
                          "batch": int(batch["tokens"].shape[0]),
                          "unique_items": len(set(ids)),
                          "mel_frames": int(batch["slens"].sum()),
                          "wait_ms": waited * 1e3, "step_ms": ms,
                          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                          "launches": launched, "all_losses_finite": finite,
                          "losses": losses})
            check(finite and launched["fused_stft"] == 2 and launched["mas"] == 1,
                  f"data: step {steps[-1]}")
    finally:
        pf.close()
    stages["epoch (collate, transfer, 4 steps)"] = time.perf_counter() - t_epoch
    launches = dict(_cuda.LAUNCHES)  # the end of the data path
    by_bucket = sorted((s["bucket"], s["batch"], s["unique_items"]) for s in steps)
    want = [([t, m], int(round(tcfg.batch_size * min(768 / m, 2.0))), CLIPS_PER_BUCKET)
            for t, m in V3_BUCKETS]  # 128, 128, 96, 64: MAX_BUCKET_SCALE = 2
    check(by_bucket == want, f"data: batches {by_bucket}, expected {want}")
    del model, disc, g_opt, d_opt, step, batch, meta
    torch.cuda.empty_cache()

    # ---- checks that read the card's results again ----
    picks = [specs[i] for b in range(len(V3_BUCKETS))
             for i in (b * CLIPS_PER_BUCKET, b * CLIPS_PER_BUCKET + 1)]
    items_vs_cpu = cache_vs_cpu(cache, ds, picks)
    enc_cpu = SpeakerEncoder(seed=0, device="cpu")
    emb_l1 = []
    for name, _, _ in picks[::2]:
        y, sr = load_wav(os.path.join(ds, "wavs_postprocessed", name + ".wav"))
        e_cpu = enc_cpu.compute_embedding(resample(y, sr, 16000))
        e_card = np.load(os.path.join(ds, "se_embs", name + ".npy"))
        emb_l1.append(float(np.abs(e_cpu - e_card).sum()))
    check(max(emb_l1) < TOL, f"data: speaker embeddings card vs CPU, L1 {emb_l1}")
    pair = []
    for spec_on in (False, True):  # the same seed: the same batches
        b = XvaBatcher([cache], batch_size=tcfg.batch_size, d_vector=emb["main"], seed=1)
        b.device_spec = spec_on
        pair.append(next(x for x in b.epoch() if x["pitch"].shape[-1] == V3_BUCKETS[0][1]))
    spec_cmp = device_spec_vs_host(*(batch_to_device(x, dev) for x in pair), dev)
    spec_cmp["ids_equal"] = pair[0]["ids"] == pair[1]["ids"]
    check(spec_cmp["ids_equal"] and spec_cmp["passes"]
          and not any(c["passes"] for c in spec_cmp["controls"].values()),
          f"data: host linear against device_spec's: {spec_cmp}")
    kernel = build_prof.get("named_kernels")
    record = {
        "items": len(specs), "audio_seconds": audio_s, "gpu": smi, "stage_seconds": stages,
        "cache_build": {
            "seconds": build_s, "items_per_s": len(specs) / build_s,
            "audio_seconds_per_s": audio_s / build_s, "variant": variant,
            "featurize_groups": groups, "group_shapes": group_shapes,
            "fused_stft_launches": build_launches,
            "fused_stft_device_ms": kernel["fused_stft_kernel"][0] if kernel else None,
            "device_busy_ms": build_prof.get("device_busy_ms"),
            "host_share": build_prof.get("host_share"),
            "stage_seconds": cache.build_seconds, "profile": build_prof,
            "cache_mbytes": sum(os.path.getsize(os.path.join(cache.cache_dir, f))
                                for f in os.listdir(cache.cache_dir)
                                if f.endswith(".npz")) / 1e6,
            "pack_mbytes": os.path.getsize(os.path.join(cache.cache_dir, "packed.bin"))
            / 1e6},
        "speaker_encoder_items_per_s": len(specs) / stages["extract_speaker_embeddings"],
        "collate_ms": collate_ms, "transfer_ms": transfer_ms, "steps": steps,
        "launches": launches, "items_vs_cpu": items_vs_cpu,
        "speaker_embedding_l1_vs_cpu": emb_l1, "host_linear_vs_device_spec": spec_cmp,
        "tf32": False}
    emit("data", **record)
    return launches, record, {"dataset": ds, "cache": cache, "emb": emb, "enc": enc}


def effective_weights(module) -> dict:
    """Every parameter of ``module`` as its forward uses it, float64 on the
    CPU: each weight-norm pair combined over its own dim, the rest as is."""
    from xva_trainer_tpu_torch.train.checkpoints import _weight_norm_dims

    sd = {k: v.detach().double().cpu() for k, v in module.state_dict().items()}
    wn = _weight_norm_dims(module)
    out = {k: v for k, v in sd.items() if not any(k in (b + "_g", b + "_v") for b in wn)}
    for base, dim in wn.items():
        v = sd[base + "_v"]
        dims = [d for d in range(v.dim()) if d != dim]
        out[base] = v / torch.sqrt((v * v).sum(dim=dims, keepdim=True)) * sd[base + "_g"]
    return out


def file_effective_weights(path: str) -> dict:
    """The generator's weights of a reference-layout ``.pt`` as the
    reference's forward uses them: each (weight_g, weight_v) pair over dim 0."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for k, v in sd.items():
        if k.startswith("disc.") or k == "step" or k.endswith("weight_g"):
            continue
        if k.endswith("weight_v"):
            v, g = v.double(), sd[k[:-1] + "g"].double()
            dims = list(range(1, v.dim()))
            out[k[:-len("_v")]] = v / torch.sqrt((v * v).sum(dim=dims, keepdim=True)) * g
        else:
            out[k] = v.double()
    return out


def timed_prefetcher(base, waits: list, tag=lambda item: None):
    """A subclass of the trainer's prefetcher ``base`` that times the loop's
    wait for each item: (seconds, ``tag(item)``) appended to ``waits``."""
    class TimedPrefetcher(base):
        def __iter__(self):
            it = super().__iter__()
            while True:
                t = time.perf_counter()
                item = next(it, None)
                waits.append((time.perf_counter() - t, None if item is None else tag(item)))
                if item is None:
                    return
                yield item
    return TimedPrefetcher


LOOP_UPDATES = 3  # updates of the first trainer; the resumed one takes one more
FULL_PARAMS = (82_995_624, 46_747_132)  # XVAPitchConfig() and VitsDiscriminator()


def train_loop_phase(cfg, dev, smi: str, data: dict, base_ckpt: str, work: str):
    """Phase 14, ``train_loop``: the v3 fine-tune as a voice maker runs it,
    ``XVAPitchTrainer(...).setup()`` → ``.train()`` → ``.export()``, at full
    width on the ``data`` phase's dataset, cache and speaker embeddings:

    1. the trainer (``XvaBatcher([cache], 64, emb)``, the default config but
       ``save_step=1``): its ``gam`` from the batcher's mean batch;
    2. ``setup(resume=False, pretrained_ckpt=<phase 5's reference .pt>)``,
       the generator's effective weights held to the file's;
    3. ``train(max_steps=3)``, the loss-seeding pass first: every loss
       finite, a loss for every item, the window of checkpoints at 2 and 3,
       ``graphs.json`` and ``training.log`` written;
    4. a second trainer resumed from the directory, bit-identical to the
       first (parameters, both optimisers, host state), takes a 4th update
       and rolls the window to 3 and 4; the kernels' launches over 1-4 are
       the ``loop`` path, 2 ``fused_stft`` and 1 ``mas`` a micro-step and a
       seeding batch;
    5. ``export`` served by ``serve.export_wav``, loaded strictly;
    6. ``output_samples`` of two sentences;
    7. one more update (no checkpoint) under the profiler.

    Reports the seeding pass's seconds, each micro-step's ms by bucket,
    each update's seconds with and without its checkpoint write, the
    meter's frames a second, the prefetch wait a micro-step, the profiled
    update's host share, each checkpoint's seconds and bytes, the resume's
    and the export's, and peak memory. Returns the path's launch counts and
    the record."""
    from xva_trainer_tpu_torch.data.xva_dataset import XvaBatcher
    from xva_trainer_tpu_torch.ops import _cuda
    from xva_trainer_tpu_torch.serve import export_wav, load_xvapitch, synthesize_v3
    from xva_trainer_tpu_torch.train import xvapitch_trainer as pxt

    out = os.path.join(work, "loop_out")
    emb = data["emb"]
    torch.cuda.reset_peak_memory_stats()
    waits: list = []

    def trainer(**kw):
        batcher = XvaBatcher([data["cache"]], 64, emb["main"])
        t0 = time.perf_counter()
        tr = pxt.XVAPitchTrainer(batcher, pxt.XvaTrainConfig(output_dir=out, save_step=1, **kw),
                                 cfg, device=dev)
        torch.cuda.synchronize()
        return tr, batcher, time.perf_counter() - t0

    steps, saves = [], []

    def instrument(tr):
        """Time each micro-step (host ms around the call; CUDA events read
        after the loop, so no host sync is added) and each checkpoint."""
        for freeze, real in list(tr._steps.items()):
            def step(batch, gen, real=real):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                t = time.perf_counter()
                ev[0].record()
                meta = real(batch, gen)
                ev[1].record()
                steps.append({"t": t, "host_ms": (time.perf_counter() - t) * 1e3, "events": ev,
                              "bucket": [int(batch["tokens"].shape[1]),
                                         int(batch["pitch"].shape[-1])],
                              "batch": int(batch["tokens"].shape[0]),
                              "frames": batch["slens"].sum(), "meta": meta})
                return meta
            tr._steps[freeze] = step
        real_save = tr.ckpt.save

        def save(step, state, host=None):
            path = real_save(step, state, host)
            saves.append(dict(tr.ckpt.last_save, t_end=time.perf_counter()))
            return path
        tr.ckpt.save = save

    plain_prefetcher = pxt.Prefetcher
    pxt.Prefetcher = timed_prefetcher(plain_prefetcher, waits)
    try:
        tr, batcher, build_s = trainer()
        mean_bs, seed_batches = batcher.mean_batch_size(), len(batcher)
        n_g = sum(p.numel() for p in tr.model.parameters())
        n_d = sum(p.numel() for p in tr.disc.parameters())
        check(tr.gam == math.ceil(tr.cfg.target_bs / mean_bs) and (n_g, n_d) == FULL_PARAMS,
              f"train_loop: gam {tr.gam} at a mean batch of {mean_bs}, params {n_g} + {n_d}")
        t0 = time.perf_counter()
        tr.setup(resume=False, pretrained_ckpt=base_ckpt)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        ours, ref = effective_weights(tr.model), file_effective_weights(base_ckpt)
        warm_err = max(float((ours[k] - ref[k]).abs().max() / ref[k].abs().max().clamp(min=1e-30))
                       for k in ref)
        check(sorted(ours) == sorted(ref) and warm_err < 1e-5,
              f"train_loop: warm start's effective weights off the file's by {warm_err}")
        instrument(tr)

        # ---- the loop path: the seeding pass and 3 updates, then the resume's 4th ----
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        result = tr.train(max_steps=LOOP_UPDATES)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        micro_first = tr.micro_steps
        files = sorted(f for f in os.listdir(out) if f.startswith("xVAPitch_"))
        check(result["training_iters"] == LOOP_UPDATES and micro_first == LOOP_UPDATES * tr.gam
              and len(tr.loss_sampling) == len(data["cache"].items)
              and files == ["xVAPitch_2.json", "xVAPitch_2.pt", "xVAPitch_3.json",
                            "xVAPitch_3.pt"]
              and os.path.exists(os.path.join(out, "graphs.json"))
              and os.path.exists(os.path.join(out, "training.log")),
              f"train_loop: {result}, {micro_first} micro-steps, {len(tr.loss_sampling)} items "
              f"seeded, files {files}")

        back, _, _ = trainer()
        t0 = time.perf_counter()
        back.setup(resume=True)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        same = {"model": all(torch.equal(a, b) for a, b in zip(tr.model.state_dict().values(),
                                                                back.model.state_dict().values())),
                "disc": all(torch.equal(a, b) for a, b in zip(tr.disc.state_dict().values(),
                                                               back.disc.state_dict().values()))}
        for name in ("g_opt", "d_opt"):
            a, b = getattr(tr, name).state_dict(), getattr(back, name).state_dict()
            same[name] = (all(a[k] == b[k] for k in ("count", "mini_step", "grad_accum"))
                          and all(torch.equal(x, y) for k in ("mu", "nu", "acc")
                                  for x, y in zip(a[k] or [], b[k] or [])))
        host = ("stage", "training_iters", "micro_steps", "finetune_counter", "finetune_it",
                "loss_sampling", "disc_loss_window", "disc_loss_per_ckpt", "deltas",
                "patience_count", "END_OF_TRAINING")
        same["host"] = all(getattr(tr, k) == getattr(back, k) for k in host)
        check(all(same.values()), f"train_loop: the resumed trainer differs: {same}")
        seed_s, meter_first = tr.seed_seconds, list(tr.meter.history)
        del tr
        torch.cuda.empty_cache()
        instrument(back)
        t0 = time.perf_counter()
        back.train(max_steps=LOOP_UPDATES + 1)
        torch.cuda.synchronize()
        resumed_train_s = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)  # the end of the loop path
        micro = len(steps)
        files = sorted(f for f in os.listdir(out) if f.endswith(".pt"))
        check(back.training_iters == LOOP_UPDATES + 1 and micro == (LOOP_UPDATES + 1) * back.gam
              and files == ["xVAPitch_3.pt", "xVAPitch_4.pt"],
              f"train_loop: the resumed trainer at {back.training_iters} updates, {micro} "
              f"micro-steps, files {files}")
        want = {"fused_stft": 2 * (micro + seed_batches), "mas": micro + seed_batches}
        check(all(launches[k] == v for k, v in want.items()),
              f"train_loop: launches {launches}, expected {want}")

        # ---- the export, served ----
        t0 = time.perf_counter()
        voice = back.export("smoke_voice", base_emb=emb["main"],
                            other_embs=emb["others"].tolist())
        export_s = time.perf_counter() - t0
        sd = torch.load(voice, map_location="cpu", weights_only=True)
        base_keys = set(torch.load(base_ckpt, map_location="cpu", weights_only=True))
        want_keys = base_keys | {"disc." + k for k in back.disc.state_dict()}
        with open(os.path.splitext(voice)[0] + ".json", encoding="utf8") as f:
            meta_json = json.load(f)
        check(set(sd) == want_keys and all(v.dtype == torch.float16 for v in sd.values())
              and any(k.startswith("disc.") for k in sd)
              and meta_json["modelType"] == "xVAPitch" and meta_json["version"] == "3.0"
              and len(meta_json["games"][0]["base_speaker_emb"]) == 512,
              f"train_loop: export keys {len(sd)} (want {len(want_keys)}), "
              f"dtypes {sorted({str(v.dtype) for v in sd.values()})}, json {meta_json['version']}")
        served = load_xvapitch(voice, cfg, device=dev)
        wav = synthesize_v3(served, TEXTS[0], emb["main"])
        t0 = time.perf_counter()
        export_wav({"xvap_ckpt": voice, "out_path": os.path.join(work, "served.wav"),
                    "text": TEXTS[1]}, cfg=cfg, device=dev)
        serve_s = time.perf_counter() - t0
        sr, pcm = wavfile.read(os.path.join(work, "served.wav"))
        check(np.isfinite(wav).all() and len(wav) > 0 and sr == SR and len(pcm) > 0
              and len(pcm) % HOP == 0,
              f"train_loop: the export served {len(wav)} samples, export_wav {len(pcm)}")
        del served

        # ---- previews ----
        t0 = time.perf_counter()
        previews = back.output_samples(TEXTS[:2], emb["main"])
        preview_s = time.perf_counter() - t0
        lens = []
        for p in previews:
            p_sr, y = wavfile.read(p)
            lens.append(len(y))
            check(p_sr == SR and len(y) > 0 and len(y) % HOP == 0
                  and np.isfinite(np.asarray(y, np.float64)).all(),
                  f"train_loop: preview {p}: {len(y)} samples at {p_sr} Hz")
        check(len(previews) == 2, f"train_loop: {len(previews)} previews")

        # ---- one more update, no checkpoint, under the profiler ----
        back.cfg.save_step = 10 ** 9
        n_before = len(steps)
        _, prof = profiled(lambda: back.train(max_steps=LOOP_UPDATES + 2))
        profiled_micro = len(steps) - n_before
        peak = torch.cuda.max_memory_allocated()
    finally:
        pxt.Prefetcher = plain_prefetcher

    # ---- what the loop's micro-steps and updates took ----
    torch.cuda.synchronize()
    losses_finite = all(bool(torch.isfinite(v).all()) for s in steps for v in s["meta"].values())
    check(losses_finite, "train_loop: a loss component is not finite")
    for s in steps:
        s["event_ms"] = s["events"][0].elapsed_time(s["events"][1])
        s["frames"] = int(s["frames"])
    gam = back.gam
    loop_steps = steps[:micro]
    seen, by_bucket = set(), {}
    for s in loop_steps:
        key = "x".join(map(str, s["bucket"]))
        rec = by_bucket.setdefault(key, {"batch": s["batch"], "first_host_ms": None,
                                         "first_event_ms": None, "host_ms": [], "event_ms": [],
                                         "mel_frames": []})
        rec["mel_frames"].append(s["frames"])
        if key not in seen:
            seen.add(key)
            rec["first_host_ms"], rec["first_event_ms"] = s["host_ms"], s["event_ms"]
        else:
            rec["host_ms"].append(s["host_ms"])
            rec["event_ms"].append(s["event_ms"])
    # an update: from its first micro-step's start to the next update's (the
    # last: to the end of its checkpoint); its checkpoint write is the save
    # that ends it
    starts = [loop_steps[i * gam]["t"] for i in range(LOOP_UPDATES + 1)]
    ends = starts[1:LOOP_UPDATES] + [saves[LOOP_UPDATES - 1]["t_end"]] + [saves[-1]["t_end"]]
    updates = []
    for i in range(LOOP_UPDATES + 1):
        group = loop_steps[i * gam:(i + 1) * gam]
        wall = ends[i] - starts[i]
        frames = sum(s["frames"] for s in group)
        updates.append({"update": i + 1, "seconds": wall, "checkpoint_seconds": saves[i]["seconds"],
                        "seconds_without_checkpoint": wall - saves[i]["seconds"],
                        "mel_frames": frames,
                        "frames_per_s_without_checkpoint": frames / (wall - saves[i]["seconds"])})
    meter = meter_first + back.meter.history[:1]  # the 4 updates, each with its checkpoint
    record = {
        "gpu": smi, "config": "XVAPitchConfig() + VitsDiscriminator(), seeded, warm-started",
        "params": {"generator": n_g, "discriminator": n_d}, "items": len(data["cache"].items),
        "mean_batch": mean_bs, "gam": gam, "seeding_batches": seed_batches,
        "trainer_build_seconds": build_s, "warm_start_seconds": warm_s,
        "warm_start_max_rel_err": warm_err, "seed_seconds": seed_s,
        "first_train_seconds": train_s, "first_train_result": result,
        "resumed_train_seconds": resumed_train_s,
        "micro_steps": micro, "micro_step_ms_by_bucket": by_bucket,
        "updates": updates, "frames_s_meter_mean": result["frames_s"],
        "frames_s_meter_history": meter,
        "frames_s_after_first_update": sum(meter[1:]) / len(meter[1:]),
        "frames_s_profiled_update": back.meter.history[-1],
        "prefetch_wait_ms": [w * 1e3 for w, _ in waits],
        "prefetch_wait_ms_mean_after_first": float(np.mean([w for w, _ in waits[1:]]) * 1e3)
        if len(waits) > 1
        else None,
        "checkpoints": saves, "resume_seconds": resume_s, "resume_bit_identical": same,
        "export_seconds": export_s, "export_bytes": os.path.getsize(voice),
        "export_keys": len(sd), "export_wav_seconds": serve_s, "served_samples": len(pcm),
        "preview_seconds": preview_s, "preview_samples": lens,
        "profiled_update": prof, "profiled_micro_steps": profiled_micro,
        "launches": launches, "peak_memory_gb": peak / 1e9, "amp": True, "tf32": False}
    for s in saves:
        s.pop("t_end", None)
    emit("train_loop", **record)
    return launches, record

# the multilingual phase's datasets: (language, directory, clips a v3 bucket)
ML_DATASETS = (("fr", "fr_voice", 16), ("it", "it_prior", 8), ("ro", "ro_prior", 8))
ML_BRACES = ("{K AE1 T}", "{HH AH0 L OW1}", "{W ER1 L D}")
ML_UPDATES = 3  # finetune, finetune, priors at finetune_weight 2; then stage 2: finetune, priors
FR_TEXT = "Bonjour, je suis une voix française et je parle lentement."


def tier_vocabulary(lang: str):
    """The words of 2-12 letters that ``lang``'s shipped tiers hold (its
    lexicons and the shipped g2p capture), and the digit strings they hold,
    each sorted."""
    from xva_trainer_tpu_torch.data.text.preprocessing import XvaTextPreprocessor

    tp = XvaTextPreprocessor(lang)  # no base directory: the shipped tiers alone
    words = set(tp.g2p_cache_shipped)
    for d in tp.dicts:
        words.update(d)
    letters = sorted(w for w in words if re.fullmatch(r"[^\W\d_]{2,12}", w))
    digits = sorted(w for w in words if w.isdigit() and w[0] != "0" and len(w) <= 4)
    return letters, digits


def tier_sentence(letters, digits):
    """``words(rng, n)`` for ``write_v3_dataset``: a brace group, then n
    words of the tiers, the first capitalised, punctuation after every
    fourth, a number among them where the tiers hold digits, a full stop
    last. No colon: the lexicon pass does not strip it, so a word that only
    a lexicon holds would be dropped before a colon (in the JAX package
    too)."""
    def words(rng, n):
        ws = [str(w) for w in rng.choice(letters, size=n)]
        ws[0] = ws[0].capitalize()
        for i in range(2, n, 4):
            ws[i] += str(rng.choice([",", ";", "!", "?"]))
        ws[-1] += "."
        if digits:
            ws.insert(int(rng.integers(1, n + 1)), str(rng.choice(digits)))
        return [str(rng.choice(ML_BRACES))] + ws
    return words


def tier_misses(tp, text: str) -> list:
    """The words of ``text`` that the preprocessor ``tp`` looked up in its
    g2p tiers (the user's cache, then the shipped capture) and did not find:
    with no live backend, the words it drops."""
    missed, lookup = [], tp.g2p_lookup

    def recording(word):
        hit = lookup(word)
        if hit is None:
            missed.append(word)
        return hit

    tp.g2p_lookup = recording
    try:
        tp.text_to_sequence(text)
    finally:
        del tp.g2p_lookup
    return missed


def tree_state(root: str) -> list:
    return sorted((os.path.relpath(os.path.join(d, f), root),
                   os.stat(os.path.join(d, f)).st_mtime_ns)
                  for d, _, files in os.walk(root) for f in files)


def multilingual_phase(cfg, dev, smi: str, data: dict, base_ckpt: str, work: str):
    """Phase 16, ``multilingual``: the v3 fine-tune of a French voice with
    Italian and Romanian priors, each dataset tokenized in its own language,
    as the JAX server's v3 flow runs it when given a priors root
    (``app/server.py::_run_v3``), with ``XVA_TEXT_DIR`` naming an empty
    directory (a stock install: the port's shipped tiers, no live G2P) for
    this phase only. Set-up: seeded datasets, ``fr_voice`` (64 clips, 16 a
    v3 bucket) and ``priors/{it,ro}_prior`` (32 each), their sentences drawn
    from the language's shipped tiers (``tier_vocabulary``), each sentence
    checked to lose no word. The path, launch counts set to 0 before it and
    read after it:

    1. ``preprocess_audio`` → ``pre_cache_g2p(fr_voice, "fr")`` →
       ``extract_speaker_embeddings`` (the ``data`` phase's encoder) → the
       French ``XvaFeatureCache`` and its build → ``get_dataset_embedding``
       → ``read_priors_datasets(["it", "ro"], [priors])`` → a cache a priors
       directory in ``LanguageManager.parse_language_from_dir``'s language;
    2. ``XVAPitchTrainer(XvaBatcher([fr]), cfg, priors_batcher=<weighted by
       language>)`` at full width, warm-started from phase 5's ``.pt``, with
       ``target_bs`` = 2 × the mean batch (``gam`` 2) and ``finetune_weight``
       2: ``train(max_steps=3)`` runs finetune, finetune, priors in stage 1;
       then ``stage`` = 2, as a run past its first early stop holds it, and
       ``train(max_steps=5)`` runs finetune, priors, where only the priors
       update freezes the posterior encoder and the decoder;
    3. ``export(lang="fr")`` → ``export_wav`` of a French sentence.

    Checks: every item cached with its dataset's ``lang_id`` and its
    sentence's tokens; each update's kind; the French id alone in finetune
    batches, the Italian and Romanian ids alone in priors batches; over each
    priors update ``POST_DEC`` bit-identical and every other generator
    parameter moved, over the stage-2 finetune update ``POST_DEC`` moved;
    every loss finite; ``fused_stft`` 2 and ``mas`` 1 launches a micro-step;
    the preview finite, its samples hop × its durations, a duration on each
    of its tokens; the port's ``assets/`` untouched. Reports tokenization µs
    a sentence (the first call, which parses the tiers, and warm), each
    stage's seconds, micro-step ms by kind, the prefetch wait by kind, the
    loop's mel frames a second and the request's seconds. Returns the path's
    launch counts and the record."""
    from xva_trainer_tpu_torch import serve
    from xva_trainer_tpu_torch.data.language_manager import LanguageManager
    from xva_trainer_tpu_torch.data.text import preprocessing as pp
    from xva_trainer_tpu_torch.data.text import v3_text_to_ids
    from xva_trainer_tpu_torch.data.xva_dataset import (XvaBatcher, XvaFeatureCache,
                                                        extract_speaker_embeddings,
                                                        get_dataset_embedding, lang_to_id,
                                                        read_priors_datasets)
    from xva_trainer_tpu_torch.ops import _cuda
    from xva_trainer_tpu_torch.train import xvapitch_trainer as pxt

    def fresh_text_caches():
        """What a new process holds: no processor, lexicon or capture parsed."""
        pp._PROCESSORS.clear()
        pp.XvaTextPreprocessor._DICT_CACHE.clear()
        pp.XvaTextPreprocessor._SHIPPED_G2P.clear()

    def seconds_of(fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    root = os.path.join(work, "multilingual")
    text_dir = os.path.join(root, "xva_text")
    priors_root = os.path.join(root, "priors")
    os.makedirs(text_dir)
    assets = os.path.join(REPO, "xva_trainer_tpu_torch", "assets")
    assets_before = tree_state(assets)
    saved_env = os.environ.get("XVA_TEXT_DIR")
    os.environ["XVA_TEXT_DIR"] = text_dir
    plain_prefetcher = pxt.Prefetcher
    waits: list = []
    try:
        # ---- set-up: the datasets, every word of every sentence in a tier ----
        t0 = time.perf_counter()
        specs, paths, vocab = {}, {}, {}
        for i, (lang, name, per_bucket) in enumerate(ML_DATASETS):
            letters, digits = tier_vocabulary(lang)
            vocab[lang] = {"words": len(letters), "digit_strings": len(digits)}
            paths[lang] = os.path.join(root if lang == "fr" else priors_root, name)
            specs[lang] = write_v3_dataset(paths[lang], np.random.default_rng(40 + i), lang,
                                           per_bucket, tier_sentence(letters, digits))
        setup_s = time.perf_counter() - t0
        misses = {lang: sorted({w for _, _, t in items
                                for w in tier_misses(pp.get_text_preprocessor(lang, text_dir),
                                                     t)})
                  for lang, items in specs.items()}
        live = {lang: pp.get_text_preprocessor(lang, text_dir).g2p_backend is not None
                for lang in specs}
        check(not any(misses.values()), f"multilingual: words that no tier holds: {misses}")

        # ---- the path ----
        fresh_text_caches()
        enc, stages, builds = data["enc"], {}, {}
        fr_ds = paths["fr"]
        _cuda.reset_launch_counts()
        n_pre, stages["preprocess_audio"] = seconds_of(pxt.preprocess_audio, fr_ds)
        n_g2p, stages["pre_cache_g2p"] = seconds_of(pxt.pre_cache_g2p, fr_ds, "fr")
        n_emb, stages["extract_speaker_embeddings"] = seconds_of(
            extract_speaker_embeddings, fr_ds, enc, use_postprocessed=True)
        check(n_pre == n_g2p == n_emb == len(specs["fr"]),
              f"multilingual: {n_pre} postprocessed, {n_g2p} lines through pre_cache_g2p, "
              f"{n_emb} embeddings of {len(specs['fr'])} items")

        def build(path, lang):
            c = XvaFeatureCache(path, v3_text_to_ids(lang), lang=lang, device=dev)
            before = _cuda.LAUNCHES["fused_stft"]
            _, sec = seconds_of(c.build)
            builds[os.path.basename(path)] = {
                "lang": lang, "items": len(c.items), "seconds": sec,
                "fused_stft_launches": _cuda.LAUNCHES["fused_stft"] - before,
                "stage_seconds": c.build_seconds}
            return c

        cache = build(fr_ds, "fr")
        emb, stages["get_dataset_embedding"] = seconds_of(get_dataset_embedding, fr_ds, enc)
        (dirs, langs), stages["read_priors_datasets"] = seconds_of(
            read_priors_datasets, ["it", "ro"], [priors_root], speaker_encoder=enc)
        check(langs == ["it", "ro"] and [os.path.basename(d) for d in dirs]
              == ["it_prior", "ro_prior"], f"multilingual: priors {dirs}, {langs}")
        caches = [build(d, LanguageManager.parse_language_from_dir(d) or "fr") for d in dirs]
        stages["cache_builds"] = sum(b["seconds"] for b in builds.values())
        bad_items = []
        for c in [cache] + caches:
            to_ids, texts = v3_text_to_ids(c.lang), {n: t for n, _, t in specs[c.lang]}
            for it in c.items:
                d = c.load_item(it)
                if (d is None or int(np.asarray(d["lang_id"]).reshape(-1)[0]) != lang_to_id(c.lang)
                        or not np.array_equal(d["tokens"],
                                              np.asarray(to_ids(texts[it.item_id]), np.int32))):
                    bad_items.append(f"{c.lang}:{it.item_id}")
        check(not bad_items and [len(c.items) for c in [cache] + caches]
              == [len(specs[c.lang]) for c in [cache] + caches]
              and all(b["fused_stft_launches"] == -(-b["items"] // 8) for b in builds.values()),
              f"multilingual: items with another lang_id or tokens {bad_items}; builds {builds}")

        batcher = XvaBatcher([cache], 64, emb["main"])
        priors = XvaBatcher(caches, 64, emb["main"])
        priors.weighted_by_language = True
        mean_bs = batcher.mean_batch_size()
        tcfg = pxt.XvaTrainConfig(output_dir=os.path.join(root, "out"),
                                  target_bs=int(round(2 * mean_bs)), finetune_weight=2)
        pxt.Prefetcher = timed_prefetcher(plain_prefetcher, waits, tag=lambda item: item[3])
        tr, trainer_s = seconds_of(pxt.XVAPitchTrainer, batcher, tcfg, cfg,
                                   priors_batcher=priors, device=dev)
        _, warm_s = seconds_of(tr.setup, resume=False, pretrained_ckpt=base_ckpt)
        check(tr.gam == 2, f"multilingual: gam {tr.gam} at a mean batch of {mean_bs}")
        names = [n for n, _ in tr.model.named_parameters()]
        frozen = pxt.module_mask(tr.model)
        steps, snaps = [], []
        for freeze, real in list(tr._steps.items()):
            def step(batch, gen, real=real, freeze=freeze):
                if tr.micro_steps % tr.gam == 0:  # an update's first micro-step
                    snaps.append([p.detach().clone() for p in tr.model.parameters()])
                counts = dict(_cuda.LAUNCHES)
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                meta = real(batch, gen)
                ev[1].record()
                steps.append({"freeze": freeze, "events": ev, "lang": batch["lang"],
                              "frames": batch["slens"].sum(), "meta": meta,
                              "bucket": [int(batch["tokens"].shape[1]),
                                         int(batch["pitch"].shape[-1])],
                              "batch": int(batch["tokens"].shape[0]),
                              "launches": {k: _cuda.LAUNCHES[k] - counts[k] for k in counts}})
                return meta
            tr._steps[freeze] = step
        seed_batches = len(batcher)
        first, first_s = seconds_of(tr.train, max_steps=ML_UPDATES)
        tr.stage = 2
        second, second_s = seconds_of(tr.train, max_steps=ML_UPDATES + 2)
        snaps.append([p.detach().clone() for p in tr.model.parameters()])
        voice, export_s = seconds_of(tr.export, "fr_voice", lang="fr", base_emb=emb["main"],
                                     other_embs=emb["others"].tolist())
        out_wav = os.path.join(root, "preview_fr.wav")
        _, request_s = seconds_of(serve.export_wav, {"xvap_ckpt": voice, "out_path": out_wav,
                                                     "text": FR_TEXT, "lang": "fr"},
                                  cfg=cfg, device=dev)
        launches = dict(_cuda.LAUNCHES)  # the end of the multilingual path
        tokens = serve.text_tokens(FR_TEXT, "fr")  # the request's, in French
        n_ids = len(v3_text_to_ids("fr")(FR_TEXT))

        # ---- tokenization a language: the first call (it parses the tiers), then warm ----
        tokenize = {}
        for lang, items in specs.items():
            texts = [t for _, _, t in items]
            fresh_text_caches()
            t0 = time.perf_counter()
            to_ids = v3_text_to_ids(lang)
            n_first = len(to_ids(texts[0]))
            first_us = (time.perf_counter() - t0) * 1e6
            t0 = time.perf_counter()
            n_all = [len(to_ids(t)) for t in texts]
            tokenize[lang] = {"sentences": len(texts), "first_call_us": first_us,
                              "warm_us_per_sentence": (time.perf_counter() - t0) * 1e6
                              / len(texts), "first_tokens": n_first,
                              "tokens_per_sentence": float(np.mean(n_all))}
    finally:
        pxt.Prefetcher = plain_prefetcher
        if saved_env is None:
            os.environ.pop("XVA_TEXT_DIR", None)
        else:
            os.environ["XVA_TEXT_DIR"] = saved_env

    # ---- the updates: their kinds, languages, freezes and launches ----
    torch.cuda.synchronize()
    kinds = [t for _, t in waits if t is not None]  # the stream's is_ft a micro-step
    micro = len(steps)
    check(micro == (ML_UPDATES + 2) * tr.gam and len(kinds) == micro,
          f"multilingual: {micro} micro-steps, {len(kinds)} batches streamed")
    for s, is_ft in zip(steps, kinds):
        s["kind"] = "finetune" if is_ft else "priors"
        s["langs"] = sorted({int(x) for x in s["lang"].cpu().tolist()})
        s["event_ms"] = s["events"][0].elapsed_time(s["events"][1])
        s["frames"] = int(s["frames"])
        s["not_finite"] = sorted(k for k, v in s["meta"].items()
                                 if not bool(torch.isfinite(v).all()))
    update_kinds = []
    for u in range(micro // tr.gam):
        group = {s["kind"] for s in steps[u * tr.gam:(u + 1) * tr.gam]}
        update_kinds.append(group.pop() if len(group) == 1 else "mixed")
    want_kinds = ["finetune", "finetune", "priors", "finetune", "priors"]
    ids = {k: lang_to_id(k) for k in ("fr", "it", "ro")}
    wrong_lang = [(i, s["kind"], s["langs"]) for i, s in enumerate(steps)
                  if not s["langs"] or not set(s["langs"]) <= (
                      {ids["fr"]} if s["kind"] == "finetune" else {ids["it"], ids["ro"]})]
    check(update_kinds == want_kinds and not wrong_lang,
          f"multilingual: updates {update_kinds} (want {want_kinds}); batches with other "
          f"language ids {wrong_lang}")
    # freezes: stage 1 freezes every update; in stage 2 the priors update only
    check([s["freeze"] for s in steps]
          == [True] * (ML_UPDATES * tr.gam) + [False] * tr.gam + [True] * tr.gam,
          f"multilingual: freeze flags {[s['freeze'] for s in steps]}")
    moves = []
    for u in range(len(snaps) - 1):  # bit patterns: a NaN equals itself
        moved = [not torch.equal(a.view(torch.int32), b.view(torch.int32))
                 for a, b in zip(snaps[u], snaps[u + 1])]
        moves.append({
            "update": u + 1, "kind": update_kinds[u], "stage": 1 if u < ML_UPDATES else 2,
            "post_dec_moved": sum(m for m, f in zip(moved, frozen) if f),
            "post_dec_tensors": sum(frozen),
            "rest_moved": sum(m for m, f in zip(moved, frozen) if not f),
            "rest_tensors": len(frozen) - sum(frozen),
            "rest_unmoved": [n for n, m, f in zip(names, moved, frozen) if not f and not m],
            "not_finite_after": [n for n, p in zip(names, snaps[u + 1])
                                 if not bool(torch.isfinite(p).all())]})
    del snaps
    check(all(m["post_dec_moved"] == 0 and not m["rest_unmoved"]
              for m in moves if m["kind"] == "priors")
          and moves[ML_UPDATES]["post_dec_moved"] == moves[ML_UPDATES]["post_dec_tensors"],
          f"multilingual: parameter moves by update {moves}")
    check(not any(s["not_finite"] for s in steps) and not any(m["not_finite_after"] for m in moves),
          "multilingual: losses or parameters not finite: "
          f"{[(i, s['kind'], s['not_finite']) for i, s in enumerate(steps) if s['not_finite']]}, "
          f"{[(m['update'], m['not_finite_after'][:5]) for m in moves if m['not_finite_after']]}")
    per_step = [s["launches"] for s in steps]
    want = {"fused_stft": sum(b["fused_stft_launches"] for b in builds.values())
            + 2 * (micro + seed_batches), "mas": micro + seed_batches}
    check(all(c == {"fused_stft": 2, "mas": 1} for c in per_step)
          and all(launches[k] == v for k, v in want.items()),
          f"multilingual: launches a micro-step {per_step}; the path {launches}, want {want}")

    # ---- the French preview: its samples follow its tokens ----
    sr, pcm = wavfile.read(out_wav)
    model = serve.load_xvapitch(voice, cfg, device=dev)
    n_tokens = int((tokens > 0).sum())
    g = torch.Generator().manual_seed(serve.NOISE_SEED)  # synthesize_v3's draws
    dp_noise = torch.randn((1, 2, serve.TEXT_TOKENS), generator=g)
    noise = torch.randn((1, cfg.latent_size, serve.MAX_FRAMES), generator=g)
    emb_v = serve.resolve_voice_emb(voice)
    with torch.no_grad():
        out = model.infer(torch.from_numpy(tokens)[None].to(dev),
                          torch.from_numpy(emb_v)[None].to(dev),
                          torch.tensor([lang_to_id("fr")], device=dev),
                          max_frames=serve.MAX_FRAMES, noise=noise.to(dev),
                          dp_noise=dp_noise.to(dev))
    durations = out["durations"][0].cpu()
    frames = int(out["y_lengths"][0])
    del model, out
    check(sr == SR and len(pcm) > 0 and np.isfinite(np.asarray(pcm, np.float64)).all()
          and np.abs(pcm).max() > 0 and n_tokens == min(n_ids, serve.TEXT_TOKENS)
          and int((durations > 0).sum()) == n_tokens
          and frames == min(int(durations.sum()), serve.MAX_FRAMES)
          and len(pcm) == frames * HOP,
          f"multilingual: the French request wrote {len(pcm)} samples at {sr} Hz; "
          f"{n_tokens} tokens, {int((durations > 0).sum())} with a duration, "
          f"{frames} frames of {int(durations.sum())}")
    assets_unchanged = tree_state(assets) == assets_before
    check(assets_unchanged, "multilingual: a file under the port's assets/ changed")

    by_kind = {}
    for s in steps:
        rec = by_kind.setdefault(s["kind"], {"event_ms": [], "mel_frames": [], "buckets": []})
        rec["event_ms"].append(s["event_ms"])
        rec["mel_frames"].append(s["frames"])
        rec["buckets"].append(s["bucket"] + [s["batch"]])
    for rec in by_kind.values():
        rec["median_ms"] = float(np.median(rec["event_ms"]))
    wait_ms = {"finetune": [w * 1e3 for w, t in waits if t is True],
               "priors": [w * 1e3 for w, t in waits if t is False]}
    record = {
        "gpu": smi, "config": "XVAPitchConfig() + VitsDiscriminator(), seeded, warm-started",
        "xva_text_dir_files_after": os.listdir(text_dir), "live_g2p_backend": live,
        "tier_vocabulary": vocab, "items": {k: len(v) for k, v in specs.items()},
        "set_up_seconds": setup_s, "words_no_tier_holds": misses, "stage_seconds": stages,
        "cache_builds": builds, "tokenize": tokenize, "mean_batch": mean_bs, "gam": tr.gam,
        "target_bs": tcfg.target_bs, "finetune_weight": tcfg.finetune_weight,
        "seeding_batches": seed_batches, "trainer_build_seconds": trainer_s,
        "warm_start_seconds": warm_s, "seed_seconds": tr.seed_seconds,
        "train_stage1": {**first, "seconds": first_s}, "train_stage2": {**second,
                                                                        "seconds": second_s},
        "frames_s_meter_history": list(tr.meter.history), "update_kinds": update_kinds,
        "micro_steps": [{k: s[k] for k in ("kind", "freeze", "langs", "bucket", "batch",
                                           "frames", "event_ms", "launches", "not_finite")}
                        for s in steps],
        "micro_step_ms_by_kind": by_kind, "prefetch_wait_ms": wait_ms,
        "parameter_moves": moves, "export_seconds": export_s,
        "french_request": {"text": FR_TEXT, "seconds": request_s, "tokens": n_tokens,
                           "frames": frames, "samples": len(pcm),
                           "audio_seconds": len(pcm) / SR},
        "assets_unchanged": assets_unchanged, "launches": launches, "tf32": False}
    emit("multilingual", **record)
    del tr
    torch.cuda.empty_cache()
    return launches, record


# ---------------- 17. fastpitch: the v2 FastPitch path ----------------

V2_BUCKETS = [(64, 256), (96, 384), (128, 512), (192, 768), (256, 896)]  # DEFAULT_BUCKETS
FP_STAGE1_BATCH = 46  # stage_batch_size(32, 1, 10.4 s): the stage-1 batch at these clips
FP_TEXTS = ["The quick brown fox jumps over a lazy dog.", "Seven bright voices sing of rain."]
V2_REQUESTS = ["Hello there, this is my voice.", "Quiet rivers run under old stone bridges.",
               "The harbour at dawn was calm and grey."]


def write_v2_dataset(path: str, rng: np.random.Generator, reuse_wavs: str | None,
                     per_bucket: int = CLIPS_PER_BUCKET, buckets=V2_BUCKETS) -> list:
    """A seeded English v2 dataset: ``per_bucket`` clips in each v2 bucket's
    frame range (<= 256, 257-384, 385-512, 513-768, 769-896), the clips of
    ``reuse_wavs`` (the ``data`` phase's, which fill the first four ranges)
    linked in and the rest written, each with English text whose v2 tokens
    (``TextProcessor().encode``, one a character) fit its bucket. Returns
    [(name, frames, text)]."""
    from xva_trainer_tpu_torch.data.audio_io import save_wav
    from xva_trainer_tpu_torch.data.text.processor import TextProcessor

    enc = TextProcessor().encode
    os.makedirs(os.path.join(path, "wavs"))
    have = {}
    if reuse_wavs:
        for f in sorted(os.listdir(reuse_wavs)):
            src = os.path.join(reuse_wavs, f)
            frames = (os.path.getsize(src) - 44) // 2 // HOP  # 16-bit mono PCM
            have.setdefault(next(i for i, (_, m) in enumerate(buckets) if frames <= m),
                            []).append((f, src))
    items, prev = [], 43
    for b, (text_len, mel_len) in enumerate(buckets):
        reused = have.get(b, [])[:per_bucket]
        for j, (f, src) in enumerate(reused):
            dst = os.path.join(path, "wavs", f"v2_{len(items) + j:03d}.wav")
            try:
                os.link(src, dst)
            except OSError:
                shutil.copyfile(src, dst)
        fresh = rng.integers(prev + 1, mel_len + 1, per_bucket - len(reused))
        for j, frames in enumerate(fresh):
            save_wav(os.path.join(path, "wavs", f"v2_{len(items) + len(reused) + j:03d}.wav"),
                     voiced_clip(rng, (frames * HOP + 0.5) / SR))
        for i in range(per_bucket):
            name = f"v2_{len(items):03d}"
            frames = (os.path.getsize(os.path.join(path, "wavs", name + ".wav")) - 44) // 2 // HOP
            ws = list(rng.choice(WORDS, size=max(2, int(frames) // 14)))
            while len(enc(" ".join(ws))) > min(text_len, frames):
                ws.pop()
            items.append((name, int(frames), " ".join(ws)))
        prev = mel_len
    with open(os.path.join(path, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("".join(f"{n}.wav|{t}\n" for n, _, t in items))
    return items


def fastpitch_batch(rng: np.random.Generator, n: int, text_len: int, mel_len: int) -> dict:
    """A collated v2 batch (numpy, as ``BucketBatcher`` emits it with the fp16
    feed): seeded tokens, log-mels, normalised pitch with unvoiced frames,
    energy, ragged lengths (item 0 full), and durations summing to each
    item's frames."""
    in_lens = rng.integers(text_len // 2, text_len + 1, n).astype(np.int32)
    mel_lens = rng.integers(mel_len // 2, mel_len + 1, n).astype(np.int32)
    in_lens[0], mel_lens[0] = text_len, mel_len
    b = {"tokens": np.zeros((n, text_len), np.int32),
         "mel": np.zeros((n, mel_len, 80), np.float32),
         "pitch": np.zeros((n, 1, mel_len), np.float32),
         "energy": np.zeros((n, mel_len), np.float32),
         "durs": np.zeros((n, text_len), np.float32), "in_lens": in_lens, "mel_lens": mel_lens}
    for i in range(n):
        t, m = in_lens[i], mel_lens[i]
        b["tokens"][i, :t] = rng.integers(1, 148, t)
        b["mel"][i, :m] = rng.standard_normal((m, 80)) - 4.0
        p = rng.standard_normal(m)
        p[rng.random(m) < 0.3] = 0.0
        b["pitch"][i, 0, :m] = p
        b["energy"][i, :m] = np.abs(rng.standard_normal(m)) * 20
        cuts = np.sort(rng.choice(np.arange(1, m), t - 1, replace=False))
        b["durs"][i, :t] = np.diff(np.concatenate([[0], cuts, [m]]))
    for k in ("mel", "pitch", "energy"):
        b[k] = b[k].astype(np.float16)
    return b


def fastpitch_cache_vs_cpu(cache, picks: list) -> dict:
    """Cached v2 items against the port's plain path on the CPU: each pick's
    wav featurized again by ``featurize_batch(mode="mel", device="cpu")``,
    its text tokenized again. The bars (the ``data`` phase's): log-mel within 1e-3 mean
    abs, and within 1e-3 max abs where the mel magnitude is at least
    LOG_FLOOR; energy within 1e-3 of its max abs; pitch voiced alike on more
    than 95% of frames and within 2% in Hz on 95% of the frames both call
    voiced; tokens and ``wav_len`` equal."""
    from xva_trainer_tpu_torch.data.audio_io import load_wav
    from xva_trainer_tpu_torch.data.text.processor import TextProcessor
    from xva_trainer_tpu_torch.ops.features import featurize_batch

    enc = TextProcessor().encode
    by_id = {it.item_id: it for it in cache.items}
    waves = []
    for name, _, _ in picks:
        y, _ = load_wav(by_id[name].wav_path, target_sr=SR)
        waves.append(y[: len(y) // HOP * HOP])
    ref = featurize_batch(waves, mode="mel", device="cpu")
    rows = []
    for (name, frames, text), y, r in zip(picks, waves, ref):
        d = cache.load_item(by_id[name])
        err = np.abs(d["mel"] - r["mel"])
        strong = r["mel"] >= np.log(LOG_FLOOR)
        va, vb = d["pitch"] > 0, r["pitch"] > 0
        both = va & vb
        rows.append({
            "item": name, "frames": frames, "shape": list(d["mel"].shape),
            "mel_mean_abs_err": float(err.mean()), "mel_max_abs_err": float(err.max()),
            "mel_above_floor_max_abs_err": float(err[strong].max()) if strong.any() else 0.0,
            "energy_max_rel_err": float(np.abs(d["energy"] - r["energy"]).max()
                                        / np.abs(r["energy"]).max()),
            "voicing_agreement": float((va == vb).mean()), "voiced_frames": int(both.sum()),
            "f0_p95_rel_err": float(np.percentile(np.abs(d["pitch"][both] - r["pitch"][both])
                                                  / r["pitch"][both], 95)) if both.any() else 0.0,
            "tokens_equal": bool(np.array_equal(d["tokens"], enc(text))),
            "wav_len_equal": int(np.asarray(d["wav_len"]).reshape(-1)[0]) == len(y)})
    worst = {k: max(r[k] for r in rows) for k in rows[0] if k.endswith("_err")}
    worst["voicing_agreement"] = min(r["voicing_agreement"] for r in rows)
    check(all(r["shape"] == [80, r["frames"]] and r["tokens_equal"] and r["wav_len_equal"]
              and r["voiced_frames"] > 0 for r in rows)
          and worst["mel_mean_abs_err"] < TOL and worst["mel_above_floor_max_abs_err"] < TOL
          and worst["energy_max_rel_err"] < TOL and worst["voicing_agreement"] > 0.95
          and worst["f0_p95_rel_err"] < 0.02,
          f"fastpitch: cached items against the CPU: {worst}, {rows}")
    return {"items": rows, "worst": worst}


def fastpitch_steps_vs_cpu(base_pt: str, fp_cfg, dev) -> dict:
    """One fp32 stage-1 step (the aligner; MAS on the card, its plain
    version on the CPU) and one fp32 stage-3 step (extracted durations), at
    full width, B = 2 on the 64 x 256 bucket, dropout off, SGD, from the
    base weights: on the card, on the CPU, and on the CPU with PyTorch's
    native convolutions (oneDNN off). The card's losses within 1e-3
    relative of the CPU's; each updated tensor within ``update_mismatch``'s
    bar of the nearer CPU step, at the CPU's own noise scale (its two
    convolution implementations against each other)."""
    from xva_trainer_tpu_torch.interop.fastpitch_map import load_fastpitch_checkpoint
    from xva_trainer_tpu_torch.models.fastpitch import FastPitch
    from xva_trainer_tpu_torch.train import fastpitch_trainer as pft

    cpu = torch.device("cpu")
    batch = fastpitch_batch(np.random.default_rng(41), 2, 64, 256)
    out = {}
    for stage, use_gt in ((1, False), (3, True)):
        keys = pft.batch_keys_for(stage, use_gt, True)
        metas, news, old = {}, {}, None
        for name, dv in (("gpu", dev), ("cpu", cpu), ("cpu_native_conv", cpu)):
            model = FastPitch(fp_cfg)
            load_fastpitch_checkpoint(base_pt, model)
            model.to(dv).eval()
            old = old or state_of(model)
            torch.backends.mkldnn.enabled = name != "cpu_native_conv"
            step = pft.make_stage_step(model, stage, Sgd(model.parameters()),
                                       use_gt_durs=use_gt, use_amp=False, device_prior=True)
            tb = {k: torch.from_numpy(v).to(dv) for k, v in batch.items() if k in keys}
            tb = {k: v.long() if v.dtype == torch.int32 else v for k, v in tb.items()}
            meta = step(tb, 0.5 if stage == 1 else 0.0)
            metas[name] = {k: float(v) for k, v in meta.items()}
            news[name] = state_of(model)
        torch.backends.mkldnn.enabled = True
        rel = {k: abs(metas["gpu"][k] - metas["cpu"][k]) / max(abs(metas["cpu"][k]), 1e-30)
               for k in metas["cpu"]}
        (cpu_worst, _), = [update_mismatch(o, [r], n) for o, r, n in
                           zip(old, news["cpu"], news["cpu_native_conv"])]
        scale = max(1.0, cpu_worst[0][0])
        (held, _), = [update_mismatch(o, [r, r2], n, scale) for o, r, r2, n in
                      zip(old, news["cpu"], news["cpu_native_conv"], news["gpu"])]
        out[f"stage{stage}"] = {"losses": metas["cpu"], "loss_rel_err": rel,
                                "cpu_noise_scale": scale, "worst_updates": held,
                                "cpu_onednn_vs_native": cpu_worst}
        check(max(rel.values()) < 1e-3 and held[0][0] <= 1.0
              and all(np.isfinite(v) for v in metas["gpu"].values()),
              f"fastpitch: fp32 stage-{stage} step card vs CPU: loss rel {rel}, worst update "
              f"{held[0]} at the CPU noise scale {scale}")
    return out


def fastpitch_phase(dev, smi: str, work: str, reuse_wavs: str | None, fp_cfg=None,
                    gen_cfg=None, per_bucket: int = CLIPS_PER_BUCKET, buckets=V2_BUCKETS,
                    target_bs: int = 256) -> tuple:
    """Phase 17, ``fastpitch``: the v2 path as the JAX package's
    ``_train_v2_pipeline`` runs stages 1-4, then its ``V2InferenceModel``, at
    the full width of ``FastPitchConfig()`` (seeded weights):

    1. a seeded English dataset, 64 clips in each v2 bucket (the ``data``
       phase's wavs and 64 longer ones), the shipped CMUdict written as
       ``<dataset>/cmudict.txt`` in cmudict-0.7b's layout; a base ``.pt``
       exported from seeded weights;
       before the path, one fp32 stage-1 and one fp32 stage-3 step on the
       card and on the CPU (``fastpitch_steps_vs_cpu``);
    2. the path (launch counts set to 0 just before it): the
       ``FeatureCache`` build; ``max_file_len_sec`` and a batcher factory
       with ``stage_batch_size(32, stage, ...)`` and the ARPAbet mix at
       p = 0.3; ``FastPitchTrainer(cache, FastPitchTrainConfig(32, 256,
       AMP))`` warm-started from the base; ``train`` through stages 1-4, two
       epochs each, each stage ended by its own ``finish_epoch`` hand-off
       with the early-stop state made ``finished`` by hand before its second
       epoch (the 1 → 2 hand-off extracts the durations); a second trainer
       resumed from the last checkpoint, bit-identical, one more epoch of
       stage 4; the export; ``output_samples`` of two sentences; the export
       read back into a ``V2InferenceModel`` with a seeded full-width v2
       HiFi-GAN generator, three requests (``tts`` and ``export_wav``);
    3. checks (every cached item, launches by micro-step and stage, the
       freezes over each stage's first update, durations, finite losses, the
       resume, the export's keys, the requests' lengths, the card's mel
       against the CPU's, Griffin-Lim's samples) and 8 cached items against
       the CPU; then one stage-3 pass of 10 micro-steps (an update) under
       the profiler, outside the path.

    ``fp_cfg``, ``gen_cfg``, ``per_bucket``, ``buckets`` and ``target_bs``
    shrink the phase for a rehearsal on the CPU (``dev`` the CPU). Returns
    the path's launch counts and the record."""
    from xva_trainer_tpu_torch.data.dataset import (DECODE_CHUNK, Bucket, BucketBatcher,
                                                    FeatureCache)
    from xva_trainer_tpu_torch.data.text.processor import TextProcessor
    from xva_trainer_tpu_torch.interop.fastpitch_map import (fastpitch_extra_keys,
                                                              load_fastpitch_checkpoint,
                                                              rules_for_config)
    from xva_trainer_tpu_torch.models.fastpitch import FastPitch, FastPitchConfig
    from xva_trainer_tpu_torch.models.hifigan.models import Generator, HifiganConfig
    from xva_trainer_tpu_torch.ops import _cuda
    from xva_trainer_tpu_torch.train import fastpitch_trainer as pft
    from xva_trainer_tpu_torch.train.checkpoints import export_fastpitch_v2
    from xva_trainer_tpu_torch.train.optim import _STAGE_FROZEN_MODULES
    from xva_trainer_tpu_torch.train.pipeline import V2InferenceModel, stage_batch_size

    fp_cfg = fp_cfg or FastPitchConfig()
    gen_cfg = gen_cfg or HifiganConfig()
    on_card = dev.type == "cuda"
    kernel_launch = 1 if on_card else 0  # a CPU rehearsal runs the plain versions

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # ---- set-up ----
    t0 = time.perf_counter()
    ds = os.path.join(work, "v2_voice")
    specs = write_v2_dataset(ds, np.random.default_rng(40), reuse_wavs, per_bucket, buckets)
    # the shipped dictionary in cmudict-0.7b's layout, two spaces after the
    # word: the v2 reader (CMUDict, in JAX as here) splits on them, so the
    # shipped file's one-space lines, decompressed as they are, load no entry
    with gzip.open(os.path.join(REPO, "xva_trainer_tpu_torch", "assets", "dicts",
                                "cmudict.txt.gz"), "rt", encoding="latin-1") as f, \
            open(os.path.join(ds, "cmudict.txt"), "w", encoding="latin-1") as g:
        for line in f:
            word, _, phones = line.strip().partition(" ")
            if phones:
                g.write(f"{word.upper()}  {phones}\n")
    torch.manual_seed(40)
    base = FastPitch(fp_cfg)
    with torch.no_grad():  # about 4 frames a token, so that inference speaks
        base.duration_predictor.fc.bias.fill_(1.6)
    base_pt = os.path.join(work, "fastpitch_base.pt")
    export_fastpitch_v2(base, base_pt, "base")
    del base
    setup_s = time.perf_counter() - t0
    steps_vs_cpu = fastpitch_steps_vs_cpu(base_pt, fp_cfg, dev)

    # ---- the path ----
    _cuda.reset_launch_counts()
    secs = {}
    tp = TextProcessor()
    cache = FeatureCache(ds, tp.encode, device=dev)
    before = _cuda.LAUNCHES["fused_stft"]
    _, build_prof = profiled(cache.build, named=("fused_stft_kernel",)) if on_card else (
        cache.build(), {"wall_ms": 0.0})
    build_launches = _cuda.LAUNCHES["fused_stft"] - before
    secs["cache_build"] = build_prof["wall_ms"] / 1e3
    with open(os.path.join(cache.cache_dir, ".mel_variant"), encoding="utf8") as f:
        variant = f.read()
    cached = [it for it in cache.items if cache.load_item(it) is not None]
    healed = os.path.exists(os.path.join(cache.cache_dir, "corrupt_wavs.txt"))
    # each DECODE_CHUNK of items featurized in groups of <= 8 clips
    groups = sum(-(-min(DECODE_CHUNK, len(cache.items) - c) // 8)
                 for c in range(0, len(cache.items), DECODE_CHUNK))
    check(len(cache.items) == len(cached) == len(specs) and not healed
          and variant == "pallas" and build_launches == groups * kernel_launch,
          f"fastpitch: {len(cached)} of {len(specs)} items cached, healed {healed}, variant "
          f"{variant}, {build_launches} fused_stft launches for {groups} groups")
    # the build's featurize groups: each chunk's clips by length, 8 a group,
    # each in a (clips, slot + n_fft) buffer, slots a multiple of 32 768
    group_shapes = []
    for c in range(0, len(cache.items), DECODE_CHUNK):
        lens = sorted(f * HOP for _, f, _ in specs[c: c + DECODE_CHUNK])
        group_shapes += [(len(g), -(-max(g) // 32768) * 32768 + 1024)
                         for g in (lens[i: i + 8] for i in range(0, len(lens), 8))]
    max_len = cache.max_file_len_sec()
    arpabet = TextProcessor(p_arpabet=0.3, cmudict_path=os.path.join(ds, "cmudict.txt"))
    check(len(arpabet.cmudict.entries) > 100_000, "fastpitch: the CMUdict did not load")
    made = {}

    def batcher_for(stage: int):
        # pipeline.py's factory: device_prior steps, so no host prior
        b = BucketBatcher(cache, batch_size=stage_batch_size(32, stage, max_len),
                          buckets=[Bucket(*bk) for bk in buckets], with_prior=False,
                          device_prior=True)
        b.arpabet_encoder = arpabet
        b.use_durs = cache.has_durations()
        made[stage] = b
        return b

    out_dir = os.path.join(work, "fp_out")
    cfg = pft.FastPitchTrainConfig(output_dir=out_dir, batch_size=32, target_bs=target_bs,
                                   use_amp=True)
    t0 = time.perf_counter()
    trainer = pft.FastPitchTrainer(cache, cfg, fp_cfg, device=dev)
    batcher = batcher_for(1)
    check(batcher.skipped == 0, f"fastpitch: {batcher.skipped} items fit no bucket")
    trainer.setup(batcher, pretrained_ckpt=base_pt)
    sync()
    secs["trainer_and_warm_start"] = time.perf_counter() - t0

    # every micro-step timed (synchronised), its launches, losses and frames;
    # each stage's first update watched for the freezes
    micro, align_batches, first_update = [], [], {}

    def watch(tr):
        real_get = tr._get_stage_step

        def get(stage, use_gt):
            step = real_get(stage, use_gt)

            def counted(batch, kl_weight, generator):
                opt = tr.opt
                completes = opt.mini_step == opt.grad_accum - 1
                first = completes and opt.count == 0 and stage not in first_update
                if first:
                    before = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
                counts = dict(_cuda.LAUNCHES)
                sync()
                t = time.perf_counter()
                meta = step(batch, kl_weight, generator)
                sync()
                ms = (time.perf_counter() - t) * 1e3
                rec = {"stage": stage, "use_gt": use_gt,
                       "bucket": [int(batch["tokens"].shape[1]),
                                  int(batch["mel"].shape[1]) if "mel" in batch else None],
                       "batch": int(batch["tokens"].shape[0]), "ms": ms,
                       "launches": {k: _cuda.LAUNCHES[k] - counts[k] for k in counts},
                       "mel_frames": int(batch["durs"].sum()) if "durs" in batch
                       else int(batch["mel_lens"].sum()),
                       "loss": float(meta["loss"]), "skipped_nan": float(meta["skipped_nan"]),
                       "update": completes}
                micro.append(rec)
                if first:
                    after = tr.model.state_dict()
                    frozen = _STAGE_FROZEN_MODULES[stage]
                    moved_frozen = [k for k in after if k.split(".")[0] in frozen
                                    and not torch.equal(after[k].view(torch.int32),
                                                        before[k].view(torch.int32))]
                    still = [k for k in after if k.split(".")[0] not in frozen
                             and torch.equal(after[k], before[k])]
                    zero_still = [k for k in still if float(before[k].abs().max()) == 0]
                    enc = [k for k in after if ".dec_attn." in k or ".pos_ff." in k]
                    first_update[stage] = {
                        "frozen_tensors": sum(k.split(".")[0] in frozen for k in after),
                        "frozen_moved": moved_frozen,
                        "trained_tensors": sum(k.split(".")[0] not in frozen for k in after),
                        "trained_unmoved": still, "trained_unmoved_all_zero": zero_still,
                        "encoder_layers_moved": sum(
                            not torch.equal(after[k], before[k]) for k in enc
                            if k.startswith("encoder.")),
                        "lr": opt.learning_rate(0)}
                return meta

            return counted

        tr._get_stage_step = get
        tr._stage_memo.clear()
        # the current stage's step through the wrapper (not _stage_objects,
        # which would reset a resumed early-stop state)
        tr._step_fn = get(tr.stage, tr.stage >= 2 and tr.cache.has_durations())
        real_align = pft.make_align_step(tr.model, tr.cfg.device_prior)

        def align(batch):
            n = _cuda.LAUNCHES["mas"]
            sync()
            t = time.perf_counter()
            d = real_align(batch)
            sync()
            align_batches.append({"ms": (time.perf_counter() - t) * 1e3,
                                  "mas": _cuda.LAUNCHES["mas"] - n,
                                  "batch": int(batch["tokens"].shape[0])})
            return d

        tr._align_fn = align
        return real_get

    watch(trainer)
    stages, saves = {}, []
    real_save = trainer.ckpt.save

    def save(*a, **kw):
        p = real_save(*a, **kw)
        saves.append(dict(trainer.ckpt.last_save))
        return p

    trainer.ckpt.save = save
    t_train = time.perf_counter()
    for stage in (1, 2, 3, 4):
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        n0, epochs = len(micro), []
        for epoch in range(2):
            check(trainer.stage == stage, f"fastpitch: stage {trainer.stage}, expected {stage}")
            if epoch == 1:
                trainer.early.finished = True  # the cut: this stage ends after this epoch
            t1 = time.perf_counter()
            res = trainer.train(made[stage], max_epochs=1, batcher_factory=batcher_for)
            epochs.append({"seconds": time.perf_counter() - t1, "meter_frames_s": res["frames_s"]})
        sync()
        stages[stage] = {"seconds": time.perf_counter() - t0, "epochs": epochs,
                         "micro_steps": len(micro) - n0,
                         "batch": made[stage].batch_size,
                         "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9
                         if on_card else None}
        if stage == 1:
            stages[1]["extract_durations_seconds"] = sum(a["ms"] for a in align_batches) / 1e3
    secs["train_stages_1_4"] = time.perf_counter() - t_train
    check(res["stage"] == 4 and trainer.stage == 4, f"fastpitch: ended at {res}")

    # ---- resume, then one more epoch of stage 4 ----
    t0 = time.perf_counter()
    t2 = pft.FastPitchTrainer(cache, cfg, fp_cfg, device=dev)
    t2.setup(made[4])
    sync()
    resume_s = time.perf_counter() - t0
    s1, s2 = trainer.opt.state_dict(), t2.opt.state_dict()
    same = (all(torch.equal(a, b) for a, b in zip(trainer.model.state_dict().values(),
                                                   t2.model.state_dict().values()))
            and all(torch.equal(a, b) for n in ("mu", "nu", "acc") for a, b in zip(s1[n], s2[n]))
            and (s1["count"], s1["mini_step"]) == (s2["count"], s2["mini_step"])
            and (t2.stage, t2.epoch, t2.total_iter) == (trainer.stage, trainer.epoch,
                                                       trainer.total_iter)
            and t2.early.to_dict() == trainer.early.to_dict())
    check(same, "fastpitch: the resumed trainer differs from the one it resumed")
    t2_get = watch(t2)
    n0 = len(micro)
    t0 = time.perf_counter()
    t2.train(made[4], max_epochs=1)
    sync()
    resumed_epoch = {"seconds": time.perf_counter() - t0, "micro_steps": len(micro) - n0,
                     "mini_step": t2.opt.mini_step, "count": t2.opt.count}

    # ---- export, previews, v2 inference ----
    t0 = time.perf_counter()
    export = t2.export("voice")
    export_s = time.perf_counter() - t0
    sd = torch.load(export, map_location="cpu", weights_only=True)
    want = {r.torch_key for r in rules_for_config(fp_cfg)} | set(fastpitch_extra_keys())
    with open(os.path.splitext(export)[0] + ".json") as f:
        meta_json = json.load(f)
    exported = FastPitch(fp_cfg)
    load_fastpitch_checkpoint(export, exported)
    check(set(sd) == want and all(v.dtype == torch.float16 for v in sd.values())
          and meta_json["modelType"] == "FastPitch1.1",
          f"fastpitch: the export's keys {sorted(set(sd) ^ want)[:8]}, dtypes "
          f"{sorted({str(v.dtype) for v in sd.values()})}, type {meta_json['modelType']}")
    t0 = time.perf_counter()
    samples = t2.output_samples(FP_TEXTS, os.path.join(out_dir, "viz"))
    sync()
    samples_s = time.perf_counter() - t0
    preview = []
    for text, p in zip(FP_TEXTS, samples):
        ids = tp.encode(text)
        tokens = torch.from_numpy(np.pad(ids, (0, 128 - len(ids))).astype(np.int64))[None]
        with torch.no_grad():
            n = int(t2.model.eval().infer(tokens.to(dev), mel_max_len=512)["dec_lens"][0])
        t2.model.train()
        sr, pcm = wavfile.read(p)
        preview.append({"text": text, "frames": n, "samples": len(pcm)})
        check(sr == SR and len(pcm) == (n - 1) * HOP and n > 1 and np.isfinite(pcm).all(),
              f"fastpitch: Griffin-Lim preview {preview[-1]}")
    torch.manual_seed(42)
    gen = Generator(gen_cfg).to(dev)
    t0 = time.perf_counter()
    fp_card = FastPitch(fp_cfg)
    load_fastpitch_checkpoint(export, fp_card)
    v2 = V2InferenceModel(fp_card.to(dev), gen)
    sync()
    v2_load_s = time.perf_counter() - t0
    requests = []
    for i, text in enumerate(V2_REQUESTS):
        path = os.path.join(out_dir, f"v2_{i}.wav")
        t0 = time.perf_counter()
        v2.export_wav(text, path)
        sync()
        sec = time.perf_counter() - t0
        ids = np.pad(v2.tp.encode(text), (0, 256 - len(v2.tp.encode(text))))
        wav, lens = v2.infer(torch.from_numpy(ids.astype(np.int64))[None].to(dev))
        sr, pcm = wavfile.read(path)
        requests.append({"text": text, "seconds": sec, "dec_lens": int(lens[0]),
                         "samples": len(pcm), "audio_seconds": len(pcm) / SR})
        check(sr == SR and len(pcm) == HOP * int(lens[0]) > 0 and bool(torch.isfinite(wav).all()),
              f"fastpitch: v2 request {requests[-1]}")
    launches = dict(_cuda.LAUNCHES)  # the end of the fastpitch path

    # ---- checks that read the card's results again ----
    fp_cpu = FastPitch(fp_cfg)
    load_fastpitch_checkpoint(export, fp_cpu)
    fp_cpu.eval()
    mel_cmp = []
    for text in V2_REQUESTS:
        ids = np.pad(tp.encode(text), (0, 256 - len(tp.encode(text)))).astype(np.int64)
        with torch.no_grad():
            a = v2.model.infer(torch.from_numpy(ids)[None].to(dev), mel_max_len=1024)
            b = fp_cpu.infer(torch.from_numpy(ids)[None], mel_max_len=1024)
        n = int(b["dec_lens"][0])
        mel_cmp.append({"dec_lens_equal": int(a["dec_lens"][0]) == n, "frames": n,
                        "mean_abs_err": float((a["mel_out"].cpu()[..., :n]
                                               - b["mel_out"][..., :n]).abs().mean())})
    check(all(m["dec_lens_equal"] and m["mean_abs_err"] < TOL for m in mel_cmp),
          f"fastpitch: v2 mel card vs CPU {mel_cmp}")
    stage1 = [m for m in micro if m["stage"] == 1]
    later = [m for m in micro if m["stage"] > 1]
    check(all(m["launches"]["mas"] == kernel_launch for m in stage1) and len(stage1) > 0
          and all(m["launches"]["mas"] == 0 for m in later) and len(later) > 0
          and all(a["mas"] == kernel_launch for a in align_batches) and len(align_batches) > 0,
          f"fastpitch: MAS launches by micro-step {[(m['stage'], m['launches']['mas']) for m in micro]}"
          f", by extraction batch {[a['mas'] for a in align_batches]}")
    durs_ok = []
    for it in cache.items:
        d = cache.load_durations(it.item_id)
        # the length is the ARPAbet-mixed encoding's of the extraction pass,
        # which the later epochs' draws need not repeat (as in JAX)
        durs_ok.append(d is not None and int(d.sum()) == cache.load_item(it)["mel"].shape[1])
    check(all(durs_ok), f"fastpitch: durations missing or off for {durs_ok.count(False)} items")
    check(all(np.isfinite(m["loss"]) and m["skipped_nan"] == 0 for m in micro),
          f"fastpitch: a loss not finite or a micro-step skipped: "
          f"{[(m['stage'], m['loss'], m['skipped_nan']) for m in micro]}")
    check(sorted(first_update) == [1, 2, 3, 4]
          and all(not u["frozen_moved"] and u["trained_unmoved"] == u["trained_unmoved_all_zero"]
                  for u in first_update.values())
          and first_update[1]["encoder_layers_moved"] > 0,
          f"fastpitch: the freezes over each stage's first update: {first_update}")
    # 8 items: each bucket's first, the last, and two more
    idx = {b * per_bucket for b in range(len(buckets))} | {len(specs) - 1, 1, per_bucket + 1}
    picks = [specs[i] for i in sorted(idx)]
    items_vs_cpu = fastpitch_cache_vs_cpu(cache, picks)

    # ---- one stage-3 pass of 10 micro-steps (an update) under the profiler,
    # the trainer's own loop without the timing wrapper ----
    t2._get_stage_step = t2_get
    t2._stage_memo.clear()
    t2.stage = 3
    t2._stage_objects()
    t2.reset_opt_state()
    gen_t = torch.Generator(device=dev).manual_seed(7)
    def pass3():
        return [t2.run_epoch(made[3], gen_t) for _ in range(2)]

    _, prof3 = profiled(pass3) if on_card else (pass3(), {})
    check(t2.opt.count >= 1, f"fastpitch: the profiled stage-3 pass made {t2.opt.count} updates")

    by_stage, update_s = {}, {}
    for m in micro:
        key = f"stage{m['stage']}"
        by_stage.setdefault(key, {}).setdefault(str(m["bucket"]), []).append(m["ms"])
    for s in (1, 2, 3, 4):
        window, ms = [], []
        for m in (m for m in micro if m["stage"] == s):
            window.append(m)
            if m["update"]:
                ms.append({"seconds": sum(w["ms"] for w in window) / 1e3,
                           "mel_frames": sum(w["mel_frames"] for w in window),
                           "micro_steps": len(window)})
                ms[-1]["mel_frames_per_s"] = ms[-1]["mel_frames"] / ms[-1]["seconds"]
                window = []
        update_s[f"stage{s}"] = ms
    record = {
        "config": "FastPitchConfig() (full width), seeded base .pt; HifiganConfig() generator",
        "params": sum(p.numel() for p in trainer.model.parameters()),
        "items": len(specs), "gpu": smi, "setup_seconds": setup_s, "seconds": secs,
        "steps_vs_cpu": steps_vs_cpu,
        "cache_build": {"seconds": secs["cache_build"], "groups": groups,
                        "group_shapes": group_shapes,
                        "fused_stft_device_ms": build_prof.get("named_kernels", {}).get(
                            "fused_stft_kernel", [None])[0],
                        "fused_stft_launches": build_launches, "variant": variant,
                        "host_share": build_prof.get("host_share"),
                        "device_busy_ms": build_prof.get("device_busy_ms"),
                        "stage_seconds": cache.build_seconds},
        "max_file_len_sec": max_len,
        "stage_batches": {s: stage_batch_size(32, s, max_len) for s in (1, 2, 3, 4)},
        "grad_accum": cfg.grad_accum, "stages": stages, "micro_ms_by_stage_bucket": by_stage,
        "updates_by_stage": update_s, "profiled_stage3_pass": prof3,
        "micro_steps": micro, "extract_durations": {
            "seconds": stages[1]["extract_durations_seconds"], "batches": align_batches},
        "first_update": first_update, "checkpoints": saves,
        "resume_seconds": resume_s, "resumed_epoch": resumed_epoch,
        "export": {"seconds": export_s, "mbytes": os.path.getsize(export) / 1e6},
        "output_samples_seconds": samples_s, "previews": preview,
        "v2": {"load_seconds": v2_load_s, "requests": requests, "mel_vs_cpu": mel_cmp},
        "launches": launches, "items_vs_cpu": items_vs_cpu, "tf32": False}
    return launches, record, (trainer, t2, made)


def reference_effective_weights(sd: dict) -> dict:
    """The weights of a reference-layout state dict as the reference's
    forward uses them, float64: each (weight_g, weight_v) pair combined over
    dim 0, the rest as they are."""
    out = {}
    for k, v in sd.items():
        if k.endswith("weight_g"):
            continue
        if k.endswith("weight_v") and k[:-1] + "g" in sd:
            v, g = v.double(), sd[k[:-1] + "g"].double()
            dims = list(range(1, v.dim()))
            out[k[:-len("_v")]] = v / torch.sqrt((v * v).sum(dim=dims, keepdim=True)) * g
        else:
            out[k] = v.double()
    return out


# The GAN step's fp32 updates are held to a float64 step on the card
# (gan_step_f64), each tensor by update_mismatch's bar. The noise scale is
# measured in the same run: the CPU's two fp32 steps (oneDNN and native
# convolutions) against the same float64 step. Every kernel is held at
# GAN_WEIGHT_NOISE times the CPU's worst kernel ratio (at least 1). Biases
# and weight-norm scales, in both models, are held at GAN_FP32_JUMPS bars:
# their gradients are sums (over the batch and every frame, or over a
# filter) that cancel, and the mel L1 (x45), the feature matching and every
# leaky ReLU take a branch by the sign of a value that may sit at rounding
# level, so a rounding-level change of any input flips some branches and a
# few of these sums jump by whole bars. Which ones jump differs from one
# fp32 implementation to the next, so no CPU distance, tensor by tensor,
# predicts the card's: scripts/probe_gan_fp32_noise.py measures how far six
# fp32 implementations land from the float64 step (PERF.md §6). Each
# model's whole update is also held in the L2 norm.
GAN_WEIGHT_NOISE = 2.0
GAN_FP32_JUMPS = 8.0
GAN_UPDATE_L2 = 1e-3


def gan_jumps(key: str) -> bool:
    """Whether a tensor's update may jump on fp32 rounding: a bias or a
    weight-norm scale."""
    return key.endswith(("bias", "weight_g"))


def gan_step_f64(gen, disc, wav, d_first: bool = False) -> dict:
    """A plain reference of one HiFi-GAN step (SGD, ``Sgd``) in the modules'
    dtype, float64 here, with the mels by ``rfft_reference``: the default
    order (G against the current D, then D on the detached fakes) or
    ``d_first`` (D on fakes made without gradient, then G against the
    updated D). Returns the five losses."""
    from xva_trainer_tpu_torch.models.hifigan.models import (discriminator_loss,
                                                             feature_matching_loss,
                                                             generator_adv_loss)
    from xva_trainer_tpu_torch.ops.stft import LOSS_MEL, MelConfig
    from xva_trainer_tpu_torch.train.hifigan_trainer import MEL_WEIGHT

    def mel(y, cfg):
        return rfft_reference(y, cfg, False, 1e-9)[0]

    with torch.no_grad():
        mel_in, mel_real = mel(wav[:, 0], MelConfig()), mel(wav[:, 0], LOSS_MEL)
    g_params, d_params = list(gen.parameters()), list(disc.parameters())

    def d_step(y_hat):
        outs_r, outs_g, _, _ = disc(wav, y_hat, update_sn_stats=True)
        d_loss = discriminator_loss(outs_r, outs_g)
        Sgd(d_params).step(torch.autograd.grad(d_loss, d_params))
        return d_loss

    if d_first:
        with torch.no_grad():
            y_hat = gen(mel_in)
        d_loss = d_step(y_hat)
    y = gen(mel_in)
    mel_l1 = (mel(y[:, 0], LOSS_MEL) - mel_real).abs().mean()
    _, outs_g, fmaps_r, fmaps_g = disc(wav, y)
    adv, fm = generator_adv_loss(outs_g), feature_matching_loss(fmaps_r, fmaps_g)
    g_loss = MEL_WEIGHT * mel_l1 + adv + fm
    Sgd(g_params).step(torch.autograd.grad(g_loss, g_params))
    if not d_first:
        d_loss = d_step(y.detach())
    return {k: float(v) for k, v in (("mel_l1", mel_l1), ("adv", adv), ("fm", fm),
                                     ("g_loss", g_loss), ("d_loss", d_loss))}


def gan_held(old_p: list, ref: list, new: list, noise: float) -> dict:
    """Each model's tensors of ``new`` against ``ref`` (update_rows at scale
    1): the worst ratio of the biases and weight-norm scales and of the
    kernels, the tensors over their bar (``GAN_FP32_JUMPS``, ``noise``),
    and each model's L2 distance (update_l2_rel)."""
    rows = [row for o, r, n in zip(old_p, ref, new) for row in update_rows(o, [r], n)]
    jumps = [row for row in rows if gan_jumps(row[1])]
    kernels = [row for row in rows if not gan_jumps(row[1])]
    return {"worst": {"biases_and_scales": max(jumps)[:3], "kernels": max(kernels)[:3]},
            "l2_rel": [update_l2_rel(o, r, n) for o, r, n in zip(old_p, ref, new)],
            "over": [row[:3] for row in jumps if row[0] > GAN_FP32_JUMPS]
            + [row[:3] for row in kernels if row[0] > noise]}


def update_l2_rel(old: dict, ref: dict, new: dict) -> float:
    """||new's update - ref's update|| / ||ref's update||, over every tensor
    of the state together."""
    num = sum(float(((new[k] - old[k]) - (ref[k] - old[k])).double().pow(2).sum()) for k in old)
    den = sum(float((ref[k] - old[k]).double().pow(2).sum()) for k in old)
    return math.sqrt(num / den) if den else (0.0 if num == 0 else float("inf"))


def seeded_hifigan(gen_cfg, disc_factory, seed: int):
    """A v2 HiFi-GAN generator and discriminator from the modules' own
    initialisation under ``torch.manual_seed(seed)`` (every weight-norm
    scale 1, as the JAX package's flax modules start)."""
    from xva_trainer_tpu_torch.models.hifigan import Generator

    torch.manual_seed(seed)
    return Generator(gen_cfg), disc_factory()


def without_sn(state: dict) -> dict:
    """A state dict without the spectral norm's vectors (compared apart)."""
    return {k: v for k, v in state.items() if not k.endswith(("weight_u", "weight_v"))}


def hifigan_phase(dev, smi: str, work: str, ds: str, gen_cfg=None, fp_cfg=None,
                  disc_factory=None, seg_batch: int = 2) -> tuple:
    """Phase 18, ``hifigan``: the v2 HiFi-GAN stage and the v2 pipeline at
    the full width of ``HifiganConfig()`` and ``HifiganDiscriminator()``, on
    the ``fastpitch`` phase's dataset ``ds`` (320 seeded clips, the CMUdict
    in cmudict-0.7b's layout):

    1. one GAN step (SGD, so that the updates compare the gradients; AMP
       and TF32 off) at B = 2 on 8 192-sample segments of the dataset, in
       both orders, from the same seeded weights: in fp32 on the card, in
       float64 on the card (``gan_step_f64``, the reference), and in fp32 on
       the CPU with oneDNN and with its native convolutions (the noise
       scale). The card's five losses within 1e-3 relative of the CPU's and
       of the float64 step's; each updated tensor within ``update_mismatch``'s
       bar of the float64 update, biases and weight-norm scales at
       ``GAN_FP32_JUMPS`` bars and every kernel at ``GAN_WEIGHT_NOISE``
       times the CPU steps' worst kernel ratio; each model's whole update
       within ``GAN_UPDATE_L2`` (L2); MSD disc 0's ``u`` within 1e-4 of the
       CPU's; the two orders' D updates on the card equal by the same bars;
    2. the same default-order step under AMP: its G and D losses within 5% of
       fp32's;
    3. a warm start: seeded reference-layout ``g_`` and ``do_`` files, then
       ``HifiganTrainer.setup(resume=False, pretrained_g, pretrained_do)``:
       the effective weights within 1e-5 relative of the files', MSD disc 0's
       ``weight_orig`` and ``weight_u`` equal, ``epoch`` and ``total_iter``
       from the file;
    4. the path (launch counts set to 0 just before it): ``train_v2_pipeline``
       on a copy of ``ds`` without its cache (batch 32, 2 FastPitch epochs,
       2 HiFi-GAN epochs): the v2 cache build, FastPitch stage 1 and its
       export, the HiFi-GAN trainer built at the hand-off (B = 16, 60 steps
       an epoch, a checkpoint each epoch), the ``.hg.pt`` export; each
       HiFi-GAN step timed (synchronised) with its launches;
    5. a second trainer resumed from the directory, bit-identical, then one
       more epoch;
    6. three ``V2InferenceModel`` requests on the two exports (the end of
       the path);
    7. outside the path: 5 timed steps in the ``d_first`` order, 10 default
       steps under the profiler, and the generated-side mel's forward and
       backward (``ops/stft.py``) timed beside the fused kernel's two
       launches at the step's shape.

    ``gen_cfg``, ``fp_cfg``, ``disc_factory`` and ``seg_batch`` shrink the
    phase for a rehearsal on the CPU (``dev`` the CPU). Returns the path's
    launch counts and the record."""
    from xva_trainer_tpu_torch.interop.convert import ups_to_reference
    from xva_trainer_tpu_torch.interop.fastpitch_map import load_fastpitch_checkpoint
    from xva_trainer_tpu_torch.interop.hifigan_map import v2_generator_rules
    from xva_trainer_tpu_torch.interop.pretrained import load_hifigan_generator
    from xva_trainer_tpu_torch.models.fastpitch import FastPitch, FastPitchConfig
    from xva_trainer_tpu_torch.models.hifigan import (Generator, HifiganConfig,
                                                      HifiganDiscriminator)
    from xva_trainer_tpu_torch.ops import _cuda
    from xva_trainer_tpu_torch.ops.fused_stft import mel_spectrogram_fused
    from xva_trainer_tpu_torch.ops.stft import LOSS_MEL, MelConfig, mel_spectrogram_hifigan
    from xva_trainer_tpu_torch.train import hifigan_trainer as pht
    from xva_trainer_tpu_torch.train.pipeline import (PipelineConfig, V2InferenceModel,
                                                      train_v2_pipeline)

    gen_cfg = gen_cfg or HifiganConfig()
    fp_cfg = fp_cfg or FastPitchConfig()
    full_disc = pht.HifiganDiscriminator
    disc_factory = disc_factory or HifiganDiscriminator
    on_card = dev.type == "cuda"
    kernel_launch = 1 if on_card else 0  # a CPU rehearsal runs the plain versions
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # ---- 1. one fp32 step, card against CPU, both orders ----
    gen0, disc0 = seeded_hifigan(gen_cfg, disc_factory, 60)
    n_g = sum(p.numel() for p in gen0.parameters())
    n_mpd = sum(p.numel() for p in disc0.mpd.parameters())
    n_msd = sum(p.numel() for p in disc0.msd.parameters())
    old = state_of(gen0, disc0)
    sampler = pht.SegmentSampler(ds, seg_batch, seed=61, data_mult=1)
    seg = torch.from_numpy(np.ascontiguousarray(next(sampler.epoch()).transpose(0, 2, 1)))

    def fresh(dv):
        g, d = Generator(gen_cfg), disc_factory()
        g.load_state_dict(old[0])
        d.load_state_dict(old[1])
        return g.to(dv), d.to(dv)

    metas, news, secs = {}, {}, {}
    runs = [("gpu", dev, False), ("gpu_d_first", dev, True), ("gpu_f64", dev, False),
            ("gpu_f64_d_first", dev, True), ("cpu", cpu, False), ("cpu_d_first", cpu, True),
            ("cpu_native_conv", cpu, False), ("cpu_native_conv_d_first", cpu, True)]
    for name, dv, d_first in runs:
        g, d = (gen0, disc0) if name == "cpu" else fresh(dv)
        torch.backends.mkldnn.enabled = "native" not in name
        t0 = time.perf_counter()
        if "f64" in name:
            metas[name] = gan_step_f64(g.double(), d.double(), seg.to(dv, torch.float64),
                                       d_first)
        else:
            step = pht.make_gan_step(g, d, Sgd(g.parameters()), Sgd(d.parameters()),
                                     MelConfig(), use_amp=False, d_first=d_first)
            metas[name] = {k: float(v) for k, v in step(seg.to(dv)).items()}
            del step
        sync()
        secs[name] = time.perf_counter() - t0
        news[name] = state_of(g, d)
        del g, d
    torch.backends.mkldnn.enabled = True
    loss_rel = {o: {k: abs(metas[f"gpu{o}"][k] - metas[f"cpu{o}"][k])
                    / max(abs(metas[f"cpu{o}"][k]), 1e-30) for k in metas["cpu"]}
                for o in ("", "_d_first")}
    loss_rel_f64 = {o: {k: abs(metas[f"gpu{o}"][k] - metas[f"gpu_f64{o}"][k])
                        / max(abs(metas[f"gpu_f64{o}"][k]), 1e-30) for k in metas["cpu"]}
                    for o in ("", "_d_first")}
    old_p = [without_sn(x) for x in old]
    new_p = {k: [without_sn(x) for x in v] for k, v in news.items()}
    # every fp32 step against its order's float64 step; the kernels' noise
    # scale is the CPU steps' worst kernel ratio there
    held = {f"{run}{o}": gan_held(old_p, new_p[f"gpu_f64{o}"], new_p[f"{run}{o}"], 0.0)
            for run in ("gpu", "cpu", "cpu_native_conv") for o in ("", "_d_first")}
    cpu_noise = max([1.0] + [held[f"{run}{o}"]["worst"]["kernels"][0]
                             for run in ("cpu", "cpu_native_conv") for o in ("", "_d_first")])
    noise = GAN_WEIGHT_NOISE * cpu_noise
    card = {o: gan_held(old_p, new_p[f"gpu_f64{o}"], new_p[f"gpu{o}"], noise)
            for o in ("", "_d_first")}
    # the two orders' D updates on the card: the same function of the same
    # fakes, held by the same bars
    orders_d = gan_held(old_p[1:], new_p["gpu"][1:], new_p["gpu_d_first"][1:], noise)
    u_err = {o: max(float((news[f"gpu{o}"][1][k] - news[f"cpu{o}"][1][k]).abs().max())
                    for k in old[1] if k.endswith("weight_u"))
             for o in ("", "_d_first")}
    # (conv_post's u has one entry, which stays at its sign)
    u_moved = all(not torch.equal(news["gpu"][1][k], old[1][k]) for k in old[1]
                  if k.endswith("weight_u") and old[1][k].numel() > 1)
    worst_l2 = max(v for h in card.values() for v in h["l2_rel"])
    margins = {"biases_and_scales": GAN_FP32_JUMPS / max(
                   h["worst"]["biases_and_scales"][0] for h in card.values()),
               "kernels": noise / max(h["worst"]["kernels"][0] for h in card.values()),
               "l2": GAN_UPDATE_L2 / worst_l2}
    step_vs_cpu = {
        "batch": [seg_batch, pht.SEGMENT_SIZE], "optimizer": "SGD lr 1e-3", "amp": False,
        "losses": {"g_first": metas["cpu"], "d_first": metas["cpu_d_first"],
                   "g_first_f64": metas["gpu_f64"], "d_first_f64": metas["gpu_f64_d_first"]},
        "loss_rel_err": loss_rel, "loss_rel_err_vs_f64": loss_rel_f64,
        "against_f64": {k: {"worst": v["worst"], "l2_rel": v["l2_rel"]} for k, v in held.items()},
        "cpu_noise_scale": cpu_noise, "kernels_bar": noise,
        "biases_and_scales_bar": GAN_FP32_JUMPS, "l2_bar": GAN_UPDATE_L2,
        "card_over_bar": {o: h["over"] for o, h in card.items()}, "margins": margins,
        "u_max_abs_err": u_err, "u_moved": u_moved,
        "d_update_orders_on_card": orders_d, "seconds": secs}
    check(max(v for o in loss_rel.values() for v in o.values()) < 1e-3
          and max(v for o in loss_rel_f64.values() for v in o.values()) < 1e-3
          and not any(h["over"] for h in card.values()) and worst_l2 < GAN_UPDATE_L2
          and max(u_err.values()) < 1e-4 and u_moved and not orders_d["over"],
          f"hifigan: the fp32 step against float64 and the CPU: {step_vs_cpu}")

    # ---- 2. AMP against fp32 ----
    g, d = fresh(dev)
    step = pht.make_gan_step(g, d, Sgd(g.parameters()), Sgd(d.parameters()), MelConfig(),
                             use_amp=True)
    amp_meta = {k: float(v) for k, v in step(seg.to(dev)).items()}
    amp_rel = {k: abs(amp_meta[k] - metas["gpu"][k]) / abs(metas["gpu"][k])
               for k in ("g_loss", "d_loss")}
    check(max(amp_rel.values()) < 0.05 and all(np.isfinite(v) for v in amp_meta.values()),
          f"hifigan: AMP losses {amp_meta} against fp32 {metas['gpu']}")
    del g, d, step

    # ---- 3. the warm start from reference-layout g_ / do_ files ----
    g_path, do_path = os.path.join(work, "g_00004242"), os.path.join(work, "do_00004242")
    torch.save({"generator": ups_to_reference(old[0])}, g_path)
    mpd_sd = {k[len("mpd."):]: v for k, v in old[1].items() if k.startswith("mpd.")}
    msd_sd = {k[len("msd."):]: v for k, v in old[1].items() if k.startswith("msd.")}
    torch.save({"mpd": mpd_sd, "msd": msd_sd, "steps": 4242, "epoch": 7}, do_path)
    warm_cfg = pht.HifiganTrainConfig(output_dir=os.path.join(work, "hifi_warm"))
    pht.HifiganDiscriminator = disc_factory
    try:
        t0 = time.perf_counter()
        warm = pht.HifiganTrainer(ds, warm_cfg, gen_cfg, device=dev)
        warm.setup(resume=False, pretrained_g=g_path, pretrained_do=do_path)
        sync()
        warm_s = time.perf_counter() - t0
        want_g = reference_effective_weights(ups_to_reference(old[0]))
        want_d = reference_effective_weights({k: v for k, v in old[1].items()
                                              if not k.startswith("msd.discriminators.0.")})
        have_g, have_d = effective_weights(warm.gen), effective_weights(warm.disc)
        rel = max(float((have[k] - v).abs().max() / max(float(v.abs().max()), 1e-30))
                  for want, have in ((want_g, have_g), (want_d, have_d)) for k, v in want.items())
        sd = warm.disc.state_dict()
        spectral_equal = all(torch.equal(sd[k].cpu(), old[1][k]) for k in old[1]
                             if k.startswith("msd.discriminators.0.")
                             and k.endswith(("weight_orig", "weight_u")))
        warm_rec = {"seconds": warm_s, "max_rel_err": rel, "spectral_equal": spectral_equal,
                    "epoch": warm.epoch, "total_iter": warm.total_iter,
                    "keys": [len(want_g), len(want_d)]}
        check(rel < 1e-5 and spectral_equal and warm.epoch == 8 and warm.total_iter == 4242,
              f"hifigan: the warm start {warm_rec}")
        del warm

        # ---- 4. the path: the v2 pipeline from the dataset to both exports ----
        pipe_ds = os.path.join(work, "pipe_voice")
        os.makedirs(pipe_ds)
        os.symlink(os.path.join(ds, "wavs"), os.path.join(pipe_ds, "wavs"))
        for f in ("metadata.csv", "cmudict.txt"):
            shutil.copyfile(os.path.join(ds, f), os.path.join(pipe_ds, f))
        out_dir = os.path.join(work, "pipe_out")
        trainers, steps, saves, epochs, marks = [], [], [], [], {}

        def watch(tr, tag):
            real = tr._step_fn

            def counted(wav):
                counts = dict(_cuda.LAUNCHES)
                sync()
                t = time.perf_counter()
                meta = real(wav)
                sync()
                steps.append({"run": tag, "ms": (time.perf_counter() - t) * 1e3,
                              "launches": {k: _cuda.LAUNCHES[k] - counts[k] for k in counts},
                              **{k: float(v) for k, v in meta.items()}})
                return meta

            real_epoch, real_save = tr.run_epoch, tr.ckpt.save

            def run_epoch():
                t = time.perf_counter()
                losses = real_epoch()
                epochs.append({"run": tag, "seconds": time.perf_counter() - t,
                               "steps": len(losses), "meter_frames_s": tr.meter.mean()})
                return losses

            def save(*a, **kw):
                p = real_save(*a, **kw)
                saves.append(dict(tr.ckpt.last_save))
                return p

            tr._step_fn, tr.run_epoch, tr.ckpt.save = counted, run_epoch, save
            return real

        def on_trainer(tr):
            trainers.append(tr)
            if isinstance(tr, pht.HifiganTrainer):
                sync()
                marks["hand_off"] = time.perf_counter()
                marks["launches_at_hand_off"] = dict(_cuda.LAUNCHES)
                if on_card:
                    torch.cuda.reset_peak_memory_stats()
                marks["real_step"] = watch(tr, "pipeline")
                real_export = tr.export

                def export(*a, **kw):
                    t = time.perf_counter()
                    path = real_export(*a, **kw)
                    marks["export_s"] = time.perf_counter() - t
                    return path

                tr.export = export

        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        res = train_v2_pipeline(
            PipelineConfig(dataset_path=pipe_ds, output_path=out_dir, batch_size=32,
                           max_fp_epochs=2, max_hifi_epochs=2, voice_name="smoke"),
            fp_cfg, gen_cfg, on_trainer=on_trainer, device=dev)
        sync()
        pipe_s = time.perf_counter() - t0
        hifi_s = time.perf_counter() - marks["hand_off"]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
        hifi = trainers[-1]
        fp_path, hg_path = res["exports"]
        pipe_steps = [s for s in steps if s["run"] == "pipeline"]
        hg = torch.load(hg_path, map_location="cpu", weights_only=True)
        ref_keys = set()
        for r in v2_generator_rules(num_ups=len(gen_cfg.upsample_rates),
                                    num_kernels=len(gen_cfg.resblock_kernel_sizes),
                                    num_dilations=len(gen_cfg.resblock_dilation_sizes[0])):
            ref_keys |= ({r.torch_key + ".weight_g", r.torch_key + ".weight_v"}
                         if r.kind.startswith("wn_") else {r.torch_key})
        loaded = Generator(gen_cfg)
        load_hifigan_generator(hg_path, loaded)
        want_lr = float(np.float32(2e-4 * 0.999 ** 2))
        n_epoch = len(hifi.sampler)
        check(os.path.exists(fp_path) and os.path.exists(hg_path) and list(hg) == ["generator"]
              and set(hg["generator"]) == ref_keys
              and all(v.dtype == torch.float32 for v in hg["generator"].values()),
              f"hifigan: the exports {res['exports']}, .hg.pt keys {list(hg)[:3]}")
        check(len(pipe_steps) == 2 * n_epoch and hifi.total_iter == 2 * n_epoch
              and hifi.epoch == 2 and all(np.isfinite(s["mel_l1"]) for s in pipe_steps)
              and hifi.g_opt.lr == hifi.d_opt.lr == want_lr
              and all(s["launches"]["fused_stft"] == 2 * kernel_launch
                      and s["launches"]["mas"] == 0 for s in pipe_steps),
              f"hifigan: the pipeline's HiFi-GAN stage: {len(pipe_steps)} steps of "
              f"{2 * n_epoch}, epoch {hifi.epoch}, lr {hifi.g_opt.lr} (want {want_lr}), "
              f"launches {[s['launches'] for s in pipe_steps[:3]]}, mel L1 "
              f"{[s['mel_l1'] for s in pipe_steps][:8]}")

        # ---- 5. the resume, bit for bit, then one more epoch ----
        t0 = time.perf_counter()
        resumed = pht.HifiganTrainer(pipe_ds, hifi.cfg, gen_cfg, device=dev)
        resumed.setup()
        sync()
        resume_s = time.perf_counter() - t0

        def same_state(a, b):
            sa, sb = a.state_dict(), b.state_dict()
            return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)

        def same_opt(a, b):
            s1, s2 = a.state_dict(), b.state_dict()
            return ((s1["count"], s1["lr"]) == (s2["count"], s2["lr"])
                    and all(torch.equal(x, y) for n in ("mu", "nu") for x, y in zip(s1[n], s2[n])))

        same = (same_state(hifi.gen, resumed.gen) and same_state(hifi.disc, resumed.disc)
                and same_opt(hifi.g_opt, resumed.g_opt) and same_opt(hifi.d_opt, resumed.d_opt)
                and (resumed.epoch, resumed.total_iter, resumed.early.to_dict())
                == (hifi.epoch, hifi.total_iter, hifi.early.to_dict()))
        check(same, "hifigan: the resumed trainer differs from the one it resumed")
        real_step = watch(resumed, "resumed")
        resumed.train(max_epochs=1)
        sync()
        more = [s for s in steps if s["run"] == "resumed"]
        check(len(more) == n_epoch and resumed.total_iter == 3 * n_epoch
              and all(s["launches"]["fused_stft"] == 2 * kernel_launch
                      and s["launches"]["mas"] == 0 and np.isfinite(s["mel_l1"]) for s in more),
              f"hifigan: the resumed epoch: {len(more)} steps, {resumed.total_iter} in all")

        # ---- 6. three v2 requests on what the pipeline trained ----
        fp_model = FastPitch(fp_cfg)
        load_fastpitch_checkpoint(fp_path, fp_model)
        v2 = V2InferenceModel(fp_model.to(dev), loaded.to(dev))
        requests = []
        for i, text in enumerate(V2_REQUESTS):
            path = os.path.join(out_dir, f"req_{i}.wav")
            t0 = time.perf_counter()
            v2.export_wav(text, path)
            sync()
            sec = time.perf_counter() - t0
            ids = np.pad(v2.tp.encode(text), (0, 256 - len(v2.tp.encode(text))))
            wav, lens = v2.infer(torch.from_numpy(ids.astype(np.int64))[None].to(dev))
            sr, pcm = wavfile.read(path)
            requests.append({"text": text, "seconds": sec, "dec_lens": int(lens[0]),
                             "samples": len(pcm)})
            check(sr == SR and len(pcm) == HOP * int(lens[0]) > 0
                  and bool(torch.isfinite(wav).all()), f"hifigan: v2 request {requests[-1]}")
        launches = dict(_cuda.LAUNCHES)  # the end of the hifigan path

        # ---- 7. outside the path: d_first steps, a profiled pass, the mels ----
        wav = resumed._to_device(next(resumed.sampler.epoch()))
        d_first = pht.make_gan_step(resumed.gen, resumed.disc, resumed.g_opt, resumed.d_opt,
                                    MelConfig(), use_amp=True, d_first=True)
        d_first_ms = []
        for _ in range(5):
            sync()
            t = time.perf_counter()
            d_first(wav)
            sync()
            d_first_ms.append((time.perf_counter() - t) * 1e3)

        def ten_steps():
            return [real_step(wav) for _ in range(10)]

        _, prof = profiled(ten_steps, named=("fused_stft_kernel", "fft")) if on_card else (
            ten_steps(), {})
        y_gen = torch.randn(wav.shape[0], wav.shape[-1], device=dev) * 0.3
        target = mel_spectrogram_fused(wav[:, 0], LOSS_MEL, center=False, mag_eps=1e-9)

        def generated_side():  # forward and backward of the differentiable loss mel
            y = y_gen.clone().requires_grad_(True)
            loss = (mel_spectrogram_hifigan(y, LOSS_MEL) - target).abs().mean()
            return torch.autograd.grad(loss, y)

        def fused_two():  # the step's two launches
            return (mel_spectrogram_fused(wav[:, 0], MelConfig(), center=False, mag_eps=1e-9),
                    mel_spectrogram_fused(wav[:, 0], LOSS_MEL, center=False, mag_eps=1e-9))

        mel_ms = {}
        if on_card:  # the call as the host sees it, and device busy under the profiler
            for key, fn in (("generated_side_fwd_bwd", generated_side),
                            ("fused_two_launches", fused_two)):
                _, p10 = profiled(lambda: [fn() for _ in range(10)])
                busy = p10.get("device_busy_ms")
                mel_ms[key] = {"call_ms": cuda_ms(fn),
                               "device_busy_ms": busy / 10 if busy is not None else p10["device"],
                               "kernels_a_call": p10.get("kernels", 0) / 10}
    finally:
        pht.HifiganDiscriminator = full_disc

    warm_steps = [s["ms"] for s in pipe_steps[1:]]
    per_step_frames = hifi.cfg.batch_size * (pht.SEGMENT_SIZE // HOP)
    record = {
        "config": "HifiganConfig() and HifiganDiscriminator() (full width), seeded; "
                  "the pipeline on FastPitchConfig()",
        "params": {"generator": n_g, "mpd": n_mpd, "msd": n_msd}, "gpu": smi,
        "step_vs_cpu": step_vs_cpu, "amp_vs_fp32": {"amp": amp_meta, "rel": amp_rel},
        "warm_start": warm_rec,
        "pipeline": {"seconds": pipe_s, "hifigan_stage_seconds": hifi_s,
                     "fastpitch": res["fastpitch"], "hifigan": res["hifigan"],
                     "exports": {os.path.basename(p): os.path.getsize(p) / 1e6
                                 for p in res["exports"]},
                     "launches_at_hand_off": marks["launches_at_hand_off"],
                     "trainers": [type(t).__name__ for t in trainers],
                     "batch": hifi.cfg.batch_size, "data_mult": hifi.sampler.data_mult,
                     "steps_an_epoch": n_epoch, "lr_after": hifi.g_opt.lr,
                     "peak_memory_gb": peak_gb},
        "step_ms": {"first": pipe_steps[0]["ms"], "warm_median": float(np.median(warm_steps)),
                    "warm_min": min(warm_steps), "warm_max": max(warm_steps),
                    "d_first_warm": d_first_ms[1:], "d_first_first": d_first_ms[0]},
        "mel_frames_per_step": per_step_frames,
        "mel_frames_per_s_warm_median": per_step_frames / (np.median(warm_steps) / 1e3),
        "epochs": epochs, "checkpoints": saves, "resume_seconds": resume_s,
        "export": {"seconds": marks["export_s"], "mbytes": os.path.getsize(hg_path) / 1e6},
        "mel_l1": {"first": pipe_steps[0]["mel_l1"], "last": more[-1]["mel_l1"]},
        "requests": requests, "profiled_10_steps": prof, "loss_mels": mel_ms,
        "launches": launches, "tf32": False,
        "launches_per_step": {k: sum(s["launches"][k] for s in pipe_steps) / len(pipe_steps)
                              for k in ("fused_stft", "mas")},
        "phase_seconds": time.perf_counter() - t_phase}
    return launches, record


SERVER_PER_BUCKET = 16    # the v3 job's clips a bucket, of the data phase's 64
SERVER_BATCH = 16         # the v3 job's batch at the largest bucket
SERVER_TARGET_BS = 128    # gam = ceil(128 / 16) = 8 micro-steps an update
SERVER_V2_BATCH = 16      # the v2 job's HiFi-GAN batch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def http_call(port: int, path: str, body=None, timeout: float = 600.0):
    """POST ``body`` as JSON to the server: (status, reply, seconds)."""
    import http.client

    conn = http.client.HTTPConnection("localhost", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, body=json.dumps(body or {}).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, json.loads(raw), time.perf_counter() - t0
    finally:
        conn.close()


def server_phase(dev, smi: str, work: str, data_ds: str, base_ckpt: str | None, v2_ds: str,
                 serve_requests: list, model_config: dict | None = None,
                 src_per_bucket: int = CLIPS_PER_BUCKET, per_bucket: int = SERVER_PER_BUCKET,
                 batch: int = SERVER_BATCH, target_bs: int = SERVER_TARGET_BS) -> tuple:
    """Phase 19, ``server``: the port's task server as the UI drives it.

    ``serve_with_http`` runs on a thread on two free localhost ports; the
    ``AppServer`` stays in this process, so its trainers can be inspected;
    everything else goes over real sockets (HTTP with ``http.client``, the
    websocket with ``WsClient``):

    1. ``/checkReady``, ``/setDevice`` ``cuda`` (``tpu`` refused),
       ``/datasetInfo`` on the v3 job's dataset: ``per_bucket`` clips a v3
       bucket copied from the ``data`` phase's dataset ``data_ds``;
    2. ``startTraining`` of a v3 fine-tune at the full width of
       ``XVAPitchConfig()`` (``model_config`` and smaller batches only for
       a rehearsal on the CPU), batch 16, ``target_bs`` 128, ``save_step`` 1,
       ``max_steps`` 2, warm-started
       from ``base_ckpt``: preprocess, G2P, speaker embeddings, the cache
       build, the warm start, the seeding pass, two updates with
       checkpoints, the export;
    3. while it trains, a v2 ``startTraining`` (``force_stage`` 5, batch 16,
       on ``v2_ds``) comes back as a ``task_info`` "queued" event; a
       ``pause`` holds ``micro_steps`` still for 3 s, then ``resume``;
    4. the queue moves on to the v2 job; once its HiFi-GAN trainer has
       finished an epoch, ``stop``: ``/queue`` says not running, the worker
       thread ends (its seconds after the stop recorded), and no kernel is
       launched after it;
    5. ``startTraining`` of the v3 job again with ``max_steps`` 3: it
       resumes from its checkpoints, takes the third update, exports, and
       ends the queue with ``tasks_next``;
    6. ``/exportWav`` on the v3 output directory (the newest checkpoint,
       restored by the server), equal sample for sample to
       ``serve.synthesize_v3`` and the loudness normalization on the
       trainer's model; ``/exportWav`` on the exported ``.pt``, cold then
       warm for each of ``TEXTS``, beside ``serve.export_wav`` in process on
       the same file and texts and phase 5's requests (``serve_requests``);
       ``/exportVoice`` (the ``.pt``/``.json`` pair and its preview);
    7. ``/resourceUsage`` on ``cuda``; one ``/exportWav`` between
       ``/profileStart`` and ``/profileStop``, whose trace must hold CUDA
       kernels; ``/stopServer`` ends the server.

    Returns the path's launch counts (from the first ``startTraining`` to
    the server's stop) and the record."""
    import asyncio

    from xva_trainer_tpu_torch.app.server import AppServer, make_logger
    from xva_trainer_tpu_torch.models.xvapitch import XVAPitchConfig
    from xva_trainer_tpu_torch.ops import _cuda
    from xva_trainer_tpu_torch.ops.loudness import normalize_ebu_r128
    from xva_trainer_tpu_torch.serve import export_wav, save_wav as serve_save, synthesize_v3
    from xva_trainer_tpu_torch.train import checkpoints as pck
    from xva_trainer_tpu_torch.train.hifigan_trainer import HifiganTrainer
    from xva_trainer_tpu_torch.train.xvapitch_trainer import XVAPitchTrainer

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    root = os.path.join(work, "server")
    v3ds = os.path.join(root, "server_voice")
    os.makedirs(os.path.join(v3ds, "wavs"))
    with open(os.path.join(data_ds, "metadata.csv"), encoding="utf-8") as f:
        rows = [ln for ln in f.read().splitlines() if ln.strip()]
    rows = [r for i, r in enumerate(rows) if i % src_per_bucket < per_bucket]
    for r in rows:
        name = r.split("|")[0]
        shutil.copyfile(os.path.join(data_ds, "wavs", name), os.path.join(v3ds, "wavs", name))
    with open(os.path.join(v3ds, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("".join(r + "\n" for r in rows))
    v3out, v2out = os.path.join(root, "v3_out"), os.path.join(root, "v2_out")
    wavs = os.path.join(root, "wavs_out")
    os.makedirs(wavs)
    v3msg = {"dataset_path": v3ds, "output_path": v3out, "model_type": "xVAPitch",
             "lang": "en", "batch_size": batch, "target_bs": target_bs,
             "save_step": 1, "max_steps": 2}
    if base_ckpt:
        v3msg["checkpoint"] = base_ckpt
    if model_config:
        v3msg.update(model_config=model_config, use_amp=False)
    v2msg = {"dataset_path": v2_ds, "output_path": v2out, "model_type": "FastPitch1.1",
             "force_stage": 5, "batch_size": SERVER_V2_BATCH}
    if not on_card:
        v2msg["use_amp"] = "false"

    saves: list = []
    real_save = pck.CheckpointManager.save

    def save(self, step, state, host=None):  # each checkpoint's seconds and bytes
        path = real_save(self, step, state, host)
        saves.append(dict(self.last_save, prefix=self.prefix))
        return path

    http_port = free_port()
    ws_port = free_port()
    while ws_port == http_port:
        ws_port = free_port()
    old_cwd = os.getcwd()
    os.chdir(root)  # the server keeps its settings, queue file and log in its working directory
    pck.CheckpointManager.save = save
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    app = AppServer(http_port, ws_port, logger=make_logger(os.path.join(root, "server.log")),
                    device=str(dev))
    srv_errors: list = []

    def serve():
        try:
            asyncio.run(app.serve_with_http())
        except BaseException as e:  # noqa: BLE001 — reported by the phase
            srv_errors.append(repr(e))

    srv = threading.Thread(target=serve, name="server", daemon=True)
    client = None
    events: list = []
    # each v3 trainer's micro-steps, counted as they start and end (wrapped
    # as the session attaches the trainer, before its first step)
    steps = {"started": 0, "in_flight": 0}
    plain_attach = app.training._attach_trainer

    def attach(tr):
        if isinstance(tr, XVAPitchTrainer):
            steps.update(started=0, in_flight=0)
            for freeze, real in list(tr._steps.items()):
                def step(batch, gen, real=real):
                    steps["started"] += 1
                    steps["in_flight"] += 1
                    try:
                        return real(batch, gen)
                    finally:
                        steps["in_flight"] -= 1
                tr._steps[freeze] = step
        plain_attach(tr)

    app.training._attach_trainer = attach
    rec: dict = {"ports": [http_port, ws_port], "clips": len(rows), "gpu": smi}

    def http(path, body=None, want=200):
        status, out, sec = http_call(http_port, path, body)
        check(status == want, f"server: {path} {body} answered {status}: {str(out)[-2000:]}")
        return out, sec

    def wait(pred, timeout, what, job=True):
        end = time.perf_counter() + timeout
        while not pred():
            pending = [m for _, m in list(client.events.queue)] if client else []
            bad = [m for m in pending if '"TRAINING_ERROR"' in m or '"tasks_error"' in m]
            check(not bad and not srv_errors and (not job or app.training.running()),
                  f"server: while waiting for {what}: events {[m[-3000:] for m in bad]}, "
                  f"server {srv_errors}, job running {app.training.running()}")
            check(time.perf_counter() < end, f"server: {what} took over {timeout} s")
            time.sleep(0.05)

    def next_event(key, timeout):
        end = time.perf_counter() + timeout
        while True:
            try:
                t, msg = client.events.get(timeout=max(0.01, end - time.perf_counter()))
            except queue.Empty:
                raise AssertionError(f"server: no {key} event in {timeout} s; {events}") from None
            ev = json.loads(msg)
            events.append({"key": ev.get("key"), "data": str(ev.get("data"))[-3000:]})
            check(ev.get("key") not in ("TRAINING_ERROR", "tasks_error"),
                  f"server: {ev.get('key')} event: {str(ev.get('data'))[-3000:]}")
            if ev.get("key") == key:
                return t, ev

    try:
        t0 = time.perf_counter()
        srv.start()

        def up():
            try:
                return http_call(http_port, "/checkReady", timeout=5)[1] == {"ready": True}
            except OSError:
                return False

        wait(up, 60, "the server to answer", job=False)
        rec["start_seconds"] = time.perf_counter() - t0
        http("/setDevice", {"device": str(dev)})
        refused, _ = http("/setDevice", {"device": "tpu"}, want=500)
        check("tpu" in refused.get("error", "") and app.manager.device == str(dev),
              f"server: /setDevice tpu was not refused: {refused}, device {app.manager.device}")
        info, _ = http("/datasetInfo", {"path": v3ds})
        check(len(info["items"]) == len(rows) and all(i["exists"] for i in info["items"])
              and not info["duplicates"] and not info["untranscribed"],
              f"server: /datasetInfo {str(info)[:2000]}")
        client = WsClient(ws_port)
        client.start_reader()

        # ---- the server path: the counts are set to 0 just before it ----
        _cuda.reset_launch_counts()
        t_start = time.perf_counter()
        client.send_json(model="xvapitch", task="startTraining", data=v3msg)
        wait(app.training.running, 60, "the v3 job to start", job=False)
        wait(lambda: isinstance(app.training.trainer, XVAPitchTrainer)
             and app.training.trainer.micro_steps >= 1, 900, "the v3 job's first micro-step")
        v3 = app.training.trainer
        rec["v3_first_micro_step_s"] = time.perf_counter() - t_start
        n_params = (sum(p.numel() for p in v3.model.parameters()),
                    sum(p.numel() for p in v3.disc.parameters()))
        check(v3.device == dev and (model_config or n_params == FULL_PARAMS),
              f"server: the v3 trainer on {v3.device} with {n_params} parameters")
        # a start while training queues the item
        t_q = time.perf_counter()
        client.send_json(model="fastpitch1_1", task="startTraining", data=v2msg)
        t_info, ev = next_event("task_info", 60)
        check(ev["data"] == f"queued (2 total): {v2_ds}", f"server: the queue event {ev}")
        rec["task_info_latency_ms"] = (t_info - t_q) * 1e3
        # a warm pause holds the trainer still, then resume
        client.send_json(model="", task="pause", data={})
        wait(lambda: v3.paused, 30, "the pause")
        t_pause = time.perf_counter()
        # the micro-step in flight at the pause ends (and its update's
        # checkpoint, if any); then no micro-step starts
        wait(lambda: steps["in_flight"] == 0 and v3.micro_steps == steps["started"], 120,
             "the micro-step in flight at the pause")
        time.sleep(0.5)
        settle_s, s0 = time.perf_counter() - t_pause, steps["started"]
        m0 = v3.micro_steps
        time.sleep(3.0)
        m1 = v3.micro_steps
        q, _ = http("/queue")
        check(m0 == m1 and steps["started"] == s0 and q["paused"] and q["running"]
              and len(q["queue"]) == 2,
              f"server: paused at {m0} micro-steps, then {m1} ({steps}); /queue {q}")
        rec["pause"] = {"micro_steps": m0, "after_3_s": m1, "updates": v3.training_iters,
                        "settle_s": settle_s}
        client.send_json(model="", task="resume", data={})
        wait(lambda: not v3.paused, 30, "the resume")
        wait(lambda: app.training.queue_index >= 1, 1800, "the end of the v3 job")
        t_v3_end = time.perf_counter()
        v3_stages = list(app.training.stage_seconds)
        files = sorted(os.listdir(v3out))
        meta = json.load(open(os.path.join(v3out, "server_voice.json"), encoding="utf-8"))
        check(v3.training_iters == 2 and v3.micro_steps == 2 * v3.gam
              and [f for f in files if f.startswith("xVAPitch_")] == [
                  "xVAPitch_1.json", "xVAPitch_1.pt", "xVAPitch_2.json", "xVAPitch_2.pt"]
              and {"model_config.json", "graphs.json", "server_voice.pt"} <= set(files)
              and meta["modelType"] == "xVAPitch"
              and len(meta["games"][0]["base_speaker_emb"]) == 512
              and len(os.listdir(os.path.join(v3ds, "se_embs"))) == len(rows)
              and os.path.isdir(os.path.join(v3ds, "wavs_postprocessed")),
              f"server: the v3 job left {v3.training_iters} updates, {v3.micro_steps} "
              f"micro-steps (gam {v3.gam}), files {files}")
        rec["v3_job"] = {"seconds": t_v3_end - t_start, "stages": v3_stages,
                         "seed_seconds": v3.seed_seconds, "gam": v3.gam,
                         "micro_steps": v3.micro_steps, "frames_s": list(v3.meter.history),
                         "batches_an_epoch": len(v3.batcher)}

        # ---- the queue's v2 job: stop after its first HiFi-GAN epoch ----
        # its first epoch and that epoch's checkpoint done, the second under way
        wait(lambda: isinstance(app.training.trainer, HifiganTrainer)
             and app.training.trainer.epoch >= 1
             and app.training.trainer.total_iter > len(app.training.trainer.sampler), 900,
             "the v2 job's second HiFi-GAN epoch")
        hifi = app.training.trainer
        t_stop = time.perf_counter()
        epoch_at_stop, iters_at_stop = hifi.epoch, hifi.total_iter
        client.send_json(model="", task="stop", data={})
        wait(lambda: not http_call(http_port, "/queue")[1]["running"], 60,
             "/queue to say not running", job=False)
        t_not_running = time.perf_counter()
        check(app.training.workers_idle(timeout=600), "server: the v2 worker thread ran on")
        t_idle = time.perf_counter()
        after = dict(_cuda.LAUNCHES)
        time.sleep(2.0)
        check(dict(_cuda.LAUNCHES) == after,
              f"server: kernels launched after the worker ended: {after} → {_cuda.LAUNCHES}")
        v2_files = sorted(os.listdir(v2out)) + sorted("hifi/" + f for f in
                                                      os.listdir(os.path.join(v2out, "hifi")))
        rec["v2_job"] = {"seconds_to_first_epoch": t_stop - t_v3_end,
                         "stages": app.training.stage_seconds[len(v3_stages):],
                         "epoch_at_stop": epoch_at_stop, "iters_at_stop": iters_at_stop,
                         "epoch_after": hifi.epoch, "iters_after": hifi.total_iter,
                         "steps_an_epoch": len(hifi.sampler), "frames_s": list(hifi.meter.history),
                         "files": v2_files}
        rec["stop"] = {"queue_not_running_s": t_not_running - t_stop,
                       "worker_ended_s": t_idle - t_stop,
                       "the_thread_ran_on": hifi.total_iter > iters_at_stop or hifi.epoch > epoch_at_stop
                       or any(f.endswith(".hg.pt") for f in os.listdir(v2out))}
        del hifi

        # ---- the v3 job again: it resumes, updates once more and ends the queue ----
        n_stages = len(app.training.stage_seconds)
        t_resume = time.perf_counter()
        client.send_json(model="xvapitch", task="startTraining", data=dict(v3msg, max_steps=3))
        t_next, _ = next_event("tasks_next", 1800)
        v3b = app.training.trainer
        files = sorted(f for f in os.listdir(v3out) if f.startswith("xVAPitch_") and f.endswith(".pt"))
        check(isinstance(v3b, XVAPitchTrainer) and v3b is not v3 and v3b.training_iters == 3
              and files == ["xVAPitch_2.pt", "xVAPitch_3.pt"] and not app.training.running(),
              f"server: the resumed v3 job at {getattr(v3b, 'training_iters', None)} updates, "
              f"files {files}")
        rec["v3_resumed_job"] = {"seconds_to_tasks_next": t_next - t_resume,
                                 "stages": app.training.stage_seconds[n_stages:],
                                 "frames_s": list(v3b.meter.history)}
        rec["checkpoints"] = saves
        del v3
        t_stop_all = time.perf_counter()

        # ---- synthesis through the server ----
        emb = np.loadtxt(os.path.join(v3ds, "emb.txt"), delimiter=",").astype(np.float32)
        exports = {}
        for tag in ("cold", "warm"):
            body = {"xvap_ckpt": v3out, "out_path": os.path.join(wavs, f"dir_{tag}.wav"),
                    "text": TEXTS[0], "emb": emb.tolist(), "lang": "en"}
            out, sec = http("/exportWav", body)
            exports[f"dir_{tag}_s"] = sec
        v3b.model.eval()
        want = os.path.join(wavs, "dir_in_process.wav")
        serve_save(want, normalize_ebu_r128(synthesize_v3(v3b.model, TEXTS[0], emb, "en"), SR))
        _, a = wavfile.read(os.path.join(wavs, "dir_warm.wav"))
        _, b = wavfile.read(want)
        _, c = wavfile.read(os.path.join(wavs, "dir_cold.wav"))
        check(len(a) > 0 and len(a) % HOP == 0 and np.array_equal(a, b) and np.array_equal(a, c),
              f"server: /exportWav on the output directory ({len(a)} samples) differs from "
              f"synthesize_v3 on the trainer's model ({len(b)}): "
              f"{int(np.abs(a[:len(b)].astype(np.int64) - b[:len(a)]).max()) if len(a) and len(b) else None}")
        exports["dir_samples"] = int(len(a))
        del v3b
        pt = os.path.join(v3out, "server_voice.pt")
        pt_cfg = XVAPitchConfig(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in (model_config or {}).items()})
        http_pt, local_pt = [], []
        out, sec = http("/exportWav", {"xvap_ckpt": pt, "out_path": os.path.join(wavs, "pt_cold.wav"),
                                       "text": "Warm up."})
        exports["pt_cold_s"] = sec
        # each text over HTTP and in process, in turns, three rounds
        for r in range(3):
            for i, text in enumerate(TEXTS):
                body = {"xvap_ckpt": pt, "text": text, "lang": "en"}
                out, sec = http("/exportWav", dict(body, out_path=os.path.join(wavs, f"pt_{i}.wav")))
                sr_, pcm = wavfile.read(out["path"])
                check(sr_ == SR and len(pcm) > 0 and len(pcm) % HOP == 0 and np.abs(pcm).max() > 0,
                      f"server: /exportWav on the .pt wrote {len(pcm)} samples")
                http_pt.append({"text": i, "seconds": sec, "samples": int(len(pcm))})
                local = os.path.join(wavs, f"local_{i}.wav")
                t0 = time.perf_counter()
                export_wav(dict(body, out_path=local), cfg=pt_cfg, device=str(dev))
                sync()
                local_pt.append(time.perf_counter() - t0)
                check(open(out["path"], "rb").read() == open(local, "rb").read(),
                      f"server: /exportWav and export_wav differ on request {i}")
        adds = [(h["seconds"] - s) * 1e3 for h, s in zip(http_pt, local_pt)]
        exports.update(pt_warm=http_pt, in_process_s=local_pt, server_adds_ms=adds,
                       server_adds_ms_median=float(np.median(adds)),
                       phase5_in_process_s=[r["seconds"] for r in serve_requests])
        voice, sec = http("/exportVoice", {"dataset_path": v3ds, "training_dir": v3out,
                                           "out_dir": os.path.join(root, "voice_export")})
        vmeta = json.load(open(voice["json"], encoding="utf-8")) if voice.get("ok") else {}
        check(voice.get("ok") and os.path.getsize(voice["pt"]) == os.path.getsize(pt)
              and vmeta.get("modelType") == "xVAPitch" and "preview" in voice
              and os.path.getsize(voice["preview"]) > 44,
              f"server: /exportVoice {voice}")
        exports["export_voice_s"] = sec
        rec["exports"] = exports

        # ---- telemetry and the profiler ----
        usage, _ = http("/resourceUsage")
        check(usage["device"]["platform"] == ("cuda" if on_card else "uninitialized")
              and (usage["device"]["used_gb"] > 0 or not on_card),
              f"server: /resourceUsage {usage}")
        rec["resource_usage"] = usage
        trace_dir = os.path.join(root, "trace")
        started, _ = http("/profileStart", {"dir": trace_dir})
        _, sec = http("/exportWav", {"xvap_ckpt": pt, "text": TEXTS[1],
                                     "out_path": os.path.join(wavs, "profiled.wav")})
        stopped, _ = http("/profileStop")
        trace = trace_busy(trace_dir)
        kinds = trace["events"]
        check(started["ok"] and stopped["ok"] and trace["traces"] and kinds.get("cpu_op", 0) > 0
              and (kinds.get("kernel", 0) > 0 or not on_card),
              f"server: the profiler {started} {stopped}, {trace['traces']} traces, events {kinds}")
        rec["profiler"] = {"request_s": sec, "traces": trace["traces"], "events": kinds}

        # ---- /stopServer ----
        stop_reply, _ = http("/stopServer")
        srv.join(timeout=60)
        check(stop_reply == {"ok": True} and not srv.is_alive() and not srv_errors,
              f"server: /stopServer {stop_reply}, thread alive {srv.is_alive()}, {srv_errors}")
        launches = dict(_cuda.LAUNCHES)  # the end of the server path
        try:
            http_call(http_port, "/checkReady", timeout=5)
            still_up = True
        except OSError:
            still_up = False
        check(not still_up, "server: HTTP still answers after /stopServer")
        rec.update(events=events, launches=launches, path_seconds=t_stop_all - t_start,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card else None)
        return launches, rec
    finally:
        pck.CheckpointManager.save = real_save
        os.chdir(old_cwd)
        if srv.is_alive():  # a failed check: end the job and the server
            if client is not None:
                try:
                    client.send_json(model="", task="stop", data={})
                except OSError:
                    pass
            end = time.perf_counter() + 600
            while time.perf_counter() < end:  # a trainer that attaches after the stop too
                tr = app.training.trainer
                if tr is not None:
                    tr.paused, tr.stop_requested = False, True
                if app.training.workers_idle(timeout=1.0):
                    break
            try:
                http_call(http_port, "/stopServer", timeout=30)
            except OSError:
                pass
        if client is not None:
            client.close()


TOOLS_WAV44 = 64      # of the data cell's clips, rewritten as 44.1 kHz stereo wavs
TOOLS_FLAC = 32       # and as 22.05 kHz stereo FLAC
TOOLS_SRT_S = 600.0   # the srt_split recording
TOOLS_WEM = 16        # PCM .wem files (and 4 Vorbis ones where libvorbisenc is present)
TOOLS_DIAR_S = 180.0  # each diarization recording
TOOLS_CHECK = 16      # clips embedded on the card and on the CPU
# the DER harness's 3- and 5-speaker specs (tests/test_diarization_der.py
# THREE, and FOUR with 3 turns more), each recording: its spec, its length
# (0: the spec once), build_conversation's keywords, its DER bar (None:
# reported), the speakers it must find, and whether the CPU diarizes it too
# (for the DER between the card's turns and the CPU's). The "harness"
# recordings are the harness's own cases with its bars; the 3-minute ones
# repeat a spec. With a random-init encoder the 5-speaker spec repeated
# past one pass goes over the bar at most lengths, in the JAX package as in
# the port (its close pair, f0 112 and 95 Hz, merges), and the auto-k there
# turns on the last bits of the embeddings (scripts/der_by_length.py;
# PERF.md §6): that recording's DER is reported, its speakers held.
THREE = [(0, 3.0), (1, 2.5), (0, 2.0), (2, 3.5), (1, 3.0), (2, 2.0), (0, 2.5)]
FIVE = [(0, 3.0), (1, 2.5), (2, 3.0), (3, 2.5), (0, 2.0), (2, 2.5), (1, 3.0), (3, 2.0),
        (4, 3.0), (0, 2.0), (4, 2.5)]
DIAR_CASES = {
    "three": dict(spec=THREE, seconds=TOOLS_DIAR_S, kw={"seed": 7}, bar=0.25, speakers=(3, 3),
                  on_cpu=False),
    "five": dict(spec=FIVE, seconds=TOOLS_DIAR_S, kw={"seed": 9}, bar=None, speakers=(4, 5),
                 on_cpu=True),
    "three_harness": dict(spec=THREE, seconds=0, kw={"seed": 7, "rt60": 0.3, "snr_db": 15.0},
                          bar=0.25, speakers=(3, 3), on_cpu=True),
    "five_harness": dict(spec=FIVE, seconds=0, kw={"seed": 9}, bar=0.30, speakers=(4, 5),
                         on_cpu=True),
}


def _crc_table(poly: int, width: int) -> list:
    top, mask = 1 << (width - 1), (1 << width) - 1
    table = []
    for b in range(256):
        c = b << (width - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) & mask if c & top else (c << 1) & mask
        table.append(c)
    return table


FLAC_CRC8, FLAC_CRC16 = _crc_table(0x07, 8), _crc_table(0x8005, 16)


def flac_verbatim(pcm: np.ndarray, sr: int, block: int = 4096) -> bytes:
    """A FLAC stream of int16 ``pcm`` ((n,) or (n, channels)): STREAMINFO,
    then one frame a block of VERBATIM subframes (byte aligned at 16 bits,
    so numpy writes the samples), with real CRC-8 and CRC-16 sums. The
    pure-Python ``tests/flac_encoder.py`` writes such streams a bit at a
    time, too slow for a dataset."""
    pcm = pcm.reshape(len(pcm), -1).astype(">i2")
    n, ch = pcm.shape
    info = (struct.pack(">HH", block, block) + bytes(6)
            + ((sr << 44) | ((ch - 1) << 41) | (15 << 36) | n).to_bytes(8, "big") + bytes(16))
    out = bytearray(b"fLaC" + bytes([0x80]) + len(info).to_bytes(3, "big") + info)
    for fi, s in enumerate(range(0, n, block)):
        blk = pcm[s: s + block]
        if fi < 0x80:  # the frame number, UTF-8 coded
            num = bytes([fi])
        elif fi < 0x800:
            num = bytes([0xC0 | (fi >> 6), 0x80 | (fi & 0x3F)])
        else:
            num = bytes([0xE0 | (fi >> 12), 0x80 | ((fi >> 6) & 0x3F), 0x80 | (fi & 0x3F)])
        # sync, fixed blocking; the block size in 16 bits after the header,
        # the rate from STREAMINFO; independent channels, 16 bits a sample
        head = bytes([0xFF, 0xF8, 0x70, ((ch - 1) << 4) | 0x08]) + num + \
            struct.pack(">H", len(blk) - 1)
        c = 0
        for b in head:
            c = FLAC_CRC8[c ^ b]
        frame = head + bytes([c]) + b"".join(b"\x02" + blk[:, k].tobytes() for k in range(ch))
        c = 0
        for b in frame:
            c = ((c << 8) & 0xFFFF) ^ FLAC_CRC16[(c >> 8) ^ b]
        out += frame + struct.pack(">H", c)
    return bytes(out)


WEM_VARIANTS = ("pcm16", "extensible", "float", "pcm24", "pcm8", "rifx")


def pcm_wem(y: np.ndarray, sr: int, variant: str) -> bytes:
    """A Wwise PCM ``.wem`` (RIFF or RIFX WAVE with a vendor chunk) of mono
    float ``y``: 16-bit, WAVE_FORMAT_EXTENSIBLE, float, 24-bit, 8-bit, or
    big-endian 16-bit."""
    e = ">" if variant == "rifx" else "<"

    def q(bits):
        top = 2 ** (bits - 1)
        return np.clip(np.round(y * (top - 1)), -top, top - 1).astype(np.int64)

    if variant == "float":
        tag, bits, data = 3, 32, y.astype(e + "f4").tobytes()
    elif variant == "pcm24":
        v = q(24) & 0xFFFFFF
        tag, bits = 1, 24
        data = np.stack([v & 0xFF, (v >> 8) & 0xFF, v >> 16], 1).astype(np.uint8).tobytes()
    elif variant == "pcm8":
        tag, bits, data = 1, 8, (q(8) + 128).astype(np.uint8).tobytes()
    else:
        tag, bits, data = 1, 16, q(16).astype(e + "i2").tobytes()
    fmt = struct.pack(e + "HHIIHH", 0xFFFE if variant == "extensible" else tag, 1, sr,
                      sr * bits // 8, bits // 8, bits)
    if variant == "extensible":
        fmt += struct.pack(e + "HHI", 22, bits, 4) + struct.pack(e + "H", 1) + bytes(14)
    chunks = [(b"fmt ", fmt), (b"akd ", bytes(6)), (b"data", data)]
    body = b"WAVE" + b"".join(c + struct.pack(e + "I", len(d)) + d + bytes(len(d) & 1)
                              for c, d in chunks)
    return (b"RIFX" if e == ">" else b"RIFF") + struct.pack(e + "I", len(body)) + body


def http_raw(port: int, path: str, raw: bytes, timeout: float = 600.0):
    """POST raw bytes (a wav upload) to the server: (status, reply)."""
    import http.client

    conn = http.client.HTTPConnection("localhost", port, timeout=timeout)
    try:
        conn.request("POST", path, body=raw, headers={"Content-Type": "audio/wav"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def trace_busy(trace_dir: str) -> dict:
    """Over the Chrome traces in ``trace_dir``: their count, the kernel
    count, the union of the kernels' intervals (ms) and each event
    category's count."""
    kinds: dict = {}
    spans, traces = [], 0
    for d, _, fs in os.walk(trace_dir):
        for f in fs:
            if f.endswith(".json"):
                traces += 1
                with open(os.path.join(d, f), encoding="utf-8") as fh:
                    for e in json.load(fh).get("traceEvents", []):
                        kinds[e.get("cat")] = kinds.get(e.get("cat"), 0) + 1
                        if e.get("cat") == "kernel":
                            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"traces": traces, "kernels": len(spans), "busy_ms": busy / 1e3, "events": kinds}


def labels_turns(path: str) -> list:
    """The turns of an Audacity label file the diarization tool wrote."""
    turns = []
    with open(path, encoding="utf-8") as f:
        for ln in f.read().splitlines():
            a, b, who = ln.split("\t")
            turns.append({"start": float(a), "end": float(b), "speaker": int(who.split("_")[1])})
    return turns


def tools_phase(dev, smi: str, work: str, data_ds: str, n_wav44: int = TOOLS_WAV44,
                n_flac: int = TOOLS_FLAC, srt_s: float = TOOLS_SRT_S, n_wem: int = TOOLS_WEM,
                diar_s: float = TOOLS_DIAR_S, n_check: int = TOOLS_CHECK,
                profile_corpus: int = 64) -> tuple:
    """Phase 20, ``tools``: the 13 dataset tools of the port as the UI's
    tools panel drives them, each a ``runTask`` over the server's websocket
    (``serve_with_http`` on a thread, the server on ``dev``), on the
    ``data`` phase's dataset ``data_ds`` (256 clips, 1 153 s):

    1. set-up: a copy of the dataset with ``n_wav44`` clips as 44.1 kHz
       stereo wavs and ``n_flac`` as 22.05 kHz stereo FLAC; a recording of
       ``srt_s`` seconds of the clips with its ``.srt``; ``n_wem`` PCM
       ``.wem`` files and, where libvorbisenc is present, 4 Vorbis ones
       (inline and external codebooks, ``tests/torch_wem_fixture.py``);
       two diarization recordings of about ``diar_s`` seconds from the DER
       harness's generator (``tests/formant_speech.py``) and its 3- and
       5-speaker specs, and the harness's own two recordings of those specs
       (``DIAR_CASES``); a 256-line metadata pair; a noise profile;
    2. the tools path (launch counts set to 0 just before it): formatting,
       normalize, silence_cut, silence_split, cut_padding, noise_removal,
       srt_split, wem2ogg; cluster_speakers with ``numClusters`` 4
       (k-means) and 0 (affinity propagation); speaker_search (4 queries
       against the dataset); speaker_cluster_search over the k-means
       folders; diarization of the four recordings with Audacity labels
       (``numSpeakers`` unset: auto-k); wer_evaluation; then
       ``/uploadNoiseProfile`` and a ``/uploadRecording`` with
       ``record_noise_removal`` on;
    3. one more speaker_search (a query against ``profile_corpus`` clips)
       between ``/profileStart`` and ``/profileStop``;
    4. the checks: every tool ends in ``tasks_next``; each tool's outputs;
       the encoder on ``dev``; ``n_check`` clips' embeddings within 1e-3
       L1 of the CPU's (the same seeded weights), their k-means and
       affinity-propagation partitions equal; the search order the CPU's
       up to swaps of neighbours within the embedding error; DER against
       the truth within the harness's bars (reported for the 3-minute
       5-speaker recording) and the speakers found, and the DER between
       the card's turns and the CPU's; the recording equal to
       ``_denoise`` of the upload, sample for sample; the Vorbis ``.ogg``
       decoding to its packets' own PCM.

    Returns the path's launch counts and the record."""
    import asyncio

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from formant_speech import build_conversation

    from xva_trainer_tpu_torch import native
    from xva_trainer_tpu_torch.app.server import AppServer, make_logger
    from xva_trainer_tpu_torch.data.audio_io import load_wav, resample, save_wav
    from xva_trainer_tpu_torch.models.speaker_encoder import SpeakerEncoder
    from xva_trainer_tpu_torch.native import vorbis
    from xva_trainer_tpu_torch.ops import _cuda
    from xva_trainer_tpu_torch.tools.audio_tools import (NoiseRemovalTool, decode_wem_pcm,
                                                         format_srt)
    from xva_trainer_tpu_torch.tools.cluster import affinity_propagation, kmeans_labels
    from xva_trainer_tpu_torch.tools.der import der
    from xva_trainer_tpu_torch.tools.speaker_tools import diarize, embed_files, topk_similarity

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    root = os.path.join(work, "tools")
    rng = np.random.default_rng(40)
    rec: dict = {"gpu": smi}

    # ---- 1. set-up ----
    t0 = time.perf_counter()
    with open(os.path.join(data_ds, "metadata.csv"), encoding="utf-8") as f:
        rows = [ln.split("|", 1) for ln in f.read().splitlines() if ln.strip()]
    clips = os.path.join(root, "clips")
    os.makedirs(clips)
    flac_pcm, names, audio_s = {}, [], 0.0
    for i, (name, _) in enumerate(rows):
        sr, pcm = wavfile.read(os.path.join(data_ds, "wavs", name))
        y = pcm.astype(np.float32) / 32768.0
        audio_s += len(y) / sr
        stem = os.path.splitext(name)[0]
        other = 0.8 * np.roll(y, 37)  # a second channel
        if i < n_wav44:
            st = np.stack([resample(y, sr, 44100), resample(other, sr, 44100)], 1)
            wavfile.write(os.path.join(clips, stem + ".wav"), 44100,
                          (np.clip(st, -1, 1) * 32767).astype(np.int16))
            names.append(stem + ".wav")
        elif i < n_wav44 + n_flac:
            st = (np.clip(np.stack([y, other], 1), -1, 1) * 32767).astype(np.int16)
            with open(os.path.join(clips, stem + ".flac"), "wb") as f:
                f.write(flac_verbatim(st, sr))
            flac_pcm[stem] = st
            names.append(stem + ".flac")
        else:
            shutil.copyfile(os.path.join(data_ds, "wavs", name), os.path.join(clips, name))
            names.append(name)
    # the srt_split recording: clips of the three shorter buckets in a
    # seeded order, 0.4 s apart, one .srt entry each
    pieces, entries, srt_total = [], [], 0.0
    for i in rng.permutation(min(len(rows), 3 * len(rows) // 4)):
        if srt_total >= srt_s:
            break
        y, _ = load_wav(os.path.join(data_ds, "wavs", rows[i][0]))
        pieces += [y, np.zeros(int(0.4 * SR), np.float32)]
        entries.append({"start": srt_total, "end": srt_total + len(y) / SR, "text": rows[i][1]})
        srt_total += len(y) / SR + 0.4
    long_dir = os.path.join(root, "long")
    os.makedirs(long_dir)
    save_wav(os.path.join(long_dir, "recording.wav"), np.concatenate(pieces))
    with open(os.path.join(long_dir, "recording.srt"), "w", encoding="utf-8") as f:
        f.write(format_srt(entries))
    # .wem: PCM containers at 48 kHz, and Vorbis ones where libvorbisenc is present
    wems = os.path.join(root, "wems")
    os.makedirs(wems)
    wem_pcm = {}
    for i in range(n_wem):
        y, _ = load_wav(os.path.join(data_ds, "wavs", rows[i][0]), target_sr=48000)
        stem = f"line{i:02d}_{WEM_VARIANTS[i % len(WEM_VARIANTS)]}"
        with open(os.path.join(wems, stem + ".wem"), "wb") as f:
            f.write(pcm_wem(y, 48000, WEM_VARIANTS[i % len(WEM_VARIANTS)]))
        wem_pcm[stem] = y
    vorbis_found = vorbis.available()
    golden, codebooks = {}, None
    if vorbis_found:
        import torch_wem_fixture
        from xva_trainer_tpu_torch.tools.wwise_vorbis import OggPageWriter, write_packed_library

        books: list = []
        for i, variant in enumerate(("inline", "inline", "external", "external")):
            y, _ = load_wav(os.path.join(data_ds, "wavs", rows[n_wem + i][0]))
            headers, audio = vorbis.encode_ogg_packets(y, SR)
            kw = {"packed_books": books} if variant == "external" else {}
            with open(os.path.join(wems, f"vorbis{i}_{variant}.wem"), "wb") as f:
                f.write(torch_wem_fixture.build_wem(headers, audio, 1, SR, variant, **kw))
            w = OggPageWriter()  # the packets' own Ogg stream, whose decode the rebuild must give
            w.add_packet(headers[0], granule=0)
            w.flush(0)
            w.add_packet(headers[1])
            w.add_packet(headers[2])
            w.flush(0)
            for j, (pkt, gran) in enumerate(audio):
                w.add_packet(pkt, granule=gran, eos=j == len(audio) - 1)
                if j < len(audio) - 1:
                    w.maybe_flush(gran)
            gpath = os.path.join(root, f"golden{i}.ogg")
            with open(gpath, "wb") as f:
                f.write(w.to_bytes())
            golden[f"vorbis{i}_{variant}"] = vorbis.decode_ogg(gpath)
        codebooks = os.path.join(root, "game.pcb")
        write_packed_library(books, codebooks)
    # diarization: the DER harness's specs, repeated to about diar_s seconds
    diar = os.path.join(root, "diar")
    os.makedirs(diar)
    truth = {}
    for name, case in DIAR_CASES.items():
        one = sum(d for _, d in case["spec"]) + 0.35 * len(case["spec"])
        reps = max(1, round(min(case["seconds"], diar_s) / one))
        y, turns = build_conversation(case["spec"] * reps, with_breaths=True, **case["kw"])
        save_wav(os.path.join(diar, name + ".wav"), y)
        truth[name] = (y, turns)
    # wer_evaluation: the dataset's transcripts against a seeded "ASR" pass
    meta = os.path.join(root, "metadata.csv")
    shutil.copyfile(os.path.join(data_ds, "metadata.csv"), meta)
    asr = []
    for n, text in rows:
        words = text.split()
        for _ in range(int(rng.integers(0, 3))):
            words[int(rng.integers(len(words)))] = "uh" if rng.random() < 0.6 else ""
        asr.append(f"{os.path.splitext(n)[0]}|{' '.join(w for w in words if w)}")
    asr_csv = os.path.join(root, "asr_metadata.csv")
    with open(asr_csv, "w", encoding="utf-8") as f:
        f.write("\n".join(asr) + "\n")
    noise_path = os.path.join(root, "noise.wav")
    save_wav(noise_path, 0.02 * rng.standard_normal(SR).astype(np.float32))

    def wav_bytes(y, sr):
        import io

        buf = io.BytesIO()
        wavfile.write(buf, sr, (np.clip(y, -1, 1) * 32767).astype(np.int16))
        return buf.getvalue()

    mic = voiced_clip(rng, 3.0)
    mic_wav = wav_bytes(resample(mic + 0.02 * rng.standard_normal(len(mic)).astype(np.float32),
                                 SR, 44100), 44100)
    noise_wav = wav_bytes(0.02 * rng.standard_normal(44100).astype(np.float32), 44100)
    rec_ds = os.path.join(root, "mic_voice")
    os.makedirs(os.path.join(rec_ds, "wavs"))
    query = os.path.join(root, "query")
    os.makedirs(query)
    for n in names[-4:]:
        shutil.copyfile(os.path.join(clips, n), os.path.join(query, "q_" + n))
    prof_corpus = os.path.join(root, "prof_corpus")
    os.makedirs(prof_corpus)
    for n in names[:profile_corpus]:
        shutil.copyfile(os.path.join(clips, n), os.path.join(prof_corpus, n))
    rec.update(clips=len(names), clips_audio_s=audio_s, wav44=n_wav44, flac=n_flac,
               srt_entries=len(entries), srt_recording_s=srt_total, pcm_wem=n_wem,
               libvorbis="found" if vorbis_found else "not found",
               vorbis_wem=4 if vorbis_found else "not run: libvorbis not found",
               diarization_s={k: len(v[0]) / SR for k, v in truth.items()},
               setup_s=time.perf_counter() - t0)
    print(f"tools: libvorbis {rec['libvorbis']}", flush=True)

    # ---- the server ----
    http_port = free_port()
    ws_port = free_port()
    while ws_port == http_port:
        ws_port = free_port()
    old_cwd = os.getcwd()
    os.chdir(root)  # the settings, noise_profile.wav and the log live in the working directory
    app = AppServer(http_port, ws_port, logger=make_logger(os.path.join(root, "server.log")),
                    device=str(dev))
    srv_errors: list = []

    def serve():
        try:
            asyncio.run(app.serve_with_http())
        except BaseException as e:  # noqa: BLE001 — reported by the phase
            srv_errors.append(repr(e))

    srv = threading.Thread(target=serve, name="tools-server", daemon=True)
    client = None

    def http(path, body=None):
        status, out, _ = http_call(http_port, path, body)
        check(status == 200, f"tools: {path} answered {status}: {str(out)[-2000:]}")
        return out

    def run_tool(model, data, timeout=900):
        """One runTask; its seconds to tasks_next (a tasks_error fails) and
        the task_info messages before it."""
        t_send = time.perf_counter()
        client.send_json(model=model, task="runTask", data=data)
        info = []
        while True:
            try:
                _, msg = client.events.get(
                    timeout=max(0.01, t_send + timeout - time.perf_counter()))
            except queue.Empty:
                raise AssertionError(f"tools: no tasks_next from {model} in {timeout} s") from None
            ev = json.loads(msg)
            check(ev.get("key") != "tasks_error",
                  f"tools: {model} sent tasks_error: {str(ev.get('data'))[-3000:]}")
            if ev.get("key") == "tasks_next":
                return time.perf_counter() - t_send, info
            info.append(ev.get("data"))

    try:
        srv.start()
        end = time.perf_counter() + 60
        while True:
            try:
                if http_call(http_port, "/checkReady", timeout=5)[1] == {"ready": True}:
                    break
            except OSError:
                pass
            check(time.perf_counter() < end and not srv_errors, f"tools: no server {srv_errors}")
            time.sleep(0.05)
        http("/setDevice", {"device": str(dev)})
        client = WsClient(ws_port)
        client.start_reader()
        enc = app.manager.sync_init_model("speaker_encoder")  # the server's one encoder
        on_dev = {p.device.type for p in enc.model.parameters()}
        check(on_dev == {dev.type}, f"tools: the encoder's parameters on {on_dev}")
        emb = {"s": 0.0, "crops": 0, "calls": 0}
        plain_embed = enc.embed

        def timed_embed(crops):  # every embedding batch, timed on the tool's own thread
            sync()
            t1 = time.perf_counter()
            out = plain_embed(crops)  # ends in .cpu(): synchronised
            emb["s"] += time.perf_counter() - t1
            emb["crops"] += len(crops)
            emb["calls"] += 1
            return out

        enc.embed = timed_embed
        mem_start_gb = None
        if on_card:  # earlier phases' tensors still held count in the peak; the rise is the path's
            torch.cuda.reset_peak_memory_stats()
            mem_start_gb = torch.cuda.memory_allocated() / 1e9
        out = {k: os.path.join(root, "out_" + k) for k in (
            "formatting", "normalize", "silence_cut", "silence_split", "cut_padding",
            "noise_removal", "srt_split", "wem2ogg", "kmeans", "affinity", "ranked")}
        wem_req = {"inPath": wems, "outputDirectory": out["wem2ogg"], "toWav": True}
        if codebooks:
            wem_req["codebooksPath"] = codebooks
        requests = [
            ("formatting", "formatting", {"inPath": clips, "outputDirectory": out["formatting"],
                                          "toolSettings": {"useMP": False,
                                                           "formatting_hz": 22050}}),
            ("normalize", "normalize", {"inPath": clips, "outputDirectory": out["normalize"]}),
            ("silence_cut", "silence_cut", {"inPath": clips,
                                            "outputDirectory": out["silence_cut"]}),
            ("silence_split", "silence_split", {"inPath": clips,
                                                "outputDirectory": out["silence_split"]}),
            ("cut_padding", "cut_padding", {"inPath": clips,
                                            "outputDirectory": out["cut_padding"]}),
            ("noise_removal", "noise_removal", {"inPath": clips, "noiseProfile": noise_path,
                                                "outputDirectory": out["noise_removal"]}),
            ("srt_split", "srt_split", {"inPath": os.path.join(long_dir, "recording.wav"),
                                        "srtPath": os.path.join(long_dir, "recording.srt"),
                                        "outputDirectory": out["srt_split"]}),
            ("wem2ogg", "wem2ogg", wem_req),
            ("cluster_kmeans", "cluster_speakers", {"inPath": clips,
                                                    "outputDirectory": out["kmeans"],
                                                    "toolSettings": {"numClusters": 4}}),
            ("cluster_affinity", "cluster_speakers", {"inPath": clips,
                                                      "outputDirectory": out["affinity"],
                                                      "toolSettings": {"numClusters": 0}}),
            ("speaker_search", "speaker_search", {"queryPath": query, "corpusPath": clips,
                                                  "outputDirectory": out["ranked"]}),
            ("speaker_cluster_search", "speaker_cluster_search", {
                "queryPath": query, "corpusPath": out["kmeans"]}),
            ("diarization", "diarization", {"inPath": diar, "toolSettings": {
                "outputAudacityLabels": True}}),
            ("wer_evaluation", "wer_evaluation", {
                "userMetadata": meta, "asrMetadata": asr_csv,
                "outputFile": os.path.join(root, "wer_report.txt")}),
        ]

        # ---- 2. the tools path: the counts are set to 0 just before it ----
        _cuda.reset_launch_counts()
        t_path = time.perf_counter()
        tools: dict = {}
        for label, model, data in requests:
            e0 = dict(emb)
            sec, info = run_tool(model, data)
            tools[label] = {"seconds": sec, "embed_s": emb["s"] - e0["s"],
                            "embedded_crops": emb["crops"] - e0["crops"],
                            "embed_calls": emb["calls"] - e0["calls"]}
            if info:
                tools[label]["task_info"] = [str(m)[:300] for m in info]
        # a mic recording with noise removal on, uploaded as the UI sends it
        t1 = time.perf_counter()
        http("/appSettings", {"set": {"record_noise_removal": True,
                                      "noise_removal_strength": 0.3}})
        st_n, noise_reply = http_raw(http_port, "/uploadNoiseProfile", noise_wav)
        st_r, rec_reply = http_raw(http_port, "/uploadRecording?path=" + rec_ds
                                   + "&name=take1&text=a%20denoised%20line", mic_wav)
        check(st_n == st_r == 200 and rec_reply.get("ok") and noise_reply.get("ok"),
              f"tools: the uploads answered {st_n} {noise_reply}, {st_r} {rec_reply}")
        tools["upload_recording"] = {"seconds": time.perf_counter() - t1}
        path_s = time.perf_counter() - t_path
        launches = dict(_cuda.LAUNCHES)  # the end of the tools path
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
        check(launches == {k: 0 for k in _cuda.KERNELS},
              f"tools: the path launched a fused kernel: {launches}")

        # ---- 3. a profiled speaker_search ----
        trace_dir = os.path.join(root, "trace")
        started = http("/profileStart", {"dir": trace_dir})
        prof_s, _ = run_tool("speaker_search", {"queryPath": query, "corpusPath": prof_corpus,
                                                "outputDirectory": os.path.join(root, "ranked_p")})
        stopped = http("/profileStop")
        busy = trace_busy(trace_dir)
        check(started["ok"] and stopped["ok"] and busy["events"].get("cpu_op", 0) > 0
              and (busy["kernels"] > 0 or not on_card),
              f"tools: the profiler {started} {stopped}, trace {busy}")
        rec["profiled_speaker_search"] = dict(
            busy, seconds=prof_s, files=len(os.listdir(query)) + profile_corpus,
            host_share=1.0 - busy["busy_ms"] / (prof_s * 1e3))
        shutil.rmtree(trace_dir, ignore_errors=True)
    finally:
        enc_cuda = app.manager.models_bank.get("speaker_encoder")
        if enc_cuda is not None:
            enc_cuda.__dict__.pop("embed", None)  # back to the class's method
        os.chdir(old_cwd)
        if srv.is_alive():
            try:
                http_call(http_port, "/stopServer", timeout=30)
            except OSError:
                pass
            srv.join(timeout=60)
        if client is not None:
            client.close()
    check(not srv.is_alive() and not srv_errors, f"tools: the server {srv_errors}")

    # ---- 4. the checks ----
    n_in = len(names)
    # the audio tools: every input's output, FLAC decoded, 44.1 kHz resampled
    fmt = sorted(os.listdir(out["formatting"]))
    check(fmt == sorted([".progress.txt"] + [os.path.splitext(n)[0] + ".wav" for n in names]),
          f"tools: formatting wrote {len(fmt)} files for {n_in}")
    flac_err = 0.0
    for stem, st in flac_pcm.items():
        y, sr = native.decode_flac(os.path.join(clips, stem + ".flac"))
        flac_err = max(flac_err, float(np.abs(y - st.astype(np.float64).mean(1) / 32768).max()))
        sr_o, o = wavfile.read(os.path.join(out["formatting"], stem + ".wav"))
        check(sr == sr_o == SR and o.ndim == 1 and len(o) == len(st),
              f"tools: formatting of {stem}.flac: {sr_o} Hz, {o.shape}")
    check(flac_err < 1e-6, f"tools: the FLAC decode misses the PCM by {flac_err}")
    for stem in (os.path.splitext(n)[0] for n in names[:n_wav44]):
        sr_o, o = wavfile.read(os.path.join(out["formatting"], stem + ".wav"))
        n44 = len(wavfile.read(os.path.join(clips, stem + ".wav"))[1])
        check(sr_o == SR and o.ndim == 1 and len(o) == n44 // 2,
              f"tools: formatting of the 44.1 kHz {stem}: {sr_o} Hz, {o.shape}")
    counts = {}
    for k in ("normalize", "silence_cut", "cut_padding", "noise_removal"):
        got = [f for f in os.listdir(out[k]) if f != ".progress.txt"]
        counts[k] = len(got)
        check(sorted(got) == sorted(names), f"tools: {k} wrote {len(got)} of {n_in}")
    split = [f for f in os.listdir(out["silence_split"]) if f.endswith(".wav")]
    counts["silence_split"] = len(split)
    check(len(split) >= n_in // 2, f"tools: silence_split wrote {len(split)} pieces")
    with open(os.path.join(out["srt_split"], "metadata.csv"), encoding="utf-8") as f:
        srt_rows = f.read().splitlines()
    srt_wavs = os.listdir(os.path.join(out["srt_split"], "wavs"))
    counts["srt_split"] = len(srt_wavs)
    check(len(srt_rows) == len(srt_wavs) == sum(e["end"] - e["start"] >= 0.2 for e in entries),
          f"tools: srt_split {len(srt_rows)} lines, {len(srt_wavs)} wavs, {len(entries)} entries")
    # wem2ogg: the PCM containers' samples; the Vorbis rebuilds decode as their packets do
    wem_err = {}
    for stem, y in wem_pcm.items():
        sr_o, o = wavfile.read(os.path.join(out["wem2ogg"], stem + ".wav"))
        ref = decode_wem_pcm(os.path.join(wems, stem + ".wem"))
        variant = stem.split("_", 1)[1]
        err = float(np.abs(ref[0] - y).max())
        wem_err[variant] = max(wem_err.get(variant, 0.0), err)
        # within half a step of the container's sample width (8-bit: 1/128)
        check(sr_o == 48000 and err < (1 / 127 if variant == "pcm8" else 1e-4)
              and np.array_equal(o, (np.clip(ref[0], -1, 1) * 32767).astype(np.int16)),
              f"tools: wem2ogg of {stem}: decoded {err} from its samples")
    vorbis_rec = "not run: libvorbis not found"
    if vorbis_found:
        vorbis_rec = {}
        for stem, (gy, gsr) in golden.items():
            y, sr_v = vorbis.decode_ogg(os.path.join(out["wem2ogg"], stem + ".ogg"))
            check(sr_v == gsr == SR and np.array_equal(y, gy)
                  and os.path.exists(os.path.join(out["wem2ogg"], stem + ".wav")),
                  f"tools: the rebuilt {stem}.ogg decodes to other samples than its packets")
            vorbis_rec[stem] = len(y)
    rec["wem2ogg"] = {"pcm_wem": len(wem_pcm), "pcm_max_err_by_variant": wem_err,
                      "vorbis": vorbis_rec}
    # wer_evaluation: a line a clip, sorted by WER
    with open(os.path.join(root, "wer_report.txt"), encoding="utf-8") as f:
        report = f.read().splitlines()
    wers = [float(ln.split(" | ")[0]) for ln in report]
    check(len(report) == len(rows) and wers == sorted(wers, reverse=True),
          f"tools: the WER report has {len(report)} lines for {len(rows)}")
    rec["wer"] = {"lines": len(report), "mean": float(np.mean(wers)),
                  "event": tools["wer_evaluation"].get("task_info")}
    # the recording: the upload denoised against the saved profile, sample for sample
    _, prof_pcm = wavfile.read(os.path.join(root, "noise_profile.wav"))
    tool = NoiseRemovalTool(device="cpu")
    want = tool._denoise(AppServer._decode_mic_wav(mic_wav),
                         tool._profile(prof_pcm.astype(np.float32) / 32767.0), 0.3)
    _, stored = wavfile.read(os.path.join(rec_ds, "wavs", "take1.wav"))
    check(np.array_equal(stored, (np.clip(want, -1.0, 1.0) * 32767.0).astype(np.int16)),
          "tools: the stored recording is not _denoise of the upload")
    rec["recording"] = {"samples": len(stored), "seconds": rec_reply["seconds"]}

    # the speaker tools: the card against the CPU, the same seeded weights
    cpu_enc = SpeakerEncoder(seed=0, device="cpu")
    sd_cpu, sd_dev = cpu_enc.model.state_dict(), enc.model.state_dict()
    check(all(torch.equal(sd_cpu[k], sd_dev[k].cpu()) for k in sd_cpu)
          and cpu_enc.pretrained == enc.pretrained, "tools: the CPU encoder is not the card's")
    picks = [os.path.join(clips, n) for n in names[:: max(1, n_in // n_check)][:n_check]]
    t1 = time.perf_counter()
    e_dev = embed_files(picks, enc)
    sync()
    dev_ms = (time.perf_counter() - t1) * 1e3 / len(picks)
    t1 = time.perf_counter()
    e_cpu = embed_files(picks, cpu_enc)
    cpu_ms = (time.perf_counter() - t1) * 1e3 / len(picks)
    l1 = np.abs(e_dev - e_cpu).mean(axis=1)
    check(l1.max() < TOL, f"tools: embeddings on the card vs the CPU, L1 {l1.max()}")

    def parts(labels):
        return sorted(sorted(np.flatnonzero(labels == c).tolist()) for c in np.unique(labels))

    k = min(4, len(picks))
    same_km = parts(kmeans_labels(e_dev, k)) == parts(kmeans_labels(e_cpu, k))
    same_ap = np.array_equal(affinity_propagation(e_dev), affinity_propagation(e_cpu))
    check(same_km and same_ap, f"tools: partitions card vs CPU: k-means {same_km}, "
          f"affinity propagation {same_ap}")
    # the search order: the CPU's, up to swaps of neighbours closer than the error
    qd, qc = e_dev[:1], e_cpu[:1]
    od, sd = topk_similarity(qd, e_dev, k=len(picks), device=dev)
    oc, sc = topk_similarity(qc, e_cpu, k=len(picks))
    gap = float(np.abs(sd - sc).max()) * 2 + 1e-6
    swaps = [i for i in range(len(od)) if od[i] != oc[i]]
    check(all(abs(sc[od[i]] - sc[oc[i]]) <= gap for i in swaps),
          f"tools: the search order {od} vs the CPU's {oc} (scores {sd} {sc})")
    # the tool's ranked copies: all the corpus, each once
    ranked = sorted(os.listdir(out["ranked"]))
    ranked = [f for f in ranked if not f.startswith(".")]
    check(len(ranked) == n_in and {f[6:] for f in ranked} == set(names),
          f"tools: speaker_search copied {len(ranked)} of {n_in}")
    km_dirs = sorted(d for d in os.listdir(out["kmeans"])
                     if os.path.isdir(os.path.join(out["kmeans"], d)))
    ap_dirs = sorted(d for d in os.listdir(out["affinity"])
                     if os.path.isdir(os.path.join(out["affinity"], d)))
    with open(os.path.join(out["kmeans"], "cluster_search_results.txt"), encoding="utf-8") as f:
        cs = f.read().splitlines()
    check(len(km_dirs) == min(4, n_in) and sum(len(os.listdir(os.path.join(out["kmeans"], d)))
                                    for d in km_dirs) == n_in
          and ap_dirs and len(cs) == len(km_dirs),
          f"tools: clusters {km_dirs}, {len(ap_dirs)} affinity clusters, search report {cs}")
    rec["speaker"] = {"l1_max": float(l1.max()), "l1_mean": float(l1.mean()),
                      "encoder_ms_per_file_card": dev_ms, "encoder_ms_per_file_cpu": cpu_ms,
                      "kmeans_partition_equal": same_km, "affinity_labels_equal": same_ap,
                      "search_swaps": len(swaps), "kmeans_clusters": len(km_dirs),
                      "affinity_clusters": len(ap_dirs), "cluster_search": cs}
    # diarization: DER against the truth, and the card's turns against the CPU's
    diar_out = diar.rstrip("/") + "_diarized"
    d_rec = {}
    for name, case in DIAR_CASES.items():
        y, ref = truth[name]
        hyp = labels_turns(os.path.join(diar_out, name + "_labels.txt"))
        m = der(ref, hyp)
        found = len({t["speaker"] for t in hyp})
        d_rec[name] = {"der": m, "speakers": found, "turns": len(hyp), "true_turns": len(ref),
                       "true_speakers": len({s for s, _ in case["spec"]}),
                       "der_bar": case["bar"] or "reported (0.30 not held)"}
        if case["on_cpu"]:
            t1 = time.perf_counter()
            hyp_cpu = diarize(y, SR, cpu_enc)
            d_rec[name].update(cpu_seconds=time.perf_counter() - t1, der_vs_cpu=der(hyp_cpu, hyp),
                               der_cpu=der(ref, hyp_cpu),
                               cpu_speakers=len({t["speaker"] for t in hyp_cpu}))
        least, most = case["speakers"]
        check((case["bar"] is None or m["der"] <= case["bar"]) and least <= found <= most,
              f"tools: diarization of {name}: DER {m}, {found} speakers")
    audio_min = sum(len(v[0]) for v in truth.values()) / SR / 60
    dz = tools["diarization"]
    rec["diarization"] = dict(d_rec, audio_minutes=audio_min,
                              s_per_audio_minute=dz["seconds"] / audio_min,
                              embed_s_per_audio_minute=dz["embed_s"] / audio_min,
                              host_s_per_audio_minute=(dz["seconds"] - dz["embed_s"]) / audio_min)
    # the rates
    rate_of = {"formatting": n_in, "normalize": n_in, "silence_cut": n_in, "silence_split": n_in,
               "cut_padding": n_in, "noise_removal": n_in, "wem2ogg": len(os.listdir(wems)),
               "cluster_kmeans": n_in, "cluster_affinity": n_in,
               "speaker_search": n_in + len(os.listdir(query)), "wer_evaluation": len(rows)}
    for label, v in tools.items():
        if label in rate_of:
            v["files_per_s"] = rate_of[label] / v["seconds"]
        if label in ("cluster_kmeans", "cluster_affinity", "speaker_search"):
            v["encoder_ms_per_file"] = v["embed_s"] * 1e3 / rate_of[label]
    for label in ("formatting", "normalize", "silence_cut", "silence_split", "cut_padding",
                  "noise_removal"):
        tools[label]["audio_s_per_s"] = audio_s / tools[label]["seconds"]
    tools["srt_split"]["audio_s_per_s"] = srt_total / tools["srt_split"]["seconds"]
    tools["diarization"]["audio_s_per_s"] = audio_min * 60 / dz["seconds"]
    rec.update(tools=tools, counts=counts, path_seconds=path_s, launches=launches,
               peak_gb=peak_gb, allocated_at_start_gb=mem_start_gb,
               phase_seconds=time.perf_counter() - t_phase)
    return launches, rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from xva_trainer_tpu_torch.interop.convert import ups_to_reference
    from xva_trainer_tpu_torch.models.xvapitch import XVAPitchConfig
    from xva_trainer_tpu_torch.ops import _cuda
    from xva_trainer_tpu_torch.ops import fused_stft as fs
    from xva_trainer_tpu_torch.ops import mas
    from xva_trainer_tpu_torch.ops.features import featurize_batch
    from xva_trainer_tpu_torch.ops.stft import DEFAULT_MEL, LOSS_MEL, mel_basis
    from xva_trainer_tpu_torch.serve import (export_wav, load_xvapitch, synthesize_v3,
                                             text_tokens, voice_convert)

    dev = torch.device("cuda")
    smi = gpu_line()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 2. kernels ----
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_cuda.KERNELS)) as pool:  # one nvcc a source, all at once
        logs = dict(zip(_cuda.KERNELS, pool.map(_cuda.build, _cuda.KERNELS)))
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
    # hifigan_loss: the HiFi-GAN loss mel, the full band (its top filter ends
    # at the Nyquist bin)
    for name, y, center, eps, mcfg in (("tacotron", raw_d, True, 0.0, cfg),
                                       ("hifigan", raw_d, False, 1e-9, cfg),
                                       ("hifigan_loss", raw_d, False, 1e-9, LOSS_MEL),
                                       ("prepadded", bucket, None, 0.0, cfg),
                                       ("short", short, True, 0.0, cfg),
                                       ("nyquist", nyquist, True, 0.0, cfg),
                                       ("silence", silence, True, 0.0, cfg)):
        f64 = rfft_reference(y, mcfg, center, eps)
        for lin in (True, False):
            kw = dict(center=center, mag_eps=eps, return_linear=lin)
            out = fs.mel_spectrogram_fused(y, mcfg, **kw)
            ref = fs.mel_spectrogram_fused_reference(y, mcfg, **kw)
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
    fb_loss = mel_basis(LOSS_MEL, dev)
    mel_nnz = int((fb != 0).sum())
    n = cfg.n_fft

    def bound(B, T, F, linear=True, nnz=mel_nnz):
        flops = B * F * (n + 2.5 * n * np.log2(n) + 4 * cfg.n_freqs + 2 * nnz
                         + 2 * cfg.n_mels)
        nbytes = 4 * (B * T + B * F * (cfg.n_mels + (cfg.n_freqs if linear else 0)))
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

    def library_hifigan(y, basis):  # the same chain with HiFi-GAN's framing and eps
        pad = (cfg.n_fft - cfg.hop_length) // 2
        yp = torch.nn.functional.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
        spec = torch.stft(yp, cfg.n_fft, cfg.hop_length, window=window, center=False,
                          return_complex=True)
        mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
        return torch.log(torch.clamp(basis @ mag, min=cfg.clip_val))

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
    # the train step's own shapes: materialize_spec's linear spectrogram of a
    # 64 x 768-frame bucket's audio, and the mel loss's real side on the
    # 64 segments of 32 frames (mel only); both center=True, 2 launches a
    # step. The HiFi-GAN step's: its input mel (MelConfig()) and the real
    # side of its loss mel (LOSS_MEL) on 16 segments of 8 192 samples, mel
    # only, center=False, 1 launch each a step. At each, the kernel is held
    # to its plain version as in the cases above
    step_shapes = {}
    for key, Bs, Ts, lin, mcfg in (("materialize_spec", 64, 768 * HOP, True, cfg),
                                   ("mel_loss_real", 64, 32 * HOP, False, cfg),
                                   ("gan_mel_in", 16, 8192, False, cfg),
                                   ("gan_loss_mel_real", 16, 8192, False, LOSS_MEL)):
        y = torch.from_numpy(np.random.default_rng(4).uniform(-0.5, 0.5, (Bs, Ts))
                             .astype(np.float32)).to(dev)
        gan = key.startswith("gan_")
        kw = dict(center=False, mag_eps=1e-9) if gan else dict(center=True)
        # the kernel against its plain version at the step's own shape
        out = fs.mel_spectrogram_fused(y, mcfg, return_linear=lin, **kw)
        ref = fs.mel_spectrogram_fused_reference(y, mcfg, return_linear=lin, **kw)
        torch.cuda.synchronize()
        errs = {}
        for part, o, r in zip(("mel", "linear"), *((out, ref) if lin else ([out], [ref]))):
            d = (o - r).abs()
            errs[part] = {"mean_abs_err": d.mean().item(), "max_abs_err": d.max().item()}
            check(errs[part]["mean_abs_err"] < TOL and errs[part]["max_abs_err"] < TOL
                  and bool(torch.isfinite(o).all()) and o.shape == r.shape,
                  f"fused_stft at the step shape {key} ({Bs}, {Ts}) {kw} {part}: {errs[part]}")
        max_err = max([max_err] + [e["max_abs_err"] for e in errs.values()])
        mean_err = max([mean_err] + [e["mean_abs_err"] for e in errs.values()])
        calls = {"ms": functools.partial(fs.mel_spectrogram_fused, y, mcfg, return_linear=lin,
                                         **kw),
                 "plain_ms": functools.partial(fs.mel_spectrogram_fused_reference, y, mcfg,
                                               return_linear=lin, **kw),
                 "library_ms": (functools.partial(library_hifigan, y,
                                                  fb_loss if mcfg is LOSS_MEL else fb)
                                if gan else functools.partial(library, y, True))}
        runs = {key2: [] for k in calls for key2 in (k, k.replace("ms", "device_ms"))}
        for order in (list(calls), list(calls)[::-1]):
            for k in order:
                runs[k].append(cuda_ms(calls[k], flush=flush))
                runs[k.replace("ms", "device_ms")].append(device_ms(calls[k], flush))
        Fs = 1 + (Ts - cfg.hop_length) // cfg.hop_length if gan else 1 + Ts // cfg.hop_length
        nnz = int((mel_basis(mcfg, dev) != 0).sum())
        _, s_bytes, s_bound_ms, s_bound_by = bound(Bs, Ts, Fs, linear=lin, nnz=nnz)
        t = {k: sum(v) / len(v) for k, v in runs.items()}
        t.update(shape=[Bs, Ts], frames=Fs, linear=lin, errors=errs, mbytes=s_bytes / 1e6,
                 mel_config="LOSS_MEL (fmax None)" if mcfg is LOSS_MEL else "MelConfig()",
                 bound_ms=s_bound_ms, bound_by=s_bound_by,
                 bound_share_of_device_ms=s_bound_ms / t["device_ms"], runs=runs)
        step_shapes[key] = t
    emit("fused_stft", bucket=[B, T], frames=F, cases=cases, max_abs_err=max_err,
         mean_abs_err=mean_err, timing=timing, library="torch.stft + abs + mel matmul + log",
         gflop=flops / 1e9, mel_nnz=mel_nnz, mbytes=nbytes / 1e6, bound_ms=bound_ms,
         bound_by=bound_by, kernel_gflop=kernel_flops / 1e9,
         kernel_ops_ms=kernel_flops / H100_FP32_FLOPS * 1e3, train_step_shapes=step_shapes,
         gpu=smi)

    # ---- 8. mas: the kernel against its plain version, paths identical ----
    mas_cases, mas_mismatch = [], 0
    for name in MAS_CASES:
        for value_dtype, mask_dtype in MAS_PAIRS:
            value, mask = mas_case(name, dev, value_dtype, mask_dtype)
            path = mas.maximum_path(value, mask)
            ref = mas.maximum_path_reference(value, mask)
            torch.cuda.synchronize()
            bad = int((path != ref).sum())
            _, y_len = mas.mask_lengths(mask)
            per_frame = bool(torch.equal((path != 0).sum(dim=(1, 2)).long(), y_len.long()))
            mas_mismatch += bad
            mas_cases.append({"case": name, "shape": list(value.shape),
                              "dtype": str(value.dtype), "mask_dtype": str(mask.dtype),
                              "mismatches": bad, "every_frame_on_path": per_frame})
            check(bad == 0 and (per_frame or name not in MAS_ONE_PER_FRAME)
                  and path.dtype == value.dtype,
                  f"mas {name} {value.dtype}/{mask.dtype}: {bad} path entries differ from the "
                  f"plain version, one entry a frame: {per_frame}")
    value, mask = mas_case("trainer", dev)
    mB, mtx, mty = value.shape
    trainer_bound = mas_bound(value, mask)
    mas_t = {"ms": [], "device_ms": [], "plain_ms": []}
    kernel_call = functools.partial(mas.maximum_path, value, mask)
    plain_call = functools.partial(mas.maximum_path_reference, value, mask)
    for order in ((kernel_call, plain_call), (plain_call, kernel_call)):
        for fn in order:
            if fn is kernel_call:
                mas_t["ms"].append(cuda_ms(fn, flush=flush))
                mas_t["device_ms"].append(device_ms(fn, flush))
            else:  # some 10 000 small launches a call: a few calls suffice
                mas_t["plain_ms"].append(cuda_ms(fn, iters=3, flush=flush))
    mas_timing = {k: sum(v) / len(v) for k, v in mas_t.items()}
    # the kernel at each v3 bucket (the plain version at the largest only)
    mas_buckets = []
    for i, (bB, btx, bty, prev) in enumerate(MAS_BUCKETS):
        value, mask = mas_bucket(bB, btx, bty, prev, dev, seed=20 + i)
        runs = {"ms": [], "device_ms": []}
        call = functools.partial(mas.maximum_path, value, mask)
        for _ in range(2):
            runs["ms"].append(cuda_ms(call, flush=flush))
            runs["device_ms"].append(device_ms(call, flush))
        if i == len(MAS_BUCKETS) - 1:
            runs["plain_ms"] = [cuda_ms(functools.partial(mas.maximum_path_reference, value,
                                                          mask), iters=3, flush=flush)]
        rec = {"bucket": [bB, btx, bty], **{k: sum(v) / len(v) for k, v in runs.items()},
               **mas_bound(value, mask), "runs": runs}
        rec["bound_share_of_device_ms"] = rec["bound_ms"] / rec["device_ms"]
        rec["full_bytes_bound_share_of_device_ms"] = rec["full_bytes_bound_ms"] / rec["device_ms"]
        mas_buckets.append(rec)
    # the kernel at each v2 bucket at FastPitch's stage-1 batch, bf16 values
    # (JAX's AMP gives the aligner's soft attention in bf16; torch's autocast
    # keeps it fp32) and an fp32 mask
    mas_v2 = []
    for i, (bB, btx, bty, prev) in enumerate(MAS_V2_BUCKETS):
        value, mask = mas_bucket(bB, btx, bty, prev, dev, seed=40 + i)
        value = value.bfloat16()
        runs = {"ms": [], "device_ms": []}
        call = functools.partial(mas.maximum_path, value, mask)
        for _ in range(2):
            runs["ms"].append(cuda_ms(call, flush=flush))
            runs["device_ms"].append(device_ms(call, flush))
        rec = {"bucket": [bB, btx, bty], "dtype": "bfloat16",
               **{k: sum(v) / len(v) for k, v in runs.items()}, **mas_bound(value, mask),
               "runs": runs}
        rec["bound_share_of_device_ms"] = rec["bound_ms"] / rec["device_ms"]
        mas_v2.append(rec)
    emit("mas", cases=mas_cases, mismatches=mas_mismatch, trainer_shape=[mB, mtx, mty],
         timing=mas_timing, runs=mas_t, **trainer_bound,
         bound_share_of_device_ms=trainer_bound["bound_ms"] / mas_timing["device_ms"],
         buckets=mas_buckets, v2_buckets=mas_v2, library="none: no PyTorch call computes MAS",
         gpu=smi)

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
    # the xVASynth export format: a flat reference-named fp16 state dict, with
    # the decoder's ``ups`` weight-normed per input channel as the reference
    # trainer writes them (``load_xvapitch`` converts them back)
    ref_sd = ups_to_reference(seeded_model(cfg_m, 0).state_dict())
    ups_g = [v.shape for k, v in ref_sd.items() if ".ups." in k and k.endswith("weight_g")]
    check(bool(ups_g) and all(s[1] == 1 and s[0] > 1 for s in ups_g),
          f"synthesize: the checkpoint's ups weight_g are not in the reference layout: {ups_g}")
    torch.save({k: v.half() for k, v in ref_sd.items()}, ckpt)
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
    del model, model_cpu

    # phase 5's reference-layout .pt stays for the loop's warm start; the data
    # phase's dataset, cache and embeddings for the loop
    data_work = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        data_launches, data, data_ctx = data_phase(cfg_m, dev, smi, data_work)
        loop_launches, loop = train_loop_phase(cfg_m, dev, smi, data_ctx, ckpt, data_work)
        ml_launches, _ = multilingual_phase(cfg_m, dev, smi, data_ctx, ckpt, data_work)
        fp_launches, fp_record, _ = fastpitch_phase(
            dev, smi, data_work, os.path.join(data_ctx["dataset"], "wavs"))
        hg_launches, hg_record = hifigan_phase(dev, smi, data_work,
                                               os.path.join(data_work, "v2_voice"))
        emit("hifigan", **hg_record)
        # the task server, on the data phase's clips and the hifigan phase's
        # copy of the v2 dataset (its v2 cache built)
        srv_launches, srv_record = server_phase(dev, smi, data_work, data_ctx["dataset"], ckpt,
                                                os.path.join(data_work, "pipe_voice"), requests)
        emit("server", **srv_record)
        # the dataset tools over the server's websocket, on the data phase's clips
        tools_launches, tools_record = tools_phase(dev, smi, data_work, data_ctx["dataset"])
        emit("tools", **tools_record)
        # the least time for the v2 build's launches (mel only): each group's
        # bound, summed
        fp_build = fp_record["cache_build"]
        fp_build["fused_stft_bound_ms"] = sum(
            bound(gB, gT, 1 + (gT - n) // cfg.hop_length, linear=False)[2]
            for gB, gT in fp_build["group_shapes"])
        emit("fastpitch", **fp_record)
    finally:
        shutil.rmtree(data_work, ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)
    build = data["cache_build"]
    # the least time for the build's 32 launches: each group's bound, summed
    build["fused_stft_bound_ms"] = sum(bound(gB, gT, 1 + (gT - n) // cfg.hop_length)[2]
                                       for gB, gT in build["group_shapes"])
    # each build's shapes timed alone: the kernel, its plain version and the
    # torch.stft chain at each slot length (8 clips, pre-padded; linear on in
    # the v3 build, mel only in the v2 build), each summed over the groups of
    # that length
    def by_slot(group_shapes, linear):
        out = []
        for T in sorted({gT for _, gT in group_shapes}):
            gB = max(b for b, t in group_shapes if t == T)
            count = sum(1 for _, t in group_shapes if t == T)
            y = torch.from_numpy(np.random.default_rng(T).uniform(-0.5, 0.5, (gB, T))
                                 .astype(np.float32)).to(dev)
            calls = {"ms": functools.partial(fs.mel_spectrogram_fused, y, cfg, center=None,
                                             return_linear=linear),
                     "plain_ms": functools.partial(fs.mel_spectrogram_fused_reference, y, cfg,
                                                   center=None, return_linear=linear),
                     "library_ms": functools.partial(library, y, False)}
            runs = {k2: [] for k in calls for k2 in (k, k.replace("ms", "device_ms"))}
            for order in (list(calls), list(calls)[::-1]):
                for k in order:
                    runs[k].append(cuda_ms(calls[k], iters=10, flush=flush))
                    runs[k.replace("ms", "device_ms")].append(device_ms(calls[k], flush,
                                                                        iters=10))
            t = {k: sum(v) / len(v) for k, v in runs.items()}
            t.update(shape=[gB, T], groups=count,
                     bound_ms=bound(gB, T, 1 + (T - n) // cfg.hop_length, linear=linear)[2])
            out.append(t)
        return out

    build_shapes = by_slot(build["group_shapes"], True)
    build["by_slot"] = build_shapes
    for key in ("ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
                "library_device_ms", "bound_ms"):
        build[f"fused_stft_32_{key}"] = sum(t[key] * t["groups"] for t in build_shapes)
    v2_shapes = by_slot(fp_build["group_shapes"], False)
    for key in ("ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
                "library_device_ms", "bound_ms"):
        fp_build[f"fused_stft_all_{key}"] = sum(t[key] * t["groups"] for t in v2_shapes)
    emit("cache_build_shapes", by_slot=build_shapes,
         sums={k: v for k, v in build.items() if k.startswith("fused_stft_32_")},
         v2_by_slot=v2_shapes,
         v2_sums={k: v for k, v in fp_build.items() if k.startswith("fused_stft_all_")},
         gpu=smi)
    train_launches, train = train_phases(cfg_m, dev)
    by_path = {"serve": launches, "data": data_launches, "loop": loop_launches,
               "multilingual": ml_launches, "fastpitch": fp_launches, "hifigan": hg_launches,
               "server": srv_launches, "tools": tools_launches, "train": train_launches}

    kernels = [{
        "name": "fused_stft", "route": "cuda",
        "source": "xva_trainer_tpu_torch/csrc/fused_stft.cu",
        "replaces": "xva_trainer_tpu/ops/pallas_stft.py:127",
        "launches": data_launches["fused_stft"], "max_abs_err": max_err, "ms": tb["ms"],
        "plain_ms": tb["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": tb["library_ms"], "device_ms": tb["device_ms"],
        "plain_device_ms": tb["plain_device_ms"], "library_device_ms": tb["library_device_ms"],
        "launches_by_path": {p: c["fused_stft"] for p, c in by_path.items()},
        "launches_per_train_step": train_launches["fused_stft"] / train["timed_steps"],
        "launches_per_hifigan_step": hg_record["launches_per_step"]["fused_stft"],
        "v2_cache_build": {k: fp_build[k] for k in ("fused_stft_launches", "groups",
                                                    "fused_stft_device_ms",
                                                    "fused_stft_bound_ms", "seconds",
                                                    "fused_stft_all_ms",
                                                    "fused_stft_all_device_ms",
                                                    "fused_stft_all_plain_ms",
                                                    "fused_stft_all_plain_device_ms",
                                                    "fused_stft_all_library_ms",
                                                    "fused_stft_all_library_device_ms")},
        "cache_build": {k: build[k] for k in ("fused_stft_launches", "featurize_groups",
                                              "fused_stft_device_ms", "fused_stft_bound_ms",
                                              "seconds", "fused_stft_32_ms",
                                              "fused_stft_32_device_ms", "fused_stft_32_plain_ms",
                                              "fused_stft_32_plain_device_ms",
                                              "fused_stft_32_library_ms",
                                              "fused_stft_32_library_device_ms")},
        "train_step_shapes": {k: {m: v[m] for m in ("shape", "linear", "ms", "device_ms",
                                                    "plain_ms", "plain_device_ms",
                                                    "library_ms", "library_device_ms",
                                                    "bound_ms", "bound_by", "errors")}
                              for k, v in step_shapes.items()},
    }, {
        "name": "mas", "route": "cuda", "source": "xva_trainer_tpu_torch/csrc/mas.cu",
        "replaces": "xva_trainer_tpu/ops/mas.py:30",  # lax.scan code, not Pallas
        "launches": data_launches["mas"], "max_abs_err": 0.0, "path_mismatches": mas_mismatch,
        "ms": mas_timing["ms"], "plain_ms": mas_timing["plain_ms"],
        "bound_ms": trainer_bound["bound_ms"], "bound_by": trainer_bound["bound_by"],
        "library_ms": None, "device_ms": mas_timing["device_ms"],
        "bytes_bound_ms": trainer_bound["bytes_bound_ms"],
        "full_bytes_bound_ms": trainer_bound["full_bytes_bound_ms"],
        "chain_bound_ms": trainer_bound["chain_bound_ms"],
        "buckets": [{k: b[k] for k in ("bucket", "ms", "device_ms", "bound_ms", "bound_by",
                                       "full_bytes_bound_ms", "bound_share_of_device_ms")}
                    for b in mas_buckets],
        "v2_buckets": [{k: b[k] for k in ("bucket", "dtype", "ms", "device_ms", "bound_ms",
                                          "bound_by", "bound_share_of_device_ms")}
                       for b in mas_v2],
        "launches_by_path": {p: c["mas"] for p, c in by_path.items()},
        "launches_per_train_step": train_launches["mas"] / train["timed_steps"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    # each path's kernels: fused_stft on all, mas on the training steps, every step
    missing = [p + ":" + k for p, ks in (("serve", ["fused_stft"]),
                                         ("data", ["fused_stft", "mas"]),
                                         ("loop", ["fused_stft", "mas"]),
                                         ("multilingual", ["fused_stft", "mas"]),
                                         ("fastpitch", ["fused_stft", "mas"]),
                                         ("hifigan", ["fused_stft"]),
                                         ("server", ["fused_stft", "mas"]),
                                         ("train", ["fused_stft", "mas"]))
               for k in ks if by_path[p][k] < 1]
    check(not missing, f"a main path launched no {missing}")
    check(all(train_launches[k] >= train["timed_steps"] for k in ("fused_stft", "mas")),
          f"not every training step launched both kernels: {train_launches}")
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
