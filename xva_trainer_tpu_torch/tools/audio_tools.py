"""Audio data-prep tools: format, normalize, silence ops, padding, noise
removal, srt split, wem2ogg (reference python/{audio_format,audio_norm,
silence_cut,silence_split,cut_padding,noise_removal,srt_split,wem2ogg}/
model.py).

Counterpart of ``xva_trainer_tpu/tools/audio_tools.py``: host numpy and
scipy DSP, fanned over ``BaseTool.run_items``' threads. Wavs are read with
scipy (``data/audio_io.py``), FLAC with the port's host decoder
(``native/``), Ogg Vorbis with the system libvorbis (``native/vorbis.py``)
and Vorbis ``.wem`` through ``tools/wwise_vorbis.py``; ffmpeg is used only
as a fallback for other containers, where it is installed.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.audio_io import load_wav, resample, save_wav, trim_silence_db
from ..ops.loudness import normalize_ebu_r128
from .base import BaseTool

TARGET_SR = 22050


def _ffmpeg() -> Optional[str]:
    return shutil.which("ffmpeg")


def decode_any(path: str, target_sr: int = TARGET_SR) -> Tuple[np.ndarray, int]:
    """Decode wav/flac natively; other containers via ffmpeg when available."""
    if path.lower().endswith(".wav"):
        return load_wav(path, target_sr=target_sr)
    if path.lower().endswith(".flac"):
        from .. import native

        d = native.decode_flac(path)
        if d is not None:
            y, sr = d
            if target_sr and sr != target_sr:
                y, sr = resample(y, sr, target_sr), target_sr
            return y, sr
        # fall through to ffmpeg for a stream the decoder rejects
    if path.lower().endswith((".ogg", ".oga")):
        from ..native.vorbis import decode_ogg

        try:
            d = decode_ogg(path)
        except ValueError:
            d = None  # Opus/FLAC-in-Ogg or corrupt stream → try ffmpeg
        if d is not None:
            y, sr = d
            if target_sr and sr != target_sr:
                y, sr = resample(y, sr, target_sr), target_sr
            return y, sr
        # no system libvorbis / non-Vorbis ogg → ffmpeg fallback below
    if path.lower().endswith(".wem"):
        d = decode_wem_pcm(path)
        if d is None:
            from ..native.vorbis import decode_ogg as _dec
            from .wwise_vorbis import WemParseError, wem_to_ogg

            import tempfile

            try:
                with tempfile.NamedTemporaryFile(suffix=".ogg") as tf:
                    tf.write(wem_to_ogg(path))
                    tf.flush()
                    d = _dec(tf.name)
            except (WemParseError, ValueError):
                d = None  # ADPCM/other codec → try ffmpeg below
        if d is not None:
            y, sr = d
            if target_sr and sr != target_sr:
                y, sr = resample(y, sr, target_sr), target_sr
            return y, sr
    ff = _ffmpeg()
    if not ff:
        raise RuntimeError(
            f"cannot decode {os.path.splitext(path)[1]} without ffmpeg; "
            "convert to wav first"
        )
    out = subprocess.run(
        [ff, "-i", path, "-f", "f32le", "-ac", "1", "-ar", str(target_sr), "-"],
        capture_output=True, check=True,
    )
    return np.frombuffer(out.stdout, np.float32).copy(), target_sr


def list_audio_files(in_path: str) -> List[str]:
    exts = (".wav", ".mp3", ".ogg", ".flac", ".m4a", ".opus")
    if os.path.isfile(in_path):
        return [in_path]
    return sorted(
        os.path.join(in_path, f)
        for f in os.listdir(in_path)
        if f.lower().endswith(exts)
    )


class AudioFormatTool(BaseTool):
    """'formatting': resample to 22050 Hz mono 16-bit wav
    (reference python/audio_format/model.py:49-118)."""

    async def run(self, data: Dict, websocket=None):
        in_path = data.get("inPath") or data["inputDirectory"]
        out_dir = data.get("outputDirectory") or os.path.dirname(in_path)
        os.makedirs(out_dir, exist_ok=True)
        files = list_audio_files(in_path)

        def work(f):
            y, _ = decode_any(f, TARGET_SR)
            stem = os.path.splitext(os.path.basename(f))[0]
            save_wav(os.path.join(out_dir, stem + ".wav"), y, TARGET_SR)
            return stem

        await self.run_items(files, work, websocket, out_dir)
        await self.done(websocket)


class AudioNormalizeTool(BaseTool):
    """'normalize': EBU R128 loudness normalization, -23 LUFS / TP -2 dB mono
    (reference python/audio_norm/model.py:12-51)."""

    async def run(self, data: Dict, websocket=None):
        in_path = data.get("inPath") or data["inputDirectory"]
        out_dir = data.get("outputDirectory") or os.path.dirname(in_path)
        os.makedirs(out_dir, exist_ok=True)
        files = list_audio_files(in_path)

        def work(f):
            y, sr = decode_any(f, TARGET_SR)
            out = normalize_ebu_r128(y, sr)
            save_wav(os.path.join(out_dir, os.path.basename(f)), out, sr)

        await self.run_items(files, work, websocket, out_dir)
        await self.done(websocket)

    def normalize_sync(self, in_path: str, out_path: str) -> str:
        """Synchronous path used by trainer preprocessing and /exportWav
        (reference normalize_sync :80-113)."""
        y, sr = decode_any(in_path, TARGET_SR)
        save_wav(out_path, normalize_ebu_r128(y, sr), sr)
        return out_path


def _frame_dbfs(y: np.ndarray, frame: int, hop: int) -> np.ndarray:
    n = max(1, 1 + (len(y) - frame) // hop)
    idx = np.arange(n)[:, None] * hop + np.arange(frame)[None, :]
    idx = np.minimum(idx, len(y) - 1)
    rms = np.sqrt((y[idx] ** 2).mean(axis=1) + 1e-12)
    return 20.0 * np.log10(rms + 1e-12)


def find_silences(
    y: np.ndarray, sr: int, threshold_db: float = -40.0, min_s: float = 0.3,
    frame_ms: float = 20.0,
) -> List[Tuple[int, int]]:
    """(start, end) sample ranges of silence ≥ min_s below threshold."""
    frame = int(sr * frame_ms / 1000)
    db = _frame_dbfs(y, frame, frame)
    silent = db < threshold_db
    out = []
    start = None
    for i, s in enumerate(silent):
        if s and start is None:
            start = i
        elif not s and start is not None:
            if (i - start) * frame >= min_s * sr:
                out.append((start * frame, i * frame))
            start = None
    if start is not None and (len(silent) - start) * frame >= min_s * sr:
        out.append((start * frame, len(y)))
    return out


class SilenceCutTool(BaseTool):
    """'silence_cut': shrink silences >300 ms to 300 ms
    (reference python/silence_cut/model.py:13-54)."""

    async def run(self, data: Dict, websocket=None):
        in_path = data.get("inPath") or data["inputDirectory"]
        out_dir = data.get("outputDirectory") or os.path.dirname(in_path)
        os.makedirs(out_dir, exist_ok=True)
        settings = data.get("toolSettings", {})
        min_s = float(settings.get("maxSilenceMS", 300)) / 1000.0
        thr = float(settings.get("silenceThresholdDB", -40))
        files = list_audio_files(in_path)

        def work(f):
            y, sr = decode_any(f, TARGET_SR)
            keep = int(min_s * sr)
            sil = find_silences(y, sr, thr, min_s)
            if not sil:
                save_wav(os.path.join(out_dir, os.path.basename(f)), y, sr)
                return
            pieces, pos = [], 0
            for s, e in sil:
                pieces.append(y[pos : s + keep // 2])
                pos = e - keep // 2
            pieces.append(y[pos:])
            save_wav(os.path.join(out_dir, os.path.basename(f)),
                     np.concatenate(pieces), sr)

        await self.run_items(files, work, websocket, out_dir)
        await self.done(websocket)


class SilenceSplitTool(BaseTool):
    """'silence_split': split clips at detected silences
    (reference python/silence_split/model.py:13-59)."""

    async def run(self, data: Dict, websocket=None):
        in_path = data.get("inPath") or data["inputDirectory"]
        out_dir = data.get("outputDirectory") or os.path.dirname(in_path)
        os.makedirs(out_dir, exist_ok=True)
        settings = data.get("toolSettings", {})
        min_s = float(settings.get("minSilenceDurationMS", 400)) / 1000.0
        thr = float(settings.get("silenceThresholdDB", -35))
        files = list_audio_files(in_path)

        def work(f):
            y, sr = decode_any(f, TARGET_SR)
            sil = find_silences(y, sr, thr, min_s)
            stem = os.path.splitext(os.path.basename(f))[0]
            bounds = [0] + [(s + e) // 2 for s, e in sil] + [len(y)]
            count = 0
            for i in range(len(bounds) - 1):
                seg = y[bounds[i] : bounds[i + 1]]
                if len(seg) > 0.25 * sr:
                    save_wav(os.path.join(out_dir, f"{stem}_{count:04d}.wav"), seg, sr)
                    count += 1
            return count

        await self.run_items(files, work, websocket, out_dir)
        await self.done(websocket)


class CutPaddingTool(BaseTool):
    """'cut_padding': trim head/tail silence
    (reference python/cut_padding/model.py:12-27)."""

    async def run(self, data: Dict, websocket=None):
        in_path = data.get("inPath") or data["inputDirectory"]
        out_dir = data.get("outputDirectory") or os.path.dirname(in_path)
        os.makedirs(out_dir, exist_ok=True)
        files = list_audio_files(in_path)

        def work(f):
            y, sr = decode_any(f, TARGET_SR)
            save_wav(os.path.join(out_dir, os.path.basename(f)),
                     trim_silence_db(y, top_db=45.0), sr)

        await self.run_items(files, work, websocket, out_dir)
        await self.done(websocket)


class NoiseRemovalTool(BaseTool):
    """'noise_removal': spectral-subtraction denoise from a noise-profile clip
    (native equivalent of sox noiseprof/noisered —
    reference python/noise_removal/model.py:35-81)."""

    async def run(self, data: Dict, websocket=None):
        in_path = data.get("inPath") or data["inputDirectory"]
        noise_path = data.get("noiseProfile") or data.get("noisePath")
        out_dir = data.get("outputDirectory") or os.path.dirname(in_path)
        os.makedirs(out_dir, exist_ok=True)
        strength = float(data.get("toolSettings", {}).get("strength", 0.25))
        noise, sr_n = decode_any(noise_path, TARGET_SR)
        profile = self._profile(noise)
        files = list_audio_files(in_path)

        def work(f):
            y, sr = decode_any(f, TARGET_SR)
            save_wav(os.path.join(out_dir, os.path.basename(f)),
                     self._denoise(y, profile, strength), sr)

        await self.run_items(files, work, websocket, out_dir)
        await self.done(websocket)

    @staticmethod
    def _stft(y, n_fft=1024, hop=256):
        pad = n_fft // 2
        y = np.pad(y, (pad, pad), mode="reflect")
        n = 1 + (len(y) - n_fft) // hop
        idx = np.arange(n)[:, None] * hop + np.arange(n_fft)[None, :]
        w = np.hanning(n_fft)
        return np.fft.rfft(y[idx] * w, axis=1), w

    def _profile(self, noise: np.ndarray) -> np.ndarray:
        spec, _ = self._stft(noise)
        return np.abs(spec).mean(axis=0)

    def _denoise(self, y: np.ndarray, profile: np.ndarray, strength: float):
        n_fft, hop = 1024, 256
        spec, w = self._stft(y)
        mag = np.abs(spec)
        # over-subtraction scaled by strength (sox noisered-like behavior)
        floor = 0.02 * mag
        cleaned = np.maximum(mag - (1.0 + 4.0 * strength) * profile[None, :], floor)
        spec = cleaned * np.exp(1j * np.angle(spec))
        frames = np.fft.irfft(spec, n=n_fft, axis=1) * w
        out = np.zeros(len(y) + n_fft)
        wsum = np.zeros(len(y) + n_fft)
        for i in range(frames.shape[0]):
            out[i * hop : i * hop + n_fft] += frames[i]
            wsum[i * hop : i * hop + n_fft] += w**2
        out = out[n_fft // 2 : n_fft // 2 + len(y)] / np.maximum(
            wsum[n_fft // 2 : n_fft // 2 + len(y)], 1e-8
        )
        return out.astype(np.float32)


_SRT_TIME = re.compile(r"(\d+):(\d+):(\d+)[,.](\d+)")


def parse_srt(text: str) -> List[Dict]:
    """[{start, end, text}] from .srt content."""
    entries = []
    for block in re.split(r"\n\s*\n", text.strip()):
        lines = [l.strip() for l in block.splitlines() if l.strip()]
        if len(lines) < 2 or "-->" not in "".join(lines):
            continue
        tl = next(l for l in lines if "-->" in l)
        times = _SRT_TIME.findall(tl)
        if len(times) < 2:
            continue

        def to_s(t):
            h, m, s, ms = (int(x) for x in t)
            return h * 3600 + m * 60 + s + ms / 1000.0

        txt = " ".join(lines[lines.index(tl) + 1 :])
        entries.append({"start": to_s(times[0]), "end": to_s(times[1]), "text": txt})
    return entries


def format_srt(entries: List[Dict]) -> str:
    def fmt(t):
        # round to whole milliseconds FIRST: rounding the fractional part
        # alone can yield ms=1000 ("00:00:01,1000", malformed SRT)
        total_ms = int(round(t * 1000))
        s, ms = divmod(total_ms, 1000)
        h, rem = divmod(s, 3600)
        m, s = divmod(rem, 60)
        return f"{h:02d}:{m:02d}:{s:02d},{ms:03d}"

    out = []
    for i, e in enumerate(entries, 1):
        out.append(f"{i}\n{fmt(e['start'])} --> {fmt(e['end'])}\n{e['text']}\n")
    return "\n".join(out)


class SrtSplitTool(BaseTool):
    """'srt_split': slice long audio by .srt timestamps into a dataset
    (reference python/srt_split/model.py:12-100)."""

    async def run(self, data: Dict, websocket=None):
        audio_path = data.get("inPath") or data["audioFile"]
        srt_path = data.get("srtPath") or data["srtFile"]
        out_dir = data.get("outputDirectory") or os.path.dirname(audio_path)
        os.makedirs(os.path.join(out_dir, "wavs"), exist_ok=True)
        y, sr = decode_any(audio_path, TARGET_SR)
        with open(srt_path, encoding="utf-8") as f:
            entries = parse_srt(f.read())
        stem = os.path.splitext(os.path.basename(audio_path))[0]
        lines = []
        for i, e in enumerate(entries):
            seg = y[int(e["start"] * sr) : int(e["end"] * sr)]
            if len(seg) < 0.2 * sr:
                continue
            name = f"{stem}_{i:05d}.wav"
            save_wav(os.path.join(out_dir, "wavs", name), seg, sr)
            lines.append(f"{name}|{e['text']}")
            self.write_progress(out_dir, i + 1, len(entries))
        with open(os.path.join(out_dir, "metadata.csv"), "w", encoding="utf-8") as f:
            f.write("\n".join(lines))
        await self.done(websocket)


def decode_wem_pcm(path: str):
    """Native decode for PCM/float Wwise .wem files.

    Wwise containers are RIFF WAVE with extra chunks; when the codec is
    plain PCM (0x0001), IEEE float (0x0003), or WAVE_FORMAT_EXTENSIBLE
    (0xFFFE, the common Wwise PCM tag), the `data` chunk is raw samples and
    needs no ww2ogg/codebooks. Returns (mono float32, sr) or None when the
    codec is Vorbis/other (2 = Wwise's ADPCM/Vorbis tags need the binary).
    """
    import struct

    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 12 or raw[:4] not in (b"RIFF", b"RIFX"):
        return None
    big = raw[:4] == b"RIFX"
    u32 = (">I" if big else "<I")
    u16 = (">H" if big else "<H")
    if raw[8:12] != b"WAVE":
        return None
    pos, fmt, data = 12, None, None
    while pos + 8 <= len(raw):
        cid = raw[pos:pos + 4]
        size = struct.unpack_from(u32, raw, pos + 4)[0]
        body = raw[pos + 8: pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None or len(fmt) < 16:
        return None
    tag = struct.unpack_from(u16, fmt, 0)[0]
    channels = struct.unpack_from(u16, fmt, 2)[0]
    sr = struct.unpack_from(u32, fmt, 4)[0]
    bits = struct.unpack_from(u16, fmt, 14)[0]
    if tag == 0xFFFE and len(fmt) >= 26:
        # extensible: the real tag is the first 2 bytes of the SubFormat GUID
        tag = struct.unpack_from(u16, fmt, 24)[0]
    if tag not in (0x0001, 0x0003) or channels < 1 or sr <= 0:
        return None  # Vorbis/ADPCM .wem → needs ww2ogg
    if tag == 0x0003 and bits == 32:
        y = np.frombuffer(data, dtype=(">f4" if big else "<f4")).astype(np.float32)
    elif bits == 16:
        y = np.frombuffer(data, dtype=(">i2" if big else "<i2")).astype(np.float32) / 32768.0
    elif bits == 8:
        y = (np.frombuffer(data, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif bits == 24:
        b = np.frombuffer(data, np.uint8)
        b = b[: len(b) // 3 * 3].reshape(-1, 3)
        if big:
            b = b[:, ::-1]
        vals = (b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        y = vals.astype(np.float32) / float(1 << 23)
    elif tag == 0x0001 and bits == 32:
        y = np.frombuffer(data, dtype=(">i4" if big else "<i4")).astype(np.float32) / 2147483648.0
    else:
        return None
    if channels > 1:
        y = y[: len(y) // channels * channels].reshape(-1, channels).mean(axis=1)
    return y.astype(np.float32), int(sr)


class Wem2OggTool(BaseTool):
    """'wem2ogg': Wwise .wem audio extraction (reference shells out to a
    bundled ww2ogg.exe + codebooks — python/wem2ogg/model.py:36-64). Fully
    native here: PCM/float .wem decode straight to .wav, and Vorbis-codec
    .wem are rebuilt to .ogg by tools/wwise_vorbis.py (packet re-framing +
    aoTuV codebook re-inflation, no external binary). Matching the
    reference's output, Vorbis conversions are written as .ogg; pass
    ``toWav: true`` to also decode them to .wav via the system libvorbis."""

    async def run(self, data: Dict, websocket=None):
        from .wwise_vorbis import WemParseError, wem_to_ogg

        in_path = data.get("inPath") or data["inputDirectory"]
        out_dir = data.get("outputDirectory") or os.path.dirname(in_path)
        to_wav = bool(data.get("toWav"))
        codebooks = data.get("codebooksPath")  # custom game library override
        os.makedirs(out_dir, exist_ok=True)
        files = [f for f in list_audio_files(in_path) if f.endswith(".wem")] or [
            os.path.join(in_path, f)
            for f in os.listdir(in_path)
            if f.endswith(".wem")
        ]
        failed = []

        def work(f):
            decoded = decode_wem_pcm(f)
            stem = os.path.basename(f)[:-4]
            if decoded is not None:
                y, sr = decoded
                save_wav(os.path.join(out_dir, stem + ".wav"), y, sr)
                return
            try:
                ogg = wem_to_ogg(f, codebook_path=codebooks)
            except WemParseError as e:
                failed.append(f"{os.path.basename(f)} ({e})")
                return
            ogg_path = os.path.join(out_dir, stem + ".ogg")
            with open(ogg_path, "wb") as fh:
                fh.write(ogg)
            if to_wav:
                from ..native.vorbis import decode_ogg

                out = decode_ogg(ogg_path)
                if out is not None:
                    save_wav(os.path.join(out_dir, stem + ".wav"), *out)

        await self.run_items(files, work, websocket, out_dir)
        if failed:
            # every convertible file is already written; report the rest once
            raise RuntimeError(
                f"{len(failed)} .wem could not be converted: "
                + ", ".join(sorted(failed)[:20]))
        await self.done(websocket)
