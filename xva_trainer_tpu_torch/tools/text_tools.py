"""Transcription, WER evaluation, make_srt and source separation (reference
python/{transcribe,wer_evaluation,make_srt,audio_source_separation}/model.py).

Counterpart of ``xva_trainer_tpu/tools/text_tools.py``. The models run on
the tool's device: whisper (``models/whisper``) from a local ``.pt``,
wav2vec2 CTC (``models/wav2vec2``) from a HuggingFace directory, and the
enhancer (``models/enhance``) on the shipped weights. Two differences by
design: without a backend, ``transcribe`` reports a ``tasks_error`` (the
JAX package's last resort, a ``transformers`` pipeline, is not ported), and
``ass`` reads the enhancer's weights from a ``.npz`` in ``load_params_npz``'s
layout, answering an orbax directory (the JAX package's format) with a
``tasks_error``. Loaded models are cached per device, so that none outlives
a device change on the old device.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from ..data.audio_io import resample, save_wav
from .audio_tools import decode_any, format_srt, list_audio_files
from .base import BaseTool


def wer(reference: str, hypothesis: str) -> float:
    """Word error rate via Levenshtein distance (native jiwer replacement,
    reference wer_evaluation/model.py:36-85)."""
    r = reference.lower().split()
    h = hypothesis.lower().split()
    if not r:
        return 0.0 if not h else 1.0
    d = np.zeros((len(r) + 1, len(h) + 1), np.int32)
    d[:, 0] = np.arange(len(r) + 1)
    d[0, :] = np.arange(len(h) + 1)
    for i in range(1, len(r) + 1):
        for j in range(1, len(h) + 1):
            cost = 0 if r[i - 1] == h[j - 1] else 1
            d[i, j] = min(d[i - 1, j] + 1, d[i, j - 1] + 1, d[i - 1, j - 1] + cost)
    return float(d[len(r), len(h)]) / len(r)


class WerEvaluationTool(BaseTool):
    """'wer_evaluation': WER between user metadata.csv and ASR metadata.csv,
    sorted report (reference wer_evaluation/model.py:36-85)."""

    async def run(self, data: Dict, websocket=None):
        user_csv = data.get("userMetadata") or data["inPath"]
        asr_csv = data.get("asrMetadata") or data["inputDirectory2"]
        out_path = data.get("outputFile") or os.path.join(
            os.path.dirname(user_csv), "wer_report.txt"
        )

        def read_csv(p):
            out = {}
            with open(p, encoding="utf-8") as f:
                for line in f:
                    if "|" in line:
                        k, v = line.strip().split("|", 1)
                        out[os.path.splitext(k)[0]] = v.split("|")[0]
            return out

        user = read_csv(user_csv)
        hyp = read_csv(asr_csv)
        rows = []
        for k, ref_text in user.items():
            if k in hyp:
                rows.append((wer(ref_text, hyp[k]), k, ref_text, hyp[k]))
        rows.sort(reverse=True)
        with open(out_path, "w", encoding="utf-8") as f:
            for w, k, r, h in rows:
                f.write(f"{w:.3f} | {k} | {r} | {h}\n")
        mean_wer = float(np.mean([r[0] for r in rows])) if rows else 0.0
        await self.task_info(websocket, f"mean WER: {mean_wer:.3f} over {len(rows)} files")
        await self.done(websocket)


NO_ASR_BACKEND = (
    "no ASR model installed. One-time setup: download any whisper checkpoint "
    "(e.g. huggingface-cli download openai/whisper-base --local-dir /tmp/whisper-base, "
    "or an OpenAI whisper {size}.pt), then run\n"
    "  python -m xva_trainer_tpu_torch.cli import-whisper /tmp/whisper-base --out ~/.xva/whisper\n"
    "and set XVA_WHISPER_CKPT=~/.xva/whisper/whisper.pt (or pass toolSettings.modelPath). "
    "Custom backends: TranscribeTool.set_asr_backend")


class TranscribeTool(BaseTool):
    """'transcribe': ASR over a directory → metadata.csv with incremental
    flush and resume (reference transcribe/model.py:118-257).

    Backend, in order: a callable registered with ``set_asr_backend``; a
    whisper ``.pt`` (``toolSettings.modelPath`` or ``$XVA_WHISPER_CKPT``,
    ``cli import-whisper`` writes one), decoded with the tokenizer assets
    beside it, or as ids without them; a HuggingFace directory of
    ``model_type`` wav2vec2. Without one the tool reports a ``tasks_error``.
    """

    _asr_backend = None
    _asr_cache: Dict = {}  # (model_path, lang, device) -> fn

    @classmethod
    def set_asr_backend(cls, fn):
        """fn(wav_16k: np.ndarray) -> str"""
        cls._asr_backend = fn

    def _load_backend(self, model_path: Optional[str], lang: Optional[str] = "en"):
        if TranscribeTool._asr_backend is not None:
            return TranscribeTool._asr_backend
        model_path = model_path or os.environ.get("XVA_WHISPER_CKPT")
        cache_key = (model_path, lang, str(self.device))
        cached = TranscribeTool._asr_cache.get(cache_key)
        if cached is not None:
            return cached
        fn = None
        if model_path and os.path.isfile(model_path) and model_path.endswith(".pt"):
            from ..interop.whisper_map import load_whisper
            from ..models.whisper import BpeDecoder, WhisperASR

            sd, cfg = load_whisper(model_path)
            asr = WhisperASR(sd, cfg, device=self.device)
            tok = BpeDecoder.find(os.path.dirname(model_path),
                                  os.path.join(os.path.dirname(model_path), "assets"))

            def fn(wav16k):
                ids = asr.transcribe_tokens(wav16k, lang=lang)
                if tok is None:  # no tokenizer assets: ids, so that resume still works
                    return " ".join(str(i) for i in ids)
                return tok.decode(ids).strip()
        elif model_path and os.path.isfile(os.path.join(model_path, "config.json")):
            with open(os.path.join(model_path, "config.json")) as f:
                mtype = json.load(f).get("model_type", "")
            if mtype == "wav2vec2":
                from ..models.wav2vec2 import Wav2Vec2CTC

                fn = Wav2Vec2CTC.from_hf_dir(model_path, device=self.device).transcribe
        if fn is not None:
            TranscribeTool._asr_cache[cache_key] = fn
        return fn

    async def run(self, data: Dict, websocket=None):
        in_path = data.get("inPath") or data["inputDirectory"]
        out_dir = data.get("outputDirectory") or in_path
        settings = data.get("toolSettings", {})
        # the reference UI's whisper_lang; blank, "detect" or "auto" autodetects
        lang = settings.get("whisper_lang", settings.get("language", "en"))
        if isinstance(lang, str) and lang.strip().lower() in ("", "detect", "auto"):
            lang = None
        backend = self._load_backend(settings.get("modelPath"), lang)
        if backend is None:
            await self.error(websocket, NO_ASR_BACKEND)
            return
        os.makedirs(out_dir, exist_ok=True)
        meta_path = os.path.join(out_dir, "metadata.csv")
        existing = {}
        if os.path.exists(meta_path):  # resume (reference :118-133)
            with open(meta_path, encoding="utf-8") as f:
                for line in f:
                    if "|" in line:
                        k, v = line.strip().split("|", 1)
                        existing[k] = v
        files = list_audio_files(in_path)
        # resume by stem: LJSpeech-style keys ("LJ001-0001") name files with ".wav"
        done_stems = {os.path.splitext(k)[0] for k, v in existing.items() if v.strip()}
        done = sum(1 for f in files if os.path.splitext(os.path.basename(f))[0] in done_stems)
        self.write_progress(out_dir, done, len(files))
        for f in files:
            name = os.path.basename(f)
            stem = os.path.splitext(name)[0]
            if stem in done_stems:
                continue
            y, sr = decode_any(f)
            text = backend(resample(y, sr, 16000))
            # fill an existing empty row of this stem in place, else add one
            key = next((k for k in existing if os.path.splitext(k)[0] == stem), name)
            existing[key] = text
            done += 1
            if done % 10 == 0:  # incremental flush every 10 files (:219-257)
                self._flush(meta_path, existing)
            self.write_progress(out_dir, done, len(files))
        self._flush(meta_path, existing)
        await self.done(websocket)

    @staticmethod
    def _flush(meta_path, existing):
        with open(meta_path, "w", encoding="utf-8") as f:
            f.write("\n".join(f"{k}|{v}" for k, v in existing.items()))


class MakeSrtTool(BaseTool):
    """'make_srt': 16 kHz convert → diarize (the manager's speaker encoder)
    → transcribe each turn → .srt (reference make_srt/model.py:49-135);
    without an ASR backend each entry is ``[speaker_n]``."""

    async def run(self, data: Dict, websocket=None):
        in_path = data.get("inPath") or data["inputDirectory"]
        out_dir = data.get("outputDirectory") or os.path.dirname(in_path)
        os.makedirs(out_dir, exist_ok=True)
        files = list_audio_files(in_path)

        from .speaker_tools import _get_encoder, diarize

        enc = _get_encoder(self.models_manager, self.device)
        asr = TranscribeTool(self.logger, self.PROD, self.device, self.models_manager)
        backend = asr._load_backend(data.get("toolSettings", {}).get("modelPath"))

        for fi, f in enumerate(files):
            y, sr = decode_any(f)
            turns = diarize(y, sr, enc)
            entries = []
            for t in turns:
                seg = y[int(t["start"] * sr): int(t["end"] * sr)]
                text = (backend(resample(seg, sr, 16000)) if backend
                        else f"[speaker_{t['speaker']}]")
                entries.append({"start": t["start"], "end": t["end"], "text": text})
            stem = os.path.splitext(os.path.basename(f))[0]
            with open(os.path.join(out_dir, stem + ".srt"), "w", encoding="utf-8") as sf:
                sf.write(format_srt(entries))
            self.write_progress(out_dir, fi + 1, len(files))
        await self.done(websocket)


def default_enhancer_path() -> str:
    """The shipped denoiser weights, ``assets/enhancer_default.npz``."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "assets", "enhancer_default.npz")


class SourceSeparationTool(BaseTool):
    """'ass': speech enhancement (the reference runs a pretrained Asteroid
    DCCRNet, audio_source_separation/model.py:16-42). In order: a backend
    registered with ``set_model_backend``; the learned complex-ratio-mask
    denoiser on the tool's device, from a ``.npz`` at
    ``toolSettings.modelPath`` or ``$XVA_ASS_CKPT``, else from the shipped
    ``assets/enhancer_default.npz``; else the spectral gate (a per-file
    noise floor and a Wiener mask, on the host)."""

    _model_backend = None
    _enhancers: Dict = {}  # (weights path, device) -> fn

    @classmethod
    def set_model_backend(cls, fn):
        """fn(y: np.ndarray, sr: int) -> np.ndarray"""
        cls._model_backend = fn

    def _load_learned(self, model_path: Optional[str]):
        if SourceSeparationTool._model_backend is not None:
            return SourceSeparationTool._model_backend
        model_path = model_path or os.environ.get("XVA_ASS_CKPT")
        path = model_path if model_path and os.path.isfile(model_path) else default_enhancer_path()
        if not os.path.exists(path):
            return None
        key = (path, str(self.device))
        if key not in SourceSeparationTool._enhancers:
            from ..models.enhance import SpeechEnhancer, load_params_npz

            enh = SpeechEnhancer(load_params_npz(path), device=self.device)
            SourceSeparationTool._enhancers[key] = lambda y, sr: enh.enhance(y)
        return SourceSeparationTool._enhancers[key]

    async def run(self, data: Dict, websocket=None):
        in_path = data.get("inPath") or data["inputDirectory"]
        out_dir = data.get("outputDirectory") or os.path.dirname(in_path)
        settings = data.get("toolSettings", {})
        model_path = settings.get("modelPath") or os.environ.get("XVA_ASS_CKPT")
        if model_path and os.path.isdir(model_path):
            await self.error(websocket, (
                f"{model_path} is a directory, such as the JAX package's orbax checkpoint, "
                "which the PyTorch package cannot read: give the enhancer's weights as a "
                ".npz of flat 'params/<Module>_<i>/<leaf>' arrays (the layout of "
                "assets/enhancer_default.npz)"))
            return
        os.makedirs(out_dir, exist_ok=True)
        files = list_audio_files(in_path)
        backend = self._load_learned(model_path)

        def work(f):
            y, sr = decode_any(f)
            out = backend(y, sr) if backend is not None else self._spectral_gate(y)
            save_wav(os.path.join(out_dir, os.path.basename(f)), out, sr)

        await self.run_items(files, work, websocket, out_dir)
        await self.done(websocket)

    @staticmethod
    def _spectral_gate(y: np.ndarray, n_fft=1024, hop=256) -> np.ndarray:
        pad = n_fft // 2
        yp = np.pad(y, (pad, pad), mode="reflect")
        n = 1 + (len(yp) - n_fft) // hop
        idx = np.arange(n)[:, None] * hop + np.arange(n_fft)[None, :]
        w = np.hanning(n_fft)
        spec = np.fft.rfft(yp[idx] * w, axis=1)
        mag = np.abs(spec)
        noise = np.percentile(mag, 10, axis=0)  # per-bin noise floor
        snr = np.maximum(mag / np.maximum(noise[None, :], 1e-8) - 1.0, 0.0)
        mask = snr / (snr + 1.0)  # Wiener
        spec = spec * mask
        frames = np.fft.irfft(spec, n=n_fft, axis=1) * w
        out = np.zeros(len(yp))
        wsum = np.zeros(len(yp))
        for i in range(n):
            out[i * hop: i * hop + n_fft] += frames[i]
            wsum[i * hop: i * hop + n_fft] += w ** 2
        out = out / np.maximum(wsum, 1e-8)
        return out[pad: pad + len(y)].astype(np.float32)
