"""v3 serving path: the ``/exportWav`` request of the task server, and voice
conversion.

Counterpart of ``xva_trainer_tpu/app/server.py::_export_wav`` and
``_synthesize_v3`` for ``.pt`` checkpoints: text → ``v3_text_to_ids`` →
tokens padded to 128 → ``XVAPitch.infer`` at ``max_frames=512`` → the wav cut
to ``y_lengths * hop`` → EBU R128 loudness normalization → 16-bit wav. The
task server (``app/server.py``) builds its ``/exportWav`` on these.

The noise that ``infer`` and ``voice_conversion`` consume is drawn from a CPU
``torch.Generator`` seeded with ``NOISE_SEED`` (the JAX server's
``PRNGKey(3)``) and then moved to the model's device, so one request gives
the same draws on every device.
"""
from __future__ import annotations

import functools
import json
import os
from typing import Dict, Optional

import numpy as np
import torch
from scipy.io import wavfile

from . import resolve_device
from .data.text import v3_text_to_ids
from .data.xva_dataset import lang_to_id
from .interop.convert import ups_from_reference
from .models.xvapitch import XVAPitch, XVAPitchConfig
from .ops.fused_stft import mel_spectrogram_fused
from .ops.loudness import normalize_ebu_r128
from .ops.stft import DEFAULT_MEL

SAMPLE_RATE = 22050
TEXT_TOKENS = 128   # server.py:1233
MAX_FRAMES = 512    # server.py:1267
DEFAULT_TEXT = "This is what my voice sounds like."
NOISE_SEED = 3      # server.py:1268


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def load_xvapitch(path: str, cfg: XVAPitchConfig = XVAPitchConfig(),
                  device="cuda") -> XVAPitch:
    """An exported xVASynth ``{voice}.pt`` (a flat reference-named state
    dict, usually fp16, or one under ``model``/``state_dict``/``generator``)
    → an ``XVAPitch`` in eval mode on ``device``, loaded with
    ``strict=True``. The ``disc.*`` discriminator weights of a full training
    checkpoint and its ``step`` are training state, which serving does not
    need; they are set aside before the strict load. The decoder's
    upsampling weight norm is moved to the port's layout
    (``interop.convert.ups_from_reference``)."""
    dev = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict", "generator"):
        if isinstance(sd.get(key), dict):
            sd = sd[key]
            break
    sd = {k: v for k, v in sd.items() if not k.startswith("disc.") and k != "step"}
    model = XVAPitch(cfg)
    # the reference normalises the decoder's upsampling convs per input
    # channel, the port per output channel (as the JAX package does)
    model.load_state_dict(ups_from_reference(sd), strict=True)
    return model.eval().to(dev)


@functools.lru_cache(maxsize=1)
def _cached_model(path: str, mtime_ns: int, cfg: XVAPitchConfig, device: str) -> XVAPitch:
    return load_xvapitch(path, cfg, device)


def cached_xvapitch(path: str, cfg: XVAPitchConfig = XVAPitchConfig(),
                    device="cuda") -> XVAPitch:
    """``load_xvapitch``, kept loaded for the next call while the file is
    unchanged."""
    dev = resolve_device(device)
    return _cached_model(os.path.abspath(path), os.stat(path).st_mtime_ns, cfg, str(dev))


def resolve_voice_emb(ckpt_path: str) -> Optional[np.ndarray]:
    """The voice's speaker embedding when a request sends none: the exported
    voice's metadata JSON (``games[0].base_speaker_emb``) or an ``emb.txt``
    beside the checkpoint (``server.py:1181-1207``)."""
    meta = os.path.splitext(ckpt_path)[0] + ".json"
    if os.path.exists(meta):
        with open(meta, encoding="utf8") as f:
            games = json.load(f).get("games") or []
        if games and games[0].get("base_speaker_emb"):
            return np.asarray(games[0]["base_speaker_emb"], np.float32)
    txt = os.path.join(os.path.dirname(ckpt_path), "emb.txt")
    if os.path.exists(txt):
        return np.loadtxt(txt, delimiter=",").astype(np.float32)
    return None


def text_tokens(text: str, lang: str = "en") -> np.ndarray:
    """Token ids of ``text``, zero-padded (or cut) to TEXT_TOKENS."""
    ids = v3_text_to_ids(lang)(text)
    return np.pad(ids, (0, max(0, TEXT_TOKENS - len(ids))))[:TEXT_TOKENS].astype(np.int64)


def synthesize_v3(model: XVAPitch, text: str, emb: Optional[np.ndarray], lang: str = "en",
                  *, max_frames: int = MAX_FRAMES) -> np.ndarray:
    """text → float waveform (y_length * hop samples) on the model's device,
    with speaker embedding ``emb`` (d_vector_dim,; zeros when None)."""
    dev, c = _device_of(model), model.cfg
    tokens = torch.from_numpy(text_tokens(text, lang))[None]
    dvec = np.zeros((1, c.d_vector_dim), np.float32) if emb is None \
        else np.asarray(emb, np.float32)[None]
    g = torch.Generator().manual_seed(NOISE_SEED)
    dp_noise = torch.randn((1, 2, TEXT_TOKENS), generator=g)
    noise = torch.randn((1, c.latent_size, max_frames), generator=g)
    out = model.infer(tokens.to(dev), torch.from_numpy(dvec).to(dev),
                      torch.tensor([lang_to_id(lang)], device=dev), max_frames=max_frames,
                      noise=noise.to(dev), dp_noise=dp_noise.to(dev))
    n = int(out["y_lengths"][0]) * c.hop_length
    return out["wav"][0, :n].float().cpu().numpy()


def save_wav(path: str, y: np.ndarray, sr: int = SAMPLE_RATE) -> None:
    """Write float [-1, 1] audio as 16-bit PCM."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    wavfile.write(path, sr, (np.clip(y, -1.0, 1.0) * 32767.0).astype(np.int16))


def export_wav(body: Dict, *, cfg: XVAPitchConfig = XVAPitchConfig(),
               device="cuda") -> Dict:
    """The ``/exportWav`` request: ``{"xvap_ckpt": "<voice>.pt", "out_path",
    "text", "emb", "lang"}`` → loads the checkpoint strictly (kept loaded
    for the next request while the file is unchanged), synthesizes,
    normalizes the loudness and writes ``out_path``."""
    dev = resolve_device(device)
    ckpt = body["xvap_ckpt"]
    emb = body.get("emb")
    if emb is None:
        emb = resolve_voice_emb(ckpt)
    model = cached_xvapitch(ckpt, cfg, dev)
    wav = synthesize_v3(model, body.get("text", DEFAULT_TEXT), emb, body.get("lang", "en"))
    save_wav(body["out_path"], normalize_ebu_r128(wav, SAMPLE_RATE))
    return {"ok": True, "path": body["out_path"]}


def voice_convert(model: XVAPitch, wav, src_emb, tgt_emb) -> np.ndarray:
    """Convert ``wav`` ((T,) float in [-1, 1]) from speaker ``src_emb`` to
    ``tgt_emb``: its linear spectrogram comes from the fused STFT kernel
    (on the card; its plain version on the CPU), then
    ``XVAPitch.voice_conversion``. Returns (frames * hop,) samples."""
    dev, c = _device_of(model), model.cfg
    y = torch.as_tensor(np.asarray(wav, np.float32)).to(dev)
    _, linear = mel_spectrogram_fused(y, DEFAULT_MEL, center=True, return_linear=True)
    frames = linear.shape[-1]
    g = torch.Generator().manual_seed(NOISE_SEED)
    noise = torch.randn((1, c.latent_size, frames), generator=g)

    def emb(e):
        return torch.as_tensor(np.asarray(e, np.float32)).reshape(1, -1).to(dev)

    out = model.voice_conversion(linear[None], torch.tensor([frames], device=dev),
                                 emb(src_emb), emb(tgt_emb), noise=noise.to(dev))
    return out[0].float().cpu().numpy()
