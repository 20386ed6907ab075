"""Rolling training checkpoints, and the xVASynth v3 and v2 exports.

Counterpart of ``xva_trainer_tpu/train/checkpoints.py`` (reference
python/xvapitch/xva_train.py: checkpoint contents :952-963, a rolling window
of 2 :927-931, resume from the newest :1518-1529, the fp16 export
:984-1022):

- The JAX package writes orbax directories ``<prefix>_<step>/``; the port has
  no orbax, so a checkpoint is one ``torch.save`` file ``<prefix>_<step>.pt``
  (the trainer puts its model, discriminator and both optimisers' state in
  it, and its whole host state), beside a JSON sidecar ``<prefix>_<step>.json``
  with the host state the trainer passes, as JAX's sidecar has it. The file
  is written under a temporary name, synced and renamed into place with
  ``os.replace``, and only then is the sidecar written: a crash mid-write
  leaves the previous checkpoint intact and newest. Restore reads the host
  state from the ``.pt`` file, so a missing sidecar loses nothing.
- Saves are synchronous (JAX's orbax writes are asynchronous), so ``wait``
  returns at once. ``last_save`` has the last write's seconds and bytes.
- Each package reads and deletes only its own checkpoints: ``_steps`` and
  ``_gc`` see ``<prefix>_<n>.pt`` files only, JAX's see directories only.
  ``foreign_steps`` lists JAX's, so that a trainer can refuse to start from
  scratch over them.

The export is the reference's flat torch-named fp16 state dict, equal to the
JAX package's ``xvapitch_state_dict``: every weight-norm pair is re-split as
torch's ``weight_norm(dim=0)`` stores it, ``weight_v`` the effective weight
and ``weight_g`` its norm over dim 0 (the decoder's ``ups`` included, whose
dim 0 is the input channel), computed in float64 from the pair as the port
holds it (flax's: ``weight_v`` the kernel, ``weight_g`` the scale, over the
output axis). The v2 exports are FastPitch's fp16 reference-layout state
dict with its extra keys and the same metadata JSON as the JAX package's
(``export_fastpitch_v2``), and the HiFi-GAN generator's fp32
reference-layout state dict (``export_hifigan_v2``).
"""
from __future__ import annotations

import json
import os
import re
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.nn.utils.weight_norm import WeightNorm

from ..interop.convert import _norm_except


class CheckpointManager:
    """Rolling-window checkpoint files with a JSON sidecar for host state."""

    max_to_keep = 2  # reference :927-931

    def __init__(self, output_dir: str, prefix: str):
        self.output_dir = os.path.abspath(output_dir)
        os.makedirs(self.output_dir, exist_ok=True)
        self.prefix = prefix
        self.last_save: Dict[str, float] = {}

    def _path(self, step: int) -> str:
        return os.path.join(self.output_dir, f"{self.prefix}_{step}.pt")

    def _sidecar(self, step: int) -> str:
        return os.path.join(self.output_dir, f"{self.prefix}_{step}.json")

    def save(self, step: int, state: Dict[str, Any], host_state: Optional[Dict] = None) -> str:
        """Write ``state`` (tensors, numbers, strings, lists and dicts) and
        ``host_state`` as checkpoint ``step``, then drop all but the newest
        ``max_to_keep``. Synchronous."""
        t0 = time.perf_counter()
        path = self._path(step)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            torch.save({"step": int(step), "state": state, "host": host_state}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        if host_state is not None:
            side = self._sidecar(step)
            with open(side + ".tmp", "w") as f:
                json.dump(host_state, f)
            os.replace(side + ".tmp", side)
        self.last_save = {"step": int(step), "seconds": time.perf_counter() - t0,
                          "bytes": os.path.getsize(path)}
        self._gc()
        return path

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def _matching(self, pattern: str, want_dir: bool) -> List[int]:
        pat = re.compile(pattern)
        out = []
        for name in os.listdir(self.output_dir):
            m = pat.match(name)
            if m and os.path.isdir(os.path.join(self.output_dir, name)) == want_dir:
                out.append(int(m.group(1)))
        return sorted(out)

    def _steps(self) -> List[int]:
        return self._matching(rf"^{re.escape(self.prefix)}_(\d+)\.pt$", want_dir=False)

    def foreign_steps(self) -> List[int]:
        """Steps of the JAX package's orbax checkpoint directories here."""
        return self._matching(rf"^{re.escape(self.prefix)}_(\d+)$", want_dir=True)

    def _gc(self):
        for s in self._steps()[: -self.max_to_keep]:
            for p in (self._path(s), self._sidecar(s)):
                if os.path.exists(p):
                    os.remove(p)
        # the temporary file of a write that was cut short
        for s in self._matching(rf"^{re.escape(self.prefix)}_(\d+)\.pt\.tmp$", want_dir=False):
            os.remove(self._path(s) + ".tmp")

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, map_location="cpu") -> Tuple[Optional[int], Any, Optional[Dict]]:
        """(step, state, host state) of the newest checkpoint, the tensors on
        ``map_location``; (None, None, None) when there is none."""
        step = self.latest_step()
        if step is None:
            return None, None, None
        ckpt = torch.load(self._path(step), map_location=map_location, weights_only=True)
        return step, ckpt["state"], ckpt["host"]


def _weight_norm_dims(module: nn.Module) -> Dict[str, int]:
    """{state-dict prefix of a weight-normed parameter: its norm's dim}."""
    out = {}
    for name, sub in module.named_modules():
        for hook in sub._forward_pre_hooks.values():
            if isinstance(hook, WeightNorm):
                out[(name + "." if name else "") + hook.name] = hook.dim
    return out


def _reference_layout(module: nn.Module, prefix: str = "") -> "OrderedDict[str, torch.Tensor]":
    """``module``'s state dict on the CPU with every weight-norm pair
    re-split over dim 0 (v = w, g = ||w||), as the JAX package's
    ``interop/mapping.py::apply_export`` writes it: w = v/||v||·g in float64,
    rounded to float32, then g = ||w|| in float64, rounded to float32."""
    sd = OrderedDict((k, v.detach().cpu()) for k, v in module.state_dict().items())
    for base, dim in _weight_norm_dims(module).items():
        g, v = sd[base + "_g"].double(), sd[base + "_v"].double()
        w = (v / torch.clamp(_norm_except(v, dim), min=1e-12) * g).float()
        sd[base + "_g"] = _norm_except(w.double(), 0).float()
        sd[base + "_v"] = w
    return OrderedDict((prefix + k, v) for k, v in sd.items())


def xvapitch_state_dict(model: nn.Module,
                        disc: Optional[nn.Module] = None) -> "OrderedDict[str, torch.Tensor]":
    """The port's XVAPitch (and VitsDiscriminator) → the reference's flat
    torch-named fp16 state dict that xVASynth ``load_state_dict``s
    (reference xva_train.py:984-1022: ``torch.save(model_half.state_dict())``,
    the ``disc.*`` subtree included): the JAX package's
    ``xvapitch_state_dict`` of the same parameters. Floating entries are
    fp16; the unused last ``norm_layers_2`` of the pitch transformer is the
    model's own entry (its initial value, as JAX writes it)."""
    sd = _reference_layout(model)
    if disc is not None:
        sd.update(_reference_layout(disc, "disc."))
    return OrderedDict((k, v.half().contiguous() if v.is_floating_point() else v.contiguous())
                       for k, v in sd.items())


def export_xvapitch_v3(
    model: nn.Module,
    out_path: str,
    voice_name: str,
    lang: str = "en",
    base_emb: Optional[np.ndarray] = None,
    other_embs: Optional[list] = None,
    disc: Optional[nn.Module] = None,
    lang_capabilities: Optional[list] = None,
) -> None:
    """xVASynth v3 export (reference python/xvapitch/xva_train.py:984-1022):
    ``xvapitch_state_dict`` written with ``torch.save`` to ``out_path``, and
    the metadata JSON beside it, as the JAX package writes them with its
    default game ("other") and author ("")."""
    torch.save(xvapitch_state_dict(model, disc), out_path)
    meta = {
        "version": "3.0",
        "modelVersion": "3.0",
        "modelType": "xVAPitch",
        "author": "",
        "lang": lang,
        "lang_capabilities": lang_capabilities or [lang],
        "games": [
            {
                "gameId": "other",
                "voiceId": voice_name,
                "voiceName": voice_name,
                "base_speaker_emb": (np.asarray(base_emb).tolist()
                                     if base_emb is not None else []),
                "gender": "male",
            }
        ],
    }
    if other_embs is not None:
        meta["games"][0]["other_embs"] = other_embs
    with open(os.path.splitext(out_path)[0] + ".json", "w") as f:
        json.dump(meta, f, indent=4)


def export_fastpitch_v2(model: nn.Module, out_path: str, voice_name: str,
                        pitch_stats: Optional[Tuple[float, float]] = None) -> None:
    """xVASynth v2 export (reference fastpitch1_1/xva_train.py:1030-1047):
    ``interop/fastpitch_map.py::fastpitch_state_dict`` in fp16 written with
    ``torch.save`` to ``out_path``, and the metadata JSON beside it, as the
    JAX package writes them with its default game ("other") and author
    ("")."""
    from ..interop.fastpitch_map import fastpitch_state_dict

    mean, std = pitch_stats if pitch_stats is not None else (0.0, 1.0)
    torch.save(fastpitch_state_dict(model, pitch_mean=mean, pitch_std=std), out_path)
    meta = {
        "version": "2.0",
        "modelVersion": "2.0",
        "modelType": "FastPitch1.1",
        "author": "",
        "lang": "en",
        "games": [
            {
                "gameId": "other",
                "voiceId": voice_name,
                "voiceName": voice_name,
                "resemblyzer": [],
                "gender": "male",
            }
        ],
    }
    with open(os.path.splitext(out_path)[0] + ".json", "w") as f:
        json.dump(meta, f, indent=4)


def export_hifigan_v2(gen: nn.Module, out_path: str) -> None:
    """The v2 vocoder export ``{voice}.hg.pt`` (reference
    hifigan/xva_train.py:600-601): ``{"generator": sd}``, ``sd`` the port's
    ``Generator``'s fp32 state dict in the reference layout (every
    weight-norm pair re-split over dim 0, the ``ups`` per input channel), as
    the JAX package's export writes it through ``v2_generator_rules``."""
    sd = _reference_layout(gen)
    torch.save({"generator": OrderedDict((k, v.float().contiguous()) for k, v in sd.items())},
               out_path)
