"""ModelsManager: lazy registry of tools + trainers + inference models.

Counterpart of ``xva_trainer_tpu/app/manager.py`` (reference
python/models_manager.py:19-161): ``init_model(key)`` lazily constructs into
a bank, ``sync_init_model`` for trainers, ``load_model(key, ckpt)`` for
inference models, ``set_device`` hot-swap. The registry is owned by a single
asyncio loop and guarded by a lock.

The device is a torch device name, ``cuda`` by default. ``set_device``
resolves it through ``resolve_device`` and raises on anything torch cannot
use here: ``tpu`` (which the JAX server persists in the shared
``app_settings.json``), or ``cuda`` on a host without a card. It never
switches to the CPU on its own.

The speaker encoder is one entry of the bank (``speaker_encoder``), shared
by the trainers and the speaker tools; the JAX manager's ``shared_cache``
copy for the tools has no counterpart.
"""
from __future__ import annotations

import asyncio
from typing import Any, Dict

from .. import resolve_device
from ..tools import TOOL_REGISTRY


class ModelsManager:
    def __init__(self, logger=None, PROD: bool = False, device: str = "cuda"):
        self.logger = logger
        self.PROD = PROD
        self.device = device
        self.models_bank: Dict[str, Any] = {}
        self._lock = asyncio.Lock()

    async def init_model(self, key: str):
        key = key.lower()
        async with self._lock:
            if key in self.models_bank:
                return self.models_bank[key]
            model = self._construct(key)
            self.models_bank[key] = model
            return model

    def sync_init_model(self, key: str):
        key = key.lower()
        if key not in self.models_bank:
            self.models_bank[key] = self._construct(key)
        return self.models_bank[key]

    def _construct(self, key: str):
        if key == "xvapitch":
            from ..train.xvapitch_trainer import XVAPitchTrainer

            return XVAPitchTrainer  # trainer class; server instantiates per run
        if key == "fastpitch1_1":
            from ..train.fastpitch_trainer import FastPitchTrainer

            return FastPitchTrainer
        if key == "hifigan":
            from ..train.hifigan_trainer import HifiganTrainer

            return HifiganTrainer
        if key == "speaker_encoder":
            from ..models.speaker_encoder import SpeakerEncoder

            return SpeakerEncoder(device=self.device)
        if key in TOOL_REGISTRY:
            return TOOL_REGISTRY[key](self.logger, self.PROD, self.device, self)
        raise KeyError(f"unknown model key: {key}")

    def load_model(self, key: str, ckpt_path: str, **kwargs):
        """Inference-model loading (reference :130-150)."""
        key = key.lower()
        if key == "infer_fastpitch" or key == "infer_xvapitch":
            self.models_bank[key] = {"ckpt": ckpt_path, **kwargs}
            return self.models_bank[key]
        raise KeyError(key)

    def set_device(self, device: str):
        """Move to ``device`` (a torch device name); raises when torch cannot
        use it on this host."""
        name = str(resolve_device(device))
        if name != self.device:
            # built on the old device and has no set_device: rebuilt on use
            self.models_bank.pop("speaker_encoder", None)
        self.device = name
        for m in self.models_bank.values():
            if hasattr(m, "set_device"):
                m.set_device(name)

    def drop(self, key: str):
        self.models_bank.pop(key.lower(), None)
