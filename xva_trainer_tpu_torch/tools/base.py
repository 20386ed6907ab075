"""Tool base class — the reference's L4b duck-type (SURVEY.md §2.5).

Counterpart of ``xva_trainer_tpu/tools/base.py``. Every tool implements
``__init__(logger, PROD, device, models_manager)``, ``async runTask(data,
websocket)``, ``set_device``, ``isReady`` (e.g. reference
python/audio_format/model.py:25-47) and reports progress via websocket
``task_info`` events plus a ``.progress.txt`` file that the UI polls
(javascript/tools.js:513-515). Completion emits ``tasks_next``; failures
emit ``tasks_error``.

The device a tool is given is a torch device, resolved by
``resolve_device``: ``cuda`` unless the caller says ``cpu``, and an error on
a host without a card. Host work (numpy and scipy, which release the GIL in
their C loops) fans out over a thread pool (``run_items``); the speaker
tools run their encoder on the tool's own thread.
"""
from __future__ import annotations

import asyncio
import json
import os
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

from .. import resolve_device


class BaseTool:
    def __init__(self, logger=None, PROD=False, device="cuda", models_manager=None):
        self.logger = logger
        self.PROD = PROD
        self.device = resolve_device(device)
        self.models_manager = models_manager
        self.ckpt_path = None
        self.model = None

    # -- duck-type surface --

    def load_state_dict(self, ckpt_path, ckpt, n_speakers=1, base_lang=None):
        self.ckpt_path = ckpt_path

    def set_device(self, device):
        self.device = resolve_device(device)

    def isReady(self):
        return True

    # -- helpers --

    async def send(self, websocket, key: str, data: Optional[str] = None):
        if websocket is not None:
            await websocket.send(json.dumps({"key": key, "data": data or ""}))

    async def task_info(self, websocket, message: str):
        await self.send(websocket, "task_info", message)

    async def done(self, websocket):
        await self.send(websocket, "tasks_next")

    async def error(self, websocket, message: str):
        if self.logger:
            self.logger.error(message)
        await self.send(websocket, "tasks_error", message)

    def write_progress(self, out_dir: str, done: int, total: int):
        try:
            with open(os.path.join(out_dir, ".progress.txt"), "w") as f:
                f.write(f"{done}/{total}")
        except OSError:
            pass

    async def run_items(
        self, items: List[Any], worker, websocket=None, out_dir: str = ".",
        max_workers: Optional[int] = None,
    ) -> List[Any]:
        """Fan items over a thread pool with progress reporting."""
        max_workers = max_workers or max(1, (os.cpu_count() or 2) // 2)
        results = []
        loop = asyncio.get_running_loop()
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            futures = [loop.run_in_executor(pool, worker, it) for it in items]
            for i, fut in enumerate(asyncio.as_completed(futures)):
                results.append(await fut)
                self.write_progress(out_dir, i + 1, len(items))
        return results

    async def runTask(self, data: Dict, websocket=None):
        try:
            return await self.run(data, websocket)
        except Exception:
            await self.error(websocket, traceback.format_exc())

    async def run(self, data: Dict, websocket=None):  # override
        raise NotImplementedError
